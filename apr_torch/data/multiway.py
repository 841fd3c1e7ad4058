"""Multiway registration of complement frames, the APG odometry-pose path
(port of ``apr_tpu/data/multiway.py``, the reference's full_registration /
multiway_registration): per side, a pose graph over [key frame + K
complements] (odometry-chain edges certain, every other pair an uncertain
loop closure) with pairwise ICP from the velo2cam-chained odometry poses,
then Levenberg-Marquardt; the result is each complement's transform into
the key frame.  ``python -m apr_torch.tools.prepare_icp_cache`` writes
them into the reference's cache layout ``{icp_path}/{drive}_{t_cmpl}_
{t_key}.npy``.

The ICP searches and the voxel dedup run on the card that ``device``
names; the pose graph is host float64 math (:mod:`apr_torch.geometry.
pose_graph`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from apr_torch.device import resolve_device
from apr_torch.geometry.icp import information_matrix, registration_icp
from apr_torch.geometry.pose_graph import (
    PoseGraph,
    PoseGraphEdge,
    PoseGraphNode,
    global_optimization,
)


def _voxel_dedup(points: np.ndarray, voxel: float,
                 device="cuda") -> np.ndarray:
    """The first point of each occupied voxel, in file order
    (ME.sparse_quantize's selection).  ``points / voxel`` is a true
    division in the points' dtype (float32 frames stay float32), as numpy
    computes it: a division by a tensor, since torch multiplies by the
    reciprocal of a scalar divisor on the card."""
    if len(points) == 0:
        return points[:0]
    p = torch.from_numpy(np.ascontiguousarray(points)).to(
        resolve_device(device))
    coords = torch.floor(p / torch.full_like(p, voxel)).long()
    _, inverse = torch.unique(coords, dim=0, return_inverse=True)
    n = len(points)
    first = torch.full((int(inverse.max()) + 1,), n, dtype=torch.int64,
                       device=p.device)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=p.device),
                          "amin")
    return points[torch.sort(first).values.cpu().numpy()]


def pairwise_registration(
    source: np.ndarray,
    target: np.ndarray,
    init: np.ndarray,
    max_corr_fine: float = 0.2,
    device="cuda",
):
    """ICP source->target from the odometry init; returns (T, info 6x6)."""
    reg = registration_icp(source, target, max_corr_fine, init,
                           max_iteration=200, device=device)
    info = information_matrix(source, target, max_corr_fine,
                              reg.transformation, device=device)
    return reg.transformation, info


def full_registration(
    clouds: Sequence[np.ndarray],
    init_transforms: Sequence[np.ndarray],
    max_corr_fine: float = 0.2,
    device="cuda",
) -> List[np.ndarray]:
    """Pose-graph optimize one side; clouds[0] is the key frame.

    ``init_transforms[i]`` maps cloud i into the key frame (odometry-derived
    initialization).  Returns node poses (cloud i -> key frame), node 0 = I.
    """
    n = len(clouds)
    graph = PoseGraph(nodes=[PoseGraphNode(init_transforms[i].copy())
                             for i in range(n)])
    for s in range(n):
        for t in range(s + 1, n):
            init = np.linalg.inv(init_transforms[t]) @ init_transforms[s]
            t_icp, info = pairwise_registration(
                clouds[s], clouds[t], init, max_corr_fine, device
            )
            graph.edges.append(
                PoseGraphEdge(s, t, t_icp, info, uncertain=(t != s + 1))
            )
    graph = global_optimization(graph, reference_node=0)
    # express every node relative to the key frame (node 0)
    inv0 = np.linalg.inv(graph.nodes[0].pose)
    return [inv0 @ graph.nodes[i].pose for i in range(n)]


def multiway_complement_transforms(
    xyz_key: np.ndarray,
    xyz_cmpls: Sequence[np.ndarray],
    init_transforms: Sequence[np.ndarray],
    num_one_side: int,
    icp_voxel_size: float = 0.05,
    max_corr_fine: float = 0.2,
    device="cuda",
) -> List[np.ndarray]:
    """One transform per complement frame into the key frame, the left and
    right sides optimized separately.  ``init_transforms[i]`` is the
    odometry-based initial guess for complement i (same order: K left then
    K right)."""
    key_ds = _voxel_dedup(xyz_key, icp_voxel_size, device)
    cmpl_ds = [_voxel_dedup(x, icp_voxel_size, device) for x in xyz_cmpls]

    left = [key_ds] + list(cmpl_ds[:num_one_side])
    right = [key_ds] + list(cmpl_ds[num_one_side:])
    init_left = [np.eye(4)] + list(init_transforms[:num_one_side])
    init_right = [np.eye(4)] + list(init_transforms[num_one_side:])

    out_left = full_registration(left, init_left, max_corr_fine, device)[1:]
    out_right = full_registration(right, init_right, max_corr_fine,
                                  device)[1:]
    return out_left + out_right
