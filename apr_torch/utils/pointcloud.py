"""Point-cloud utilities: overlap ratios, ground-truth matching indices and
feature-match evaluation (port of ``apr_tpu/utils/pointcloud.py``).

The reference searches with scipy's cKDTree on the host.  The port
searches on the card that ``device`` names (the functions default to
``"cuda"`` and raise without a card unless asked for the CPU):

- 1-NN of 3-D points within a bound (:class:`NearestSearch`) is one launch
  of kernel K2 (:func:`apr_torch.ops.distance.nn_min`) over float32 copies
  of the clouds; the picked pair's distance is then taken again in
  float64, as cKDTree takes it (``(dx*dx + dy*dy) + dz*dz`` of the float64
  query and the target cast to float64), and the bound applies to it
  strictly (cKDTree's ``distance_upper_bound``): a query at or beyond it
  gets (inf, len(target)).
- The ball query of :func:`get_matching_indices` and the feature-space NN
  of :func:`evaluate_feature_match` are exact float64 searches over chunks
  of queries.

Where the float32 search picks another support than the float64 nearest
(a near tie), the result differs from the reference's; no other step does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from apr_torch.device import resolve_device
from apr_torch.ops.distance import nn_min

# float64 elements of a [chunk, Ns(, C)] block held at once (128 MiB)
_BLOCK_ELEMS = 1 << 24


def apply_transform_np(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    return points @ transform[:3, :3].T + transform[:3, 3]


class NearestSearch:
    """cKDTree's ``query(x, k=1, distance_upper_bound=...)`` against one
    target cloud [Ns, 3], through kernel K2 on ``device``.  The target
    stays as given on the host (its float64 cast is what the distances
    use) and is copied to the device once, as float32."""

    def __init__(self, target: np.ndarray, device="cuda"):
        self.target = np.asarray(target)
        self.device = resolve_device(device)
        self.support = torch.from_numpy(np.ascontiguousarray(
            self.target, dtype=np.float32).reshape(1, -1, 3)).to(self.device)

    def query(self, queries: np.ndarray, distance_upper_bound: float = np.inf
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(distance float64 [Nq], index int64 [Nq]) of each query's nearest
        target point, (inf, len(target)) where none lies strictly within
        ``distance_upper_bound``."""
        q64 = np.asarray(queries, np.float64)
        n = len(self.target)
        q = torch.from_numpy(np.ascontiguousarray(
            q64, dtype=np.float32).reshape(1, -1, 3)).to(self.device)
        _, idx = nn_min(q, self.support)
        idx = idx[0].cpu().numpy().astype(np.int64)
        found = idx < n
        t64 = self.target[np.where(found, idx, 0)].astype(np.float64) \
            if n else np.zeros_like(q64)
        dx, dy, dz = (q64[:, c] - t64[:, c] for c in range(3))
        d2 = dx * dx + dy * dy + dz * dz
        ok = found & (d2 < distance_upper_bound * distance_upper_bound)
        return np.where(ok, np.sqrt(d2), np.inf), np.where(ok, idx, n)


def _chunks(n_queries: int, per_query: int):
    step = max(1, _BLOCK_ELEMS // max(per_query, 1))
    for q0 in range(0, n_queries, step):
        yield q0, min(q0 + step, n_queries)


def get_matching_indices(
    source: np.ndarray,
    target: np.ndarray,
    trans: np.ndarray,
    search_voxel_size: float,
    k: Optional[int] = None,
    device="cuda",
) -> np.ndarray:
    """All (i, j) with ||T s_i - t_j|| <= search_voxel_size (cKDTree's
    ``query_ball_point``), as int64 [M, 2] rows sorted by (i, j).  With
    ``k``, each source point keeps its ``k`` lowest target indices: the
    reference keeps the first ``k`` of the tree's order, which no other
    search reproduces."""
    dev = resolve_device(device)
    warped = torch.from_numpy(np.asarray(
        apply_transform_np(source, trans), np.float64)).to(dev)
    tgt = torch.from_numpy(np.asarray(target, np.float64)).to(dev)
    r2 = float(search_voxel_size) * float(search_voxel_size)
    parts = []
    for q0, q1 in _chunks(len(warped), len(tgt)):
        d = [warped[q0:q1, None, c] - tgt[None, :, c] for c in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        hit = torch.nonzero(d2 <= r2)
        parts.append(torch.stack([hit[:, 0] + q0, hit[:, 1]], 1))
    pairs = (torch.cat(parts) if parts else
             torch.zeros((0, 2), dtype=torch.int64, device=dev))
    if k is not None and len(pairs):
        src = pairs[:, 0]
        start = torch.ones_like(src, dtype=torch.bool)
        start[1:] = src[1:] != src[:-1]
        first = torch.cummax(torch.where(
            start, torch.arange(len(src), device=dev), 0), 0).values
        pairs = pairs[torch.arange(len(src), device=dev) - first < k]
    return pairs.cpu().numpy().astype(np.int64).reshape(-1, 2)


def compute_overlap_ratio(
    pcd0: np.ndarray,
    pcd1: np.ndarray,
    trans: np.ndarray,
    voxel_size: float,
    device="cuda",
) -> float:
    """min of the two directed shares of points whose nearest neighbour in
    the other cloud lies within ``voxel_size`` after the warp (two K2
    launches)."""
    warped = apply_transform_np(pcd0, trans)
    d0, _ = NearestSearch(pcd1, device).query(warped, voxel_size)
    d1, _ = NearestSearch(warped, device).query(pcd1, voxel_size)
    return float(min(np.isfinite(d0).mean(), np.isfinite(d1).mean()))


def evaluate_feature_match(
    feats0: np.ndarray,
    feats1: np.ndarray,
    xyz0: np.ndarray,
    xyz1: np.ndarray,
    trans: np.ndarray,
    inlier_thresh: float = 0.1,
    device="cuda",
) -> Tuple[float, np.ndarray]:
    """Feature-NN hit ratio under the GT transform: the share of each
    point's feature-space nearest neighbour (float64, ties to the lowest
    index) that lies within ``inlier_thresh`` after warping, and the
    distances."""
    dev = resolve_device(device)
    f0 = torch.from_numpy(np.asarray(feats0, np.float64)).to(dev)
    f1 = torch.from_numpy(np.asarray(feats1, np.float64)).to(dev)
    nn = np.zeros(len(f0), np.int64)
    for q0, q1 in _chunks(len(f0), f1.shape[0] * f1.shape[1]):
        nn[q0:q1] = ((f0[q0:q1, None] - f1[None]) ** 2).sum(-1).argmin(
            1).cpu().numpy()
    warped = apply_transform_np(xyz0, trans)
    dist = np.linalg.norm(warped - xyz1[nn], axis=1)
    return float((dist < inlier_thresh).mean()), dist
