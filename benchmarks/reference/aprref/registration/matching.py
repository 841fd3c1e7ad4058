# Frozen copy of apr_torch/registration/matching.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Correspondences: feature-space nearest neighbours (the eval path, mutual
or not), ground-truth matches under the GT transform (the training batch)
and the matching + robust-pose convenience, port of
``apr_tpu/registration/matching.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.aprref import tally
from reference.aprref.ops.chamfer import nn_distances


class Correspondences(NamedTuple):
    """Sentinel-padded correspondence set between two clouds."""

    src_idx: torch.Tensor  # int32 [M]
    tgt_idx: torch.Tensor  # int32 [M]
    mask: torch.Tensor     # bool  [M]


def feature_nn_correspondences(
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Correspondences:
    """One correspondence per source point: its feature-space NN in cloud 1."""
    n0 = feats0.shape[0]
    if mask0 is None:
        mask0 = torch.ones(n0, dtype=torch.bool, device=feats0.device)
    # a multiply-add per channel for each valid (source, target) pair
    tally.add("fwd_flops", 2 * feats0.shape[1] * mask0.sum() * (
        feats1.shape[0] if mask1 is None else mask1.sum()))
    _, idx = nn_distances(feats0, feats1, s_mask=mask1)
    return Correspondences(
        src_idx=torch.arange(n0, dtype=torch.int32, device=feats0.device),
        tgt_idx=idx,
        mask=mask0 & (idx < feats1.shape[0]),
    )


def mutual_nn_correspondences(
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Correspondences:
    """Keep only pairs that are each other's feature-space NN."""
    n0 = feats0.shape[0]
    if mask0 is None:
        mask0 = torch.ones(n0, dtype=torch.bool, device=feats0.device)
    _, idx01 = nn_distances(feats0, feats1, s_mask=mask1)
    _, idx10 = nn_distances(feats1, feats0, s_mask=mask0)
    back = idx10[idx01.clamp(0, feats1.shape[0] - 1).long()]
    mutual = back == torch.arange(n0, device=feats0.device)
    return Correspondences(
        src_idx=torch.arange(n0, dtype=torch.int32, device=feats0.device),
        tgt_idx=idx01,
        mask=mask0 & mutual & (idx01 < feats1.shape[0]),
    )


def find_nn(
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    mask1: Optional[torch.Tensor] = None,
):
    """Nearest neighbour in feature space: (idx int32 [N0], sqdist [N0])."""
    d2, idx = nn_distances(feats0, feats1, s_mask=mask1)
    return idx, d2


def pose_estimation(
    xyz0: torch.Tensor,
    xyz1: torch.Tensor,
    feats0: torch.Tensor,
    feats1: torch.Tensor,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
):
    """Feature matching weighted by the matched pair's feature inner
    product, refined by the robust IRLS pose
    (:func:`reference.aprref.geometry.robust.est_rigid_robust`).  Returns
    (transform [4, 4], weights [N0])."""
    from reference.aprref.geometry.robust import est_rigid_robust

    n1 = feats1.shape[0]
    corr = feature_nn_correspondences(feats0, feats1, mask0, mask1)
    tgt = corr.tgt_idx.clamp(0, n1 - 1).long()
    weight = (feats0 * feats1[tgt]).sum(dim=1) * corr.mask
    return est_rigid_robust(xyz0, xyz1[tgt], weight), weight


def gt_correspondences(
    xyz0: torch.Tensor,
    xyz1: torch.Tensor,
    transform: torch.Tensor,
    radius: float,
    cap_per_point: int = 1,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> Correspondences:
    """Ground-truth matches per pair of a batch: xyz0 [B, N0, 3] warped by
    transform [B, 4, 4] against xyz1 [B, N1, 3].

    ``cap_per_point == 1``: each source point keeps its nearest target
    within ``radius`` (the windowed NN); [B, N0] tables.  Otherwise each
    source point keeps up to ``cap_per_point`` targets within ``radius``,
    distance-sorted (the exact radius search); [B, N0 * cap] tables, source
    i at rows i * cap ... i * cap + cap - 1.  Unmatched rows hold target 0
    and a False mask."""
    b, n0 = xyz0.shape[:2]
    n1 = xyz1.shape[1]
    if mask0 is None:
        mask0 = torch.ones((b, n0), dtype=torch.bool, device=xyz0.device)
    warped = xyz0 @ transform[:, :3, :3].transpose(1, 2) \
        + transform[:, None, :3, 3]
    if cap_per_point != 1:
        from reference.aprref.ops.neighbors import radius_neighbors

        tgt = radius_neighbors(warped, xyz1, radius, cap_per_point,
                               q_mask=mask0, s_mask=mask1).reshape(b, -1)
        valid = tgt < n1
        src = torch.arange(n0, dtype=torch.int32, device=xyz0.device)
        return Correspondences(
            src_idx=src.repeat_interleave(cap_per_point).expand(b, -1),
            tgt_idx=torch.where(valid, tgt, 0).to(torch.int32),
            mask=valid)
    from reference.aprref.ops.chamfer_window import windowed_nn_distances

    # the cell-key windowed NN is exact for every pair within
    # cell_size == radius; the window covers the densest voxelized slab
    d2, idx = windowed_nn_distances(
        warped, xyz1, mask0, mask1, cell_size=float(radius), tile=512,
        window=min(8192, max(512, n1)))
    valid = (idx < n1) & (d2 <= radius * radius) & mask0
    src = torch.arange(n0, dtype=torch.int32, device=xyz0.device)
    return Correspondences(
        src_idx=src.expand(b, n0),
        tgt_idx=torch.where(valid, idx, 0).to(torch.int32),
        mask=valid,
    )
