"""Correspondences: feature-space nearest neighbours (the eval path) and
ground-truth matches under the GT transform (the training batch), port of
``apr_tpu/registration/matching.py``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apr_torch.ops.chamfer import nn_distances


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
    _, idx = nn_distances(feats0, feats1, s_mask=mask1)
    return Correspondences(
        src_idx=torch.arange(n0, dtype=torch.int32, device=feats0.device),
        tgt_idx=idx,
        mask=mask0 & (idx < feats1.shape[0]),
    )


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
    transform [B, 4, 4] against xyz1 [B, N1, 3]; each source point keeps its
    nearest target within ``radius`` (``cap_per_point == 1``, the
    reference's nearest-within-radius branch, matching.py:132-158).
    Returns [B, N0] tables."""
    if cap_per_point != 1:
        raise NotImplementedError(
            "gt_correspondences with cap_per_point > 1 needs the radius "
            "search of ops/neighbors.py, which arrives with slice 3")
    from apr_torch.ops.chamfer_window import windowed_nn_distances

    b, n0 = xyz0.shape[:2]
    n1 = xyz1.shape[1]
    if mask0 is None:
        mask0 = torch.ones((b, n0), dtype=torch.bool, device=xyz0.device)
    warped = xyz0 @ transform[:, :3, :3].transpose(1, 2) \
        + transform[:, None, :3, 3]
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
