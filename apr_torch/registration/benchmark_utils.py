"""Benchmark utilities (port of ``apr_tpu/registration/benchmark_utils.py``,
the reference's Predator_APR/lib/benchmark_utils.py): the inlier ratio of
feature matches under the GT transform, feature-match-recall sweeps over
inlier-ratio thresholds and the mutual selection of a score matrix.  The
tensor functions run on their inputs' device (the feature NN through
:func:`apr_torch.ops.chamfer.nn_distances`)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from apr_torch.geometry.se3 import apply_transform
from apr_torch.ops.chamfer import nn_distances


def get_inlier_ratio(
    src_pcd: torch.Tensor,
    tgt_pcd: torch.Tensor,
    src_feat: torch.Tensor,
    tgt_feat: torch.Tensor,
    t_gt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    inlier_distance_threshold: float = 0.1,
) -> Dict[str, torch.Tensor]:
    """Share of feature-NN matches within the GT-inlier distance, in both
    directions and over the mutual subset."""
    n, m = src_pcd.shape[0], tgt_pcd.shape[0]
    dev = src_pcd.device
    if src_mask is None:
        src_mask = torch.ones(n, dtype=torch.bool, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones(m, dtype=torch.bool, device=dev)
    warped = apply_transform(src_pcd, t_gt)

    _, idx01 = nn_distances(src_feat, tgt_feat, s_mask=tgt_mask)
    _, idx10 = nn_distances(tgt_feat, src_feat, s_mask=src_mask)
    idx01c = idx01.clamp(0, m - 1).long()
    idx10c = idx10.clamp(0, n - 1).long()

    d01 = torch.linalg.vector_norm(warped - tgt_pcd[idx01c], dim=1)
    d10 = torch.linalg.vector_norm(tgt_pcd - warped[idx10c], dim=1)
    w0 = src_mask.float()
    w1 = tgt_mask.float()
    in0 = ((d01 < inlier_distance_threshold) * w0).sum() / torch.clamp(
        w0.sum(), min=1.0)
    in1 = ((d10 < inlier_distance_threshold) * w1).sum() / torch.clamp(
        w1.sum(), min=1.0)

    mutual = (idx10[idx01c] == torch.arange(n, device=dev)) & src_mask
    wm = mutual.float()
    in_mutual = ((d01 < inlier_distance_threshold) * wm).sum() / torch.clamp(
        wm.sum(), min=1.0)
    return dict(
        inlier_ratio_src=in0,
        inlier_ratio_tgt=in1,
        inlier_ratio=0.5 * (in0 + in1),
        inlier_ratio_mutual=in_mutual,
    )


def feature_match_recall_sweep(
    inlier_ratios: Sequence[float],
    ratio_thresholds: Sequence[float] = tuple(np.arange(0, 0.21, 0.01)),
) -> np.ndarray:
    """FMR as a function of the required inlier ratio: the share of pairs
    whose inlier ratio exceeds each threshold."""
    arr = np.asarray(inlier_ratios)[None, :]
    th = np.asarray(ratio_thresholds)[:, None]
    return (arr > th).mean(axis=1)


def mutual_selection(score_mat: torch.Tensor) -> torch.Tensor:
    """Boolean [N, M] mask of the entries that are the maximum of both
    their row and their column."""
    row_max = score_mat == score_mat.max(dim=1, keepdim=True).values
    col_max = score_mat == score_mat.max(dim=0, keepdim=True).values
    return row_max & col_max
