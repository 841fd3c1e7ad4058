"""Feature-space nearest-neighbour correspondences (port of
``apr_tpu/registration/matching.py``: the eval path)."""

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
