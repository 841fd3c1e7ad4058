"""Nearest-neighbour distances as a blockwise running min (port of
``apr_tpu/ops/chamfer.py::nn_distances``; the Chamfer loss and its
backward come with training)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def nn_distances(
    queries: torch.Tensor,
    supports: torch.Tensor,
    s_mask: Optional[torch.Tensor] = None,
    block: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query squared distance and index of the nearest masked-valid
    support: (sqdist float32 [Nq], idx int32 [Nq]).  Supports stream through
    in blocks with a running (min, argmin); ties go to the lowest index and
    a query with no valid support gets (inf, Ns).

    dim <= 4 sums exact per-coordinate differences (the matmul expansion
    cancels at LiDAR coordinate magnitudes); higher dims use
    |q|^2 - 2 q.s + |s|^2 with a float32 matmul, which needs TF32 off.
    """
    nq = queries.shape[0]
    ns, dim = supports.shape
    if s_mask is None:
        s_mask = torch.ones(ns, dtype=torch.bool, device=supports.device)
    best_d2 = torch.full((nq,), float("inf"), dtype=queries.dtype,
                         device=queries.device)
    best_i = torch.full((nq,), ns, dtype=torch.int32, device=queries.device)
    qq = (queries * queries).sum(dim=-1)
    for base in range(0, ns, block):
        s = supports[base:base + block]
        if dim <= 4:
            d2 = torch.zeros((nq, s.shape[0]), dtype=queries.dtype,
                             device=queries.device)
            for c in range(dim):
                dc = queries[:, c:c + 1] - s[None, :, c]
                d2 = d2 + dc * dc
        else:
            d2 = qq[:, None] - 2.0 * (queries @ s.T) + (s * s).sum(-1)[None]
            d2 = torch.clamp(d2, min=0.0)
        d2 = torch.where(s_mask[None, base:base + block], d2, float("inf"))
        blk_best, blk_arg = torch.min(d2, dim=1)
        take = blk_best < best_d2
        best_d2 = torch.where(take, blk_best, best_d2)
        best_i = torch.where(take, blk_arg.to(torch.int32) + base, best_i)
    return best_d2, best_i
