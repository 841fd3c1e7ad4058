# Frozen copy of apr_torch/ops/chamfer.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Nearest-neighbour distances as a blockwise running min, and the exact
Chamfer loss (port of ``apr_tpu/ops/chamfer.py``).

    chamfer(a, b) = mean_i min_j ||a_i - b_j||^2 + mean_j min_i ||a_i - b_j||^2

over masked-valid points, per cloud of a leading batch.  The gradient
re-gathers the argmin support instead of saving distance tiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from reference.aprref.ops.distance import directed_backward, masked_mean, \
    nn_min_plain


def nn_distances(
    queries: torch.Tensor,
    supports: torch.Tensor,
    s_mask: Optional[torch.Tensor] = None,
    block: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query squared distance and index of the nearest masked-valid
    support of one cloud: (sqdist float32 [Nq], idx int32 [Nq]); the
    one-cloud form of :func:`reference.aprref.ops.distance.nn_min_plain`."""
    d2, idx = nn_min_plain(queries[None], supports[None],
                           None if s_mask is None else s_mask[None], block)
    return d2[0], idx[0]


class DirectedMeanSqNN(torch.autograd.Function):
    """Per cloud, the masked mean over queries of the squared distance to
    the nearest valid support (plain torch ops, no kernel: the reference's
    XLA path).  The backward masks with ``q_mask`` only, as
    ``_directed_bwd`` does (chamfer.py:131)."""

    @staticmethod
    def forward(ctx, queries, supports, q_mask, s_mask):
        d2, idx = nn_min_plain(queries, supports, s_mask)
        val, nq = masked_mean(d2, q_mask)
        ctx.save_for_backward(queries, supports, q_mask, idx, nq)
        return val

    @staticmethod
    def backward(ctx, g):
        queries, supports, q_mask, idx, nq = ctx.saved_tensors
        dq, ds = directed_backward(queries, supports, q_mask, idx, nq, g)
        return dq, ds, None, None


def chamfer_distance(a: torch.Tensor, b: torch.Tensor,
                     a_mask: Optional[torch.Tensor] = None,
                     b_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] bidirectional Chamfer per cloud of a [B, Na, 3], b [B, Nb, 3],
    with the reference trainers' normalization."""
    if a_mask is None:
        a_mask = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    if b_mask is None:
        b_mask = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
    return (DirectedMeanSqNN.apply(a, b, a_mask, b_mask)
            + DirectedMeanSqNN.apply(b, a, b_mask, a_mask))
