# Frozen copy of apr_torch/ops/pooling.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Segment pooling over sentinel-padded index tables (port of
``apr_tpu/ops/pooling.py``); every function takes stacked clouds
[P, N, F] with tables [P, Nq, K] whose sentinel is N.

Every gather whose backward sums rows goes through :func:`gather_rows`:
the backward sorts the indices once (stably) and adds each source row's
contributions in their original order with ``segment_reduce``.  No float
``scatter_add_`` / ``index_add_`` / accumulating index runs on the card,
where they add in whatever order the threads land and two runs of one
train step would differ in the last bits.
"""

from __future__ import annotations

import torch


def flat_segments(ids: torch.Tensor, num: int) -> torch.Tensor:
    """Per-cloud ids [P, ...] in [0, num] (``num`` the sentinel) as ids
    over all P * num segments: cloud p's id i is p * num + i, and every
    sentinel is P * num."""
    p = ids.shape[0]
    ids = torch.clamp(ids, max=num).long()
    offs = torch.arange(p, device=ids.device).reshape(
        (p,) + (1,) * (ids.dim() - 1)) * num
    return torch.where(ids < num, ids + offs, p * num)


def sorted_row_sums(values: torch.Tensor, idx: torch.Tensor, m: int):
    """(sums [m, ...], counts [m] int64): sum r adds the ``values``
    [L, ...] whose ``idx`` [L] is r, in order of L, and count r is their
    number; indices >= m (the sentinel) are dropped.  One stable sort, an
    integer count and one ``segment_reduce``: no float atomics."""
    idx = idx.reshape(-1).long().clamp(max=m)
    order = torch.argsort(idx, stable=True)
    counts = torch.zeros(m + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:m], 0)])
    # the offsets end where the sentinel run starts: it is never summed
    sums = torch.segment_reduce(
        values.reshape((idx.shape[0],) + values.shape[1:])[order], "sum",
        offsets=offsets, axis=0, unsafe=True)
    return sums, counts[:m]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        m = src.shape[0]
        ctx.save_for_backward(idx)
        ctx.m = m
        padded = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
        flat = idx.reshape(-1).long().clamp(max=m)
        return padded.index_select(0, flat).reshape(idx.shape
                                                    + src.shape[1:])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return sorted_row_sums(g.reshape((-1,) + g.shape[idx.dim():]),
                               idx, ctx.m)[0], None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` for src [M, ...] and an index tensor of any shape whose
    entries >= M (the sentinel) yield a zero row; the backward sums each
    row's duplicates in index order after one stable sort (no atomics)."""
    return _GatherRows.apply(src, idx)


def segment_mean_capped(values: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Mean of values [P, N, F] per segment; ids == num_segments are
    dropped (the barycenter pooling of grid subsampling).  Each segment's
    values add in index order (a stable sort by id, then
    :func:`sorted_row_sums`), so the card and the CPU give the same
    bits."""
    p, n = segment_ids.shape
    s, c = sorted_row_sums(values.reshape(p * n, -1),
                           flat_segments(segment_ids, num_segments),
                           p * num_segments)
    return s.reshape((p, num_segments) + values.shape[2:]) / torch.clamp(
        c, min=1).reshape((p, num_segments) + (1,) * (values.dim() - 2))


def _padded_rows(feats: torch.Tensor, neighbor_idx: torch.Tensor):
    """Rows of feats [P, N, F] (the sentinel N a zero row) gathered by
    neighbor_idx [P, Nq, K] -> [P, Nq, K, F]."""
    p, n, f = feats.shape
    return gather_rows(feats.reshape(p * n, f),
                       flat_segments(neighbor_idx, n))


def gather_neighbors(feats: torch.Tensor,
                     neighbor_idx: torch.Tensor) -> torch.Tensor:
    """[P, Nq, K, F] features by a sentinel-padded table; the sentinel
    yields a zero row (the reference's shadow point)."""
    return _padded_rows(feats, neighbor_idx)


def max_pool_neighbors(feats: torch.Tensor,
                       neighbor_idx: torch.Tensor) -> torch.Tensor:
    """Max over each row's neighbours [P, Nq, F]; a shadow neighbour
    contributes a ZERO row, so the max is floored at 0 wherever a row has
    one (the reference's ``max_pool`` pads with zeros; kept for checkpoint
    fidelity)."""
    return _padded_rows(feats, neighbor_idx).amax(dim=2)
