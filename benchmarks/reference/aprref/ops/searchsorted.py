# Frozen copy of apr_torch/ops/searchsorted.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Batched searchsorted-left for the kernel-map builds (kernel K1).

``searchsorted_left(support [B, S], queries [B, G, C]) -> [B, G, C]`` is
the port of ``apr_tpu/ops/pallas/searchsorted.py::searchsorted_left``,
batched over clouds so one launch serves a kernel map of every cloud of a
batch.  Contract: each support row ascending with INVALID_KEY padding at
its tail; within each query row the entries that are not INVALID_KEY
ascend (holes anywhere are fine).  The result equals
``searchsorted(support[b], queries[b], side='left')``; an INVALID query
gets the count of valid supports.

``searchsorted_left_many`` runs several such searches over the same
clouds, the seven kernel maps of a pyramid build, in one launch.

The frozen reference runs :func:`searchsorted_left_plain`, the same
function in plain torch ops, on every device (the port launches its CUDA
kernel on a card), and adds each grouped search's bytes (supports and
queries read once, results written once, int32) to ``tally``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from reference.aprref import tally


def searchsorted_left_plain(support: torch.Tensor,
                            queries: torch.Tensor) -> torch.Tensor:
    """Vectorised binary search: ceil(log2(S + 1)) steps over all queries
    at once.  The CPU path of :func:`searchsorted_left`, and the version the
    kernel is held against on the card."""
    b, s = support.shape
    g, c = queries.shape[1:]
    q = queries.reshape(b, g * c)
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, s)
    for _ in range(s.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = torch.gather(support, 1, mid.clamp(max=s - 1)) < q
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo.to(torch.int32).reshape(b, g, c)


def _check(support: torch.Tensor, queries: torch.Tensor) -> None:
    if support.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError(f"searchsorted_left takes int32 keys, got "
                        f"{support.dtype} and {queries.dtype}")
    if (support.dim() != 2 or queries.dim() != 3
            or support.shape[0] != queries.shape[0]):
        raise ValueError(f"want support [B, S] and queries [B, G, C], got "
                         f"{tuple(support.shape)} and {tuple(queries.shape)}")
    if support.device != queries.device:
        raise ValueError(f"support on {support.device}, queries on "
                         f"{queries.device}")


def searchsorted_left_many(searches: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor]]
                           ) -> List[torch.Tensor]:
    """Several searches (support [B, S_i], queries [B, G_i, C_i]) over the
    same B clouds in one launch (one per MAX_SEARCHES); their results in
    order.  On the CPU, the list of :func:`searchsorted_left_plain` calls."""
    searches = list(searches)
    for support, queries in searches:
        _check(support, queries)
    if not searches:
        return []
    dev, b = searches[0][0].device, searches[0][0].shape[0]
    if any(s.device != dev or s.shape[0] != b for s, _ in searches):
        raise ValueError("searchsorted_left_many takes searches over the "
                         "same clouds on one device")
    # the reference runs the plain version on every device
    tally.add("k1_bytes", sum(4 * (s.numel() + 2 * q.numel())
                              for s, q in searches))
    return [searchsorted_left_plain(s, q) for s, q in searches]


def searchsorted_left(support: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """Left insertion points of ``queries`` [B, G, C] in ``support`` [B, S]
    (int32); see the module docstring for the contract.  The grouped entry
    with one search."""
    return searchsorted_left_many([(support, queries)])[0]

