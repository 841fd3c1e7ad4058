"""Bitonic sorting network from plain tensor ops (the counterpart of
``apr_tpu/ops/sort.py``).

A bitonic network is data-oblivious: log2(N)*(log2(N)+1)/2 compare-exchange
stages of ``reshape / where`` that vectorise across any leading batch dims.
The comparisons are the reference's strict ones (``a > b`` in an ascending
block, ``a < b`` in a descending one), so a carried payload comes out in the
reference's permutation even under ties.  Not stable.

Keys are any dtype whose ``<`` is the sort order (packed voxel keys;
INVALID_KEY = int32 max sorts to the tail); the sorted axis length must be
a power of two.  On the card each stage is a handful of eager launches:
``tools/profile_sort.py`` times it against ``torch.sort``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch


def _stages(n: int) -> Iterator[Tuple[int, int]]:
    size = 2
    while size <= n:
        d = size // 2
        while d >= 1:
            yield size, d
            d //= 2
        size *= 2


def _exchange(x: torch.Tensor, swap: torch.Tensor, rows: int, d: int
              ) -> torch.Tensor:
    x2 = x.reshape(*x.shape[:-1], rows, 2, d)
    a, b = x2[..., 0, :], x2[..., 1, :]
    return torch.stack((torch.where(swap, b, a), torch.where(swap, a, b)),
                       dim=-2).reshape(x.shape)


def bitonic_sort(keys: torch.Tensor, values: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort ``keys`` ascending along the LAST axis; optionally carry one
    payload tensor of identical shape through the same permutation.

    Returns (sorted_keys, permuted_values_or_None)."""
    n = keys.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic length must be a power of 2, got {n}")
    if values is not None and values.shape != keys.shape:
        raise ValueError(f"payload shape {tuple(values.shape)} != keys "
                         f"shape {tuple(keys.shape)}")
    for size, d in _stages(n):
        rows = n // (2 * d)
        k2 = keys.reshape(*keys.shape[:-1], rows, 2, d)
        a, b = k2[..., 0, :], k2[..., 1, :]
        # element index i = row*2d + s*d + t; the direction tests bit
        # ``size`` of i, which neither s*d (< 2d <= size) nor t (< d) sets
        base = torch.arange(rows, device=keys.device) * (2 * d)
        asc = ((base & size) == 0)[:, None]                 # [rows, 1]
        swap = torch.where(asc, a > b, a < b)               # [..., rows, d]
        keys = _exchange(keys, swap, rows, d)
        if values is not None:
            values = _exchange(values, swap, rows, d)
    return keys, values


def bitonic_argsort(keys: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted_keys, order) such that ``keys[..., order] == sorted_keys``;
    ``order`` is int32, as the reference's."""
    idx = torch.arange(keys.shape[-1], dtype=torch.int32,
                       device=keys.device).expand(keys.shape)
    return bitonic_sort(keys, idx)
