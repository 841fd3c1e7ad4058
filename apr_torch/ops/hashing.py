"""Collision-free packing of integer voxel coordinates into int32 keys.

Each axis gets ``COORD_BITS`` bits (values in [-512, 511] after offsetting;
out-of-range values are clipped), so packed keys are non-negative, fit an
int32 and sort in lexicographic (x, y, z) order.  ``INVALID_KEY`` (int32
max) sorts after every valid key; masked-out points map to it.  Same layout
as ``apr_tpu/ops/hashing.py``.
"""

from __future__ import annotations

import torch

COORD_BITS = 10
COORD_RANGE = 1 << COORD_BITS          # 1024 cells per axis
_OFFSET = COORD_RANGE // 2             # center the signed range
INVALID_KEY = 2**31 - 1


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """Pack integer coords [..., 3] into non-negative int32 keys [...]."""
    c = torch.clamp(coords.to(torch.int32) + _OFFSET, 0, COORD_RANGE - 1)
    return ((c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS)
            | c[..., 2])


def unpack_coords(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_coords`; keys [...] -> int32 coords [..., 3]."""
    mask = COORD_RANGE - 1
    x = (keys >> (2 * COORD_BITS)) & mask
    y = (keys >> COORD_BITS) & mask
    z = keys & mask
    return torch.stack([x, y, z], dim=-1).to(torch.int32) - _OFFSET
