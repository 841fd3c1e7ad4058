# Frozen copy of apr_torch/ops/hashing.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
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


# --- Morton (interleaved-bit) packing -------------------------------------
#
# Halving every coordinate is one ``key >> 3`` on a Morton key, which keeps
# the sorted order, so a voxel pyramid reuses ONE sort for all its levels
# (ops/voxelize.py::voxelize_pyramid).  10 bits per axis: keys < 2^30.

def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to every 3rd bit position."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact3(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_spread3`."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & (COORD_RANGE - 1)
    return v


def morton_pack(coords: torch.Tensor) -> torch.Tensor:
    """Interleaved-bit int32 keys [...] of integer coords [..., 3], clipped
    to [-512, 511] like :func:`pack_coords`; ``morton_pack(c) >> 3 ==
    morton_pack(c >> 1)`` for in-range c."""
    c = torch.clamp(coords.to(torch.int32) + _OFFSET, 0, COORD_RANGE - 1)
    return ((_spread3(c[..., 0]) << 2) | (_spread3(c[..., 1]) << 1)
            | _spread3(c[..., 2]))


def morton_unpack(keys: torch.Tensor, level: int = 0) -> torch.Tensor:
    """Inverse of :func:`morton_pack`; keys ``morton_pack(c) >> 3*level``
    decode to the level's coords ``c >> level``."""
    x = _compact3(keys >> 2)
    y = _compact3(keys >> 1)
    z = _compact3(keys)
    return torch.stack([x, y, z], dim=-1).to(torch.int32) - (_OFFSET >> level)
