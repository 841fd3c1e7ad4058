"""Fixed-capacity voxelization over a leading batch of clouds.

The port of ``apr_tpu/ops/voxelize.py::voxelize_lean`` and
``unique_of_sorted``.  Outputs have static shapes: voxels come in ascending
packed-key order, padding (and overflow beyond capacity, which drops the
largest keys) sits at the tail and is flagged by the mask.  ``rep`` is the
lowest original point index of each voxel (MinkowskiEngine
``sparse_quantize`` 'sel' parity).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apr_torch.ops.hashing import INVALID_KEY, pack_coords, unpack_coords


def voxel_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """``floor(points / voxel_size)`` as int32, computed as the reference's
    compiled build computes it: XLA folds a division by a constant into a
    multiplication by its float32 reciprocal, and a point within one ulp of
    a voxel face lands in the same voxel on both sides only if the port
    does the same."""
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    return torch.floor(points * inv).to(torch.int32)


def unique_of_sorted(sorted_keys: torch.Tensor, capacity: int):
    """Fixed-size unique of ALREADY-SORTED key rows [B, N].

    Rows must be non-decreasing with INVALID_KEY padding at the tail.
    Returns (uniq [B, capacity] ascending, INVALID-padded, the largest keys
    dropped on overflow; seg [B, N] int32 segment id per entry with sentinel
    ``capacity`` for padding and overflow entries).
    """
    b, n = sorted_keys.shape
    valid = sorted_keys != INVALID_KEY
    is_new = valid.clone()
    is_new[:, 1:] &= sorted_keys[:, 1:] != sorted_keys[:, :-1]
    seg = torch.cumsum(is_new.to(torch.int32), dim=1, dtype=torch.int32) - 1
    seg = torch.where(valid & (seg < capacity), seg, capacity)
    # segment-min into an INVALID-filled buffer: empty segments stay padding
    uniq = torch.full((b, capacity + 1), INVALID_KEY, dtype=torch.int32,
                      device=sorted_keys.device)
    uniq.scatter_reduce_(1, seg.long(),
                         torch.where(valid, sorted_keys, INVALID_KEY),
                         "amin", include_self=True)
    return uniq[:, :capacity].contiguous(), seg


def voxelize_lean(
    points: torch.Tensor,
    voxel_size: float,
    capacity: int,
    mask: Optional[torch.Tensor] = None,
):
    """Voxelize clouds ``points`` [B, N, 3] onto ``capacity`` voxels each.

    Returns ``(coords [B, C, 3] int32, keys [B, C] int32 ascending,
    vox_mask [B, C] bool, rep [B, C] int32)``; ``rep`` is ``N`` at padding.
    """
    b, n, _ = points.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    keys = torch.where(mask, pack_coords(voxel_coords(points, voxel_size)),
                       INVALID_KEY)
    k_sorted, idx_sorted = torch.sort(keys, dim=1, stable=True)
    uniq, seg = unique_of_sorted(k_sorted, capacity)
    vox_mask = uniq != INVALID_KEY
    found = seg < capacity
    rep = torch.full((b, capacity + 1), n, dtype=torch.int32,
                     device=points.device)
    rep.scatter_reduce_(1, seg.long(),
                        torch.where(found, idx_sorted.to(torch.int32), n),
                        "amin", include_self=True)
    rep = torch.where(vox_mask, rep[:, :capacity], n)
    coords = torch.where(vox_mask[..., None], unpack_coords(uniq), 0)
    return coords, uniq, vox_mask, rep


def dedup_points(points: torch.Tensor, voxel_size: float,
                 mask: Optional[torch.Tensor] = None):
    """One representative point per occupied voxel, in place of the input
    buffers [B, N, 3]: returns ``(points_out [B, N, 3], keep_mask [B, N])``
    where masked-out rows (duplicates and input padding) are zero.

    One stable sort by voxel key and a run-boundary test; rows land in
    ascending-key order with holes at the duplicates.  The representative
    is the lowest-original-index member of each voxel (ME sparse_quantize
    'sel').  Voxel keys use :func:`voxel_coords`, as the reference's
    compiled program computes them."""
    b, n, _ = points.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    keys = torch.where(mask, pack_coords(voxel_coords(points, voxel_size)),
                       INVALID_KEY)
    ks, order = torch.sort(keys, dim=1, stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, 3))
    is_first = ks != INVALID_KEY
    is_first[:, 1:] &= ks[:, 1:] != ks[:, :-1]
    return torch.where(is_first[..., None], pts, 0.0), is_first
