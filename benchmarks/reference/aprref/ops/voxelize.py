# Frozen copy of apr_torch/ops/voxelize.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Fixed-capacity voxelization over a leading batch of clouds.

The port of ``apr_tpu/ops/voxelize.py`` (``voxelize``, ``voxelize_lean``,
``voxelize_pyramid``, ``dedup_points``, ``unique_of_sorted``,
``voxel_down_sample``, ``grid_subsample``).  Outputs
have static shapes: voxels come in ascending key order, padding (and
overflow beyond capacity, which drops the largest keys) sits at the tail
and is flagged by the mask.  ``rep`` is the lowest original point index of
each voxel (MinkowskiEngine ``sparse_quantize`` 'sel' parity).  Points
are sorted stably by voxel key, so each voxel's points are one contiguous
run in original index order; a barycenter sums its run from first to last,
the order of the reference's segment sum, so the card, the CPU and the
reference give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from reference.aprref.ops.pooling import flat_segments, sorted_row_sums
from reference.aprref.ops.hashing import INVALID_KEY, morton_pack, morton_unpack, \
    pack_coords, unpack_coords


class VoxelGrid(NamedTuple):
    """Voxelized clouds with static capacity C over N input points each
    (every field has a leading batch dim B).

    coords int32 [B, C, 3]; keys int32 [B, C] ascending, INVALID at padding;
    mask bool [B, C]; point_voxel int32 [B, N] voxel of each point (C for
    masked or overflowed points); counts int32 [B, C]; barycenter float32
    [B, C, 3] (0 at padding); rep int32 [B, C] lowest member index (N at
    padding).
    """

    coords: torch.Tensor
    keys: torch.Tensor
    mask: torch.Tensor
    point_voxel: torch.Tensor
    counts: torch.Tensor
    barycenter: torch.Tensor
    rep: torch.Tensor


def _run_sums(values: torch.Tensor, seg: torch.Tensor, num: int):
    """Sums of values [B, N, D] per id of seg [B, N] in [0, num], each id's
    entries added in order along the row, the sentinel ``num`` dropped:
    (sums [B, num, D], counts [B, num] int32), the same bits on every
    device (:func:`reference.aprref.ops.pooling.sorted_row_sums`)."""
    b, n = seg.shape
    sums, counts = sorted_row_sums(values.reshape(b * n, -1),
                                   flat_segments(seg, num), b * num)
    return (sums.reshape(b, num, -1),
            counts.reshape(b, num).to(torch.int32))


def _segment_min(values: torch.Tensor, seg: torch.Tensor, num: int,
                 fill: int) -> torch.Tensor:
    out = torch.full((values.shape[0], num + 1), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(1, seg.long(), values, "amin", include_self=True)
    return out[:, :num]


def _grid_of_sorted(k_sorted, order, p_sorted, cap: int, unpack):
    """The :class:`VoxelGrid` of key rows sorted stably (``order`` the
    original index of each sorted entry, p_sorted its point) on ``cap``
    voxels; ``unpack`` turns the voxel keys into coordinates."""
    b, n = k_sorted.shape
    uniq, seg = unique_of_sorted(k_sorted, cap)
    vox_mask = uniq != INVALID_KEY
    found = seg < cap
    psum, counts = _run_sums(p_sorted, seg, cap)
    barycenter = psum / torch.clamp(counts, min=1)[..., None]
    rep = torch.where(vox_mask, _segment_min(
        torch.where(found, order.to(torch.int32), n), seg, cap, n), n)
    point_voxel = torch.full((b, n), cap, dtype=torch.int32,
                             device=k_sorted.device)
    point_voxel.scatter_(1, order, seg)
    return VoxelGrid(
        coords=torch.where(vox_mask[..., None], unpack(uniq), 0),
        keys=uniq, mask=vox_mask, point_voxel=point_voxel, counts=counts,
        barycenter=torch.where(vox_mask[..., None], barycenter, 0.0),
        rep=rep)


def _sorted_by(keys: torch.Tensor, points: torch.Tensor):
    k_sorted, order = torch.sort(keys, dim=1, stable=True)
    return k_sorted, order, torch.gather(points, 1,
                                         order[..., None].expand(-1, -1, 3))


def _voxel_keys(points: torch.Tensor, voxel_size: float,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Packed voxel keys of clouds [B, N, 3], INVALID at masked points."""
    keys = pack_coords(voxel_coords(points, voxel_size))
    return keys if mask is None else torch.where(mask, keys, INVALID_KEY)


def voxelize(points: torch.Tensor, voxel_size: float, capacity: int,
             mask: Optional[torch.Tensor] = None) -> VoxelGrid:
    """Quantize clouds ``points`` [B, N, 3] onto ``capacity`` voxels each;
    beyond capacity the largest packed keys are dropped and their points
    map to the sentinel ``capacity``."""
    return _grid_of_sorted(
        *_sorted_by(_voxel_keys(points, voxel_size, mask), points),
        capacity, unpack_coords)


def voxel_down_sample(points: torch.Tensor, voxel_size: float,
                      capacity: int, mask: Optional[torch.Tensor] = None):
    """Open3D ``voxel_down_sample``: the barycenters of the occupied voxels
    of clouds [B, N, 3].  Returns (points [B, C, 3], mask [B, C])."""
    grid = voxelize(points, voxel_size, capacity, mask)
    return grid.barycenter, grid.mask


def grid_subsample(points: torch.Tensor, voxel_size: float, capacity: int,
                   features: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None):
    """C++ ``grid_subsampling``: barycenters of clouds [B, N, 3] and the
    mean of features [B, N, F] per voxel.  Each voxel's features add over
    its sorted run in original index order (:func:`_run_sums`), the order
    of the reference's segment sum.  Returns (points [B, C, 3], features
    [B, C, F] or None, mask [B, C])."""
    k_sorted, order, p_sorted = _sorted_by(
        _voxel_keys(points, voxel_size, mask), points)
    grid = _grid_of_sorted(k_sorted, order, p_sorted, capacity,
                           unpack_coords)
    if features is None:
        return grid.barycenter, None, grid.mask
    seg = torch.gather(grid.point_voxel, 1, order)
    f_sorted = torch.gather(features, 1, order[..., None].expand(
        -1, -1, features.shape[2]))
    fsum, counts = _run_sums(f_sorted, seg, capacity)
    fmean = fsum / torch.clamp(counts, min=1)[..., None]
    return grid.barycenter, torch.where(grid.mask[..., None], fmean,
                                        0.0), grid.mask


def voxelize_pyramid(points: torch.Tensor, base_voxel: float,
                     capacities: Sequence[int],
                     mask: Optional[torch.Tensor] = None):
    """Every pyramid level (voxel = base * 2^l) of clouds [B, N, 3] from ONE
    stable sort by level-0 Morton key: the level-l key is ``key0 >> 3*l``,
    which keeps the sorted order, so each coarser level is a boundary scan.

    Voxels come in Morton order and ``keys`` holds Morton keys (not the
    x-major :func:`pack_coords` keys of :func:`voxelize`); overflow drops
    the Morton-largest voxels.  Returns a tuple of :class:`VoxelGrid`.
    """
    b, n, _ = points.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    key0 = torch.where(mask, morton_pack(voxel_coords(points, base_voxel)),
                       INVALID_KEY)
    k_sorted, order, p_sorted = _sorted_by(key0, points)
    valid_sorted = k_sorted != INVALID_KEY
    return tuple(
        _grid_of_sorted(
            torch.where(valid_sorted, k_sorted >> (3 * lvl), INVALID_KEY),
            order, p_sorted, cap, lambda u, lvl=lvl: morton_unpack(u, lvl))
        for lvl, cap in enumerate(capacities))


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
    valid = sorted_keys != INVALID_KEY
    is_new = valid.clone()
    is_new[:, 1:] &= sorted_keys[:, 1:] != sorted_keys[:, :-1]
    seg = torch.cumsum(is_new.to(torch.int32), dim=1, dtype=torch.int32) - 1
    seg = torch.where(valid & (seg < capacity), seg, capacity)
    # segment-min into an INVALID-filled buffer: empty segments stay padding
    uniq = _segment_min(torch.where(valid, sorted_keys, INVALID_KEY), seg,
                        capacity, INVALID_KEY)
    return uniq.contiguous(), seg


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
    n = points.shape[1]
    k_sorted, idx_sorted = torch.sort(_voxel_keys(points, voxel_size, mask),
                                      dim=1, stable=True)
    uniq, seg = unique_of_sorted(k_sorted, capacity)
    vox_mask = uniq != INVALID_KEY
    found = seg < capacity
    rep = torch.where(vox_mask, _segment_min(
        torch.where(found, idx_sorted.to(torch.int32), n), seg, capacity, n),
        n)
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
    ks, order = torch.sort(_voxel_keys(points, voxel_size, mask), dim=1,
                           stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(-1, -1, 3))
    is_first = ks != INVALID_KEY
    is_first[:, 1:] &= ks[:, 1:] != ks[:, :-1]
    return torch.where(is_first[..., None], pts, 0.0), is_first
