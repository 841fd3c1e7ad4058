"""Sparse voxel tensors: coordinate pyramids, kernel maps and the
gather-matmul sparse convolution, over a leading batch of clouds.

The port of ``apr_tpu/models/sparse.py``.  Each level keeps its voxels as a
sorted row of packed int32 keys (``apr_torch.ops.hashing``); kernel maps
are batched binary searches into those rows (kernel K1,
``apr_torch.ops.searchsorted``; one grouped launch for every map of a
pyramid build), and the sparse convolution is one gather
plus one matmul.  Every map is a sentinel-padded int32 table: a missing
neighbour points at the sentinel row (index == capacity), which carries
zero features.  :func:`sparse_conv_adjoint` differentiates the conv with
a backward that gathers over the transpose map instead of scattering.

Semantics are MinkowskiEngine's for the ResUNet: stride-2 downsampling
keeps unique(floor(c / 2)); a kernel-size-k same-level conv covers offsets
in [-(k-1)/2, (k-1)/2]^3; a stride-2 down conv gathers fine voxels at
2q + o, o in [-1, 0, 1]^3; the up map is the exact transpose of the down
map.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apr_torch.ops.hashing import COORD_BITS, INVALID_KEY, pack_coords, \
    unpack_coords
from apr_torch.ops.searchsorted import searchsorted_left_many
from apr_torch.ops.voxelize import unique_of_sorted


class SparseLevel(NamedTuple):
    """Voxels of one pyramid level (tensor stride 2^l), fixed capacity C;
    coords are in level units.  Every field has a leading batch dim B."""

    coords: torch.Tensor  # int32 [B, C, 3]
    keys: torch.Tensor    # int32 [B, C], ascending, INVALID_KEY padding
    mask: torch.Tensor    # bool  [B, C]


class SparsePyramid(NamedTuple):
    """Everything a sparse U-Net forward needs, built once per batch."""

    levels: Tuple[SparseLevel, ...]
    same_maps: Tuple[torch.Tensor, ...]   # per level: [B, C_l, 27]
    down_maps: Tuple[torch.Tensor, ...]   # level l -> l+1: [B, C_{l+1}, 27]
    up_maps: Tuple[torch.Tensor, ...]     # level l+1 -> l: [B, C_l, 27]
    conv1_map: torch.Tensor               # [B, C_0, k1^3] first-conv table


def offsets_grid(kernel_size: int) -> np.ndarray:
    """All integer offsets of a cubic kernel, ME's region order (z fastest)."""
    r = kernel_size // 2
    rng = np.arange(-r, r + 1)
    grid = np.stack(
        np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    return grid.astype(np.int32)


# --- slow lookups: the oracles the fast maps are held against -------------

def lookup_keys(level_keys: torch.Tensor,
                query_keys: torch.Tensor) -> torch.Tensor:
    """Index of each query key [B, Q] in the sorted level keys [B, C], or C
    if absent.  Uses ``torch.searchsorted``, independent of kernel K1."""
    c = level_keys.shape[1]
    slot = torch.searchsorted(level_keys, query_keys, out_int32=True)
    slot = slot.clamp(0, c - 1)
    found = torch.gather(level_keys, 1, slot.long()) == query_keys
    return torch.where(found, slot, c)


def _query_all_offsets(level: SparseLevel, query_coords, query_mask):
    """Look up query coords [B, K, C, 3] (mask [B, 1 or K, C]) -> [B, K, C]."""
    b, k, c = query_coords.shape[:3]
    qk = torch.where(query_mask, pack_coords(query_coords), INVALID_KEY)
    idx = lookup_keys(level.keys, qk.reshape(b, k * c)).reshape(b, k, c)
    return torch.where(query_mask, idx, level.keys.shape[1])


def kernel_map_same(level: SparseLevel, kernel_size: int = 3) -> torch.Tensor:
    """[B, C, k^3] neighbour table for a same-level conv (sentinel C)."""
    offs = torch.as_tensor(offsets_grid(kernel_size),
                           device=level.coords.device)
    q = level.coords[:, None, :, :] + offs[None, :, None, :]
    maps = _query_all_offsets(level, q, level.mask[:, None, :])
    return maps.transpose(1, 2)


def kernel_map_down(coarse: SparseLevel, fine: SparseLevel,
                    kernel_size: int = 3) -> torch.Tensor:
    """[B, C_coarse, k^3] table of fine-level inputs for a stride-2 conv."""
    offs = torch.as_tensor(offsets_grid(kernel_size),
                           device=coarse.coords.device)
    q = (coarse.coords * 2)[:, None, :, :] + offs[None, :, None, :]
    maps = _query_all_offsets(fine, q, coarse.mask[:, None, :])
    return maps.transpose(1, 2)


def kernel_map_up(fine: SparseLevel, coarse: SparseLevel,
                  kernel_size: int = 3) -> torch.Tensor:
    """[B, C_fine, k^3] table of coarse inputs for the transposed conv:
    entry (f, o) is the coarse voxel (fine_coords[f] - o) / 2 when that
    division is exact, else the sentinel.  The adjoint of
    :func:`kernel_map_down` in the same offset order; the oracle for the
    fast up maps (:func:`transpose_kernel_map`)."""
    offs = torch.as_tensor(offsets_grid(kernel_size),
                           device=fine.coords.device)
    shifted = fine.coords[:, None, :, :] - offs[None, :, None, :]
    even = ((shifted & 1) == 0).all(dim=-1)                # [B, K, Cf]
    maps = _query_all_offsets(coarse, shifted >> 1,
                              fine.mask[:, None, :] & even)
    maps = torch.where(even, maps, coarse.keys.shape[1])
    return maps.transpose(1, 2)


# --- fast maps: z-run decomposition over kernel K1 -------------------------

def zrun_queries(base_keys: torch.Tensor, base_coords: torch.Tensor,
                 base_mask: torch.Tensor, kernel_size: int):
    """First-target keys t0 [B, G, C] and their validity ok [B, G, C] for
    the G = k^2 (ox, oy) columns of a k^3 map.

    For a fixed (ox, oy) the k targets pack(base + (ox, oy, oz)),
    oz = -r..r, are consecutive int32 keys (z is the low field of
    :func:`pack_coords`), so one search for the first target finds all k.
    Each row of t0 is base_keys + a constant, ascending where ok, with
    INVALID holes: the contract of :func:`searchsorted_left`.
    """
    r = kernel_size // 2
    two_b = 2 * COORD_BITS
    # pack() is linear only while every shifted component stays inside its
    # 10-bit field; columns that would leave it map to the sentinel
    lo, hi = -(1 << (COORD_BITS - 1)), (1 << (COORD_BITS - 1)) - 1
    cx, cy, cz = base_coords[..., 0], base_coords[..., 1], base_coords[..., 2]
    z_ok = base_mask & (cz - r >= lo) & (cz + r <= hi)
    t0s, oks = [], []
    for ox in range(-r, r + 1):
        for oy in range(-r, r + 1):
            delta = (ox << two_b) + (oy << COORD_BITS) - r
            ok = (z_ok & (cx + ox >= lo) & (cx + ox <= hi)
                  & (cy + oy >= lo) & (cy + oy <= hi))
            t0s.append(torch.where(ok, base_keys + delta, INVALID_KEY))
            oks.append(ok)
    return torch.stack(t0s, dim=1), torch.stack(oks, dim=1)


class ZrunSearch(NamedTuple):
    """One k^3 kernel map as the k^2 searches of its first-target keys."""

    support: torch.Tensor  # int32 [B, S], the sorted keys searched
    t0: torch.Tensor       # int32 [B, G, C], from zrun_queries
    ok: torch.Tensor       # bool [B, G, C]
    kernel_size: int


def zrun_search(support_keys: torch.Tensor, base_keys: torch.Tensor,
                base_coords: torch.Tensor, base_mask: torch.Tensor,
                kernel_size: int) -> ZrunSearch:
    """The searches of the k^3 map of ``base`` into ``support_keys``."""
    t0, ok = zrun_queries(base_keys, base_coords, base_mask, kernel_size)
    return ZrunSearch(support_keys.contiguous(), t0, ok, kernel_size)


def zrun_decode(search: ZrunSearch, j0: torch.Tensor) -> torch.Tensor:
    """All k^3 offset lookups from the k^2 insertion points j0 [B, G, C].

    Present targets of one (ox, oy) column occupy consecutive positions of
    the sorted support starting at j0 = searchsorted(support, t0); reading
    the k keys from j0 on decodes every oz slot.  Returns [B, K, C] in
    :func:`offsets_grid` order, sentinel S.
    """
    support_keys, t0, ok, k = search
    b, s = support_keys.shape
    g, c = t0.shape[1:]
    # window [j0, j0 + k) of each column, read as one row of a [S, k]
    # matrix of shifted keys
    kst = torch.stack(
        [torch.nn.functional.pad(support_keys[:, m:], (0, m),
                                 value=INVALID_KEY) for m in range(k)],
        dim=2)                                                 # [B, S, k]
    jc = j0.clamp(max=s - 1).long().reshape(b, g * c, 1).expand(-1, -1, k)
    v = torch.gather(kst, 1, jc).reshape(b, g, c, k)
    t = v - t0[..., None]                                      # oz slot
    idx = (j0[..., None] + torch.arange(k, dtype=torch.int32,
                                        device=j0.device)).clamp(max=s - 1)
    hit_ok = ok[..., None]
    slots = [torch.where((t == oz) & hit_ok, idx, s).amin(dim=3)
             for oz in range(k)]                               # k x [B, G, C]
    return torch.stack(slots, dim=2).reshape(b, g * k, c)


def _down_search(coarse: SparseLevel, fine: SparseLevel,
                 kernel_size: int) -> ZrunSearch:
    base = coarse.coords * 2
    base_keys = torch.where(coarse.mask, pack_coords(base), INVALID_KEY)
    return zrun_search(fine.keys, base_keys, base, coarse.mask, kernel_size)


def pyramid_searches(levels: Sequence[SparseLevel],
                     conv1_kernel_size: int = 5
                     ) -> List[Tuple[str, ZrunSearch]]:
    """The searches of every map a pyramid build makes, by name: "conv1"
    (the level-0 k1^3 map), "down{l}" (level l -> l+1), "same{l}" for the
    coarser levels, and "same0" when conv1 does not cover the level-0 3^3
    map (k1 < 3)."""
    out = [("conv1", zrun_search(levels[0].keys, levels[0].keys,
                                 levels[0].coords, levels[0].mask,
                                 conv1_kernel_size))]
    out += [(f"down{l}", _down_search(levels[l + 1], levels[l], 3))
            for l in range(len(levels) - 1)]
    first = 0 if conv1_kernel_size < 3 else 1
    out += [(f"same{l}", zrun_search(lv.keys, lv.keys, lv.coords, lv.mask, 3))
            for l, lv in enumerate(levels) if l >= first]
    return out


def transpose_kernel_map(down: torch.Tensor, n_fine: int,
                         n_coarse: int) -> torch.Tensor:
    """The up (transposed-conv) map [B, n_fine, K] from the down map
    [B, n_coarse, K] by one scatter: down[c, j] = f <=> up[f, j] = c.
    Sentinel entries of ``down`` land in a dropped overflow row."""
    b, rows_n, k = down.shape
    rows = torch.arange(rows_n, dtype=torch.int32,
                        device=down.device)[None, :, None].expand(b, -1, k)
    out = torch.full((b, n_fine + 1, k), n_coarse, dtype=torch.int32,
                     device=down.device)
    out.scatter_(1, down.clamp(max=n_fine).long(), rows)
    return out[:, :n_fine]


def downsample_level(level: SparseLevel, capacity: int) -> SparseLevel:
    """Coarsen by 2: unique floor-halved coords at a fixed capacity.

    Halved x-major keys are not sorted even though the input keys are, so
    this sorts them again before the fixed-size unique."""
    keys = torch.where(level.mask, pack_coords(level.coords >> 1),
                       INVALID_KEY)
    uniq, _ = unique_of_sorted(torch.sort(keys, dim=1).values, capacity)
    mask = uniq != INVALID_KEY
    return SparseLevel(
        coords=torch.where(mask[..., None], unpack_coords(uniq), 0),
        keys=uniq,
        mask=mask,
    )


def build_pyramid_from_level(level0: SparseLevel, capacities: Sequence[int],
                             conv1_kernel_size: int = 5) -> SparsePyramid:
    """The full coordinate pyramid and every kernel map from level 0: all
    levels first, then the maps' searches in one grouped K1 launch."""
    assert capacities[0] == level0.keys.shape[1]
    levels: List[SparseLevel] = [level0]
    for cap in capacities[1:]:
        levels.append(downsample_level(levels[-1], cap))

    named = pyramid_searches(levels, conv1_kernel_size)
    j0s = searchsorted_left_many([(s.support, s.t0) for _, s in named])
    maps = {name: zrun_decode(s, j0).transpose(1, 2)
            for (name, s), j0 in zip(named, j0s)}
    down_maps = tuple(maps[f"down{l}"] for l in range(len(levels) - 1))
    up_maps = tuple(
        transpose_kernel_map(down_maps[l], n_fine=capacities[l],
                             n_coarse=capacities[l + 1])
        for l in range(len(levels) - 1)
    )
    conv1_map = maps["conv1"]
    # the level-0 3^3 same map is the central sub-block of the conv1 map
    # whenever conv1 covers it (k >= 3, odd)
    if conv1_kernel_size >= 3:
        k1, r1 = conv1_kernel_size, conv1_kernel_size // 2
        sel = [((ox + r1) * k1 + (oy + r1)) * k1 + (oz + r1)
               for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)]
        same0 = conv1_map[:, :, sel]
    else:
        same0 = maps["same0"]
    same_maps = (same0,) + tuple(maps[f"same{l}"]
                                 for l in range(1, len(levels)))
    return SparsePyramid(
        levels=tuple(levels),
        same_maps=same_maps,
        down_maps=down_maps,
        up_maps=up_maps,
        conv1_map=conv1_map,
    )


def build_pyramid(grid, capacities: Sequence[int],
                  conv1_kernel_size: int = 5) -> SparsePyramid:
    """The full coordinate pyramid of a level-0 voxelization ``grid`` (a
    batched :class:`apr_torch.ops.voxelize.VoxelGrid`, whose capacity is
    ``capacities[0]``)."""
    assert capacities[0] == grid.keys.shape[1], (capacities[0],
                                                 grid.keys.shape[1])
    return build_pyramid_from_level(
        SparseLevel(coords=grid.coords, keys=grid.keys, mask=grid.mask),
        capacities, conv1_kernel_size)


def sparse_conv_apply(
    feats: torch.Tensor,      # [N_in, Ci] source features
    table: torch.Tensor,      # [N_out, K] indices into feats (sentinel N_in)
    weights: torch.Tensor,    # [K, Ci, Co]
    out_mask: Optional[torch.Tensor] = None,  # [N_out]
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Gather-matmul sparse convolution: one [N_out, K, Ci] neighbour gather,
    then one [N_out, K*Ci] @ [K*Ci, Co] product; float32 out.

    ``compute_dtype=torch.bfloat16`` rounds activations and weights to bf16
    (the gather moves half the bytes) and multiplies them in float32, as the
    reference's bf16 dot with a float32 result does: a product of two bf16
    values is exact in float32, and only the order of the sum can differ.
    """
    n_in, ci = feats.shape
    n_out, k = table.shape
    co = weights.shape[-1]
    if compute_dtype is not None:
        feats = feats.to(compute_dtype)
        weights = weights.to(compute_dtype)
    padded = torch.cat([feats, feats.new_zeros((1, ci))], dim=0)
    gathered = padded[table.clamp(max=n_in).long()]           # [N_out, K, Ci]
    out = torch.matmul(gathered.reshape(n_out, k * ci).float(),
                       weights.reshape(k * ci, co).float())
    if out_mask is not None:
        out = torch.where(out_mask[:, None], out, 0.0)
    return out


def _rounded(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x rounded to ``dtype`` (None: kept) and widened to float32."""
    return (x.to(dtype) if dtype is not None else x).float()


def _gathered(src: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """src [N_src, C] gathered through table [N, K] as [N, K * C]; an index
    >= N_src (the sentinel) reads a zero row."""
    n_src, c = src.shape
    padded = torch.cat([src, src.new_zeros((1, c))], dim=0)
    return padded[table.clamp(max=n_src).long()].reshape(table.shape[0], -1)


def fold_table(table: torch.Tensor, n_entries: int) -> torch.Tensor:
    """Fold the batch dim of table [B, N_out, K] into rows: per-cloud index
    offsets and one global sentinel B * n_entries."""
    b = table.shape[0]
    offs = (torch.arange(b, dtype=table.dtype, device=table.device)
            * n_entries)[:, None, None]
    t = torch.where(table < n_entries, table + offs, b * n_entries)
    return t.reshape(b * table.shape[1], table.shape[2])


class SparseConvAdjoint(torch.autograd.Function):
    """:func:`sparse_conv_apply` with a scatter-free backward (port of the
    reference's custom VJP, sparse.py:398-467).

    The input gradient of a gather-matmul conv is another gather-matmul,
    over the structural transpose map:

        d feats = gather_matmul(g, table_t, W~),   W~[j] = W[p(j)]^T

    with (table_t, p) = (table, K-1-j) for a same-level conv (``reverse_k``;
    the offset grid is centrosymmetric), (up map, identity) for a stride-2
    down conv and (down map, identity) for a transposed conv.  The weight
    gradient re-gathers the inputs, so no [N_out, K, Ci] tensor is saved.
    """

    @staticmethod
    def forward(ctx, feats, table, table_t, weights, out_mask, in_mask,
                reverse_k, compute_dtype):
        ctx.reverse_k, ctx.compute_dtype = reverse_k, compute_dtype
        ctx.save_for_backward(feats, table, table_t, weights, out_mask,
                              in_mask)
        return sparse_conv_apply(feats, table, weights, out_mask,
                                 compute_dtype)

    @staticmethod
    def backward(ctx, g):
        feats, table, table_t, weights, out_mask, in_mask = ctx.saved_tensors
        cd = ctx.compute_dtype
        ci = feats.shape[1]
        n_out, k = table.shape
        co = weights.shape[-1]
        table_t = (table if table_t is None
                   else fold_table(table_t, n_out // table_t.shape[0]))
        g = torch.where(out_mask[:, None], g.float(), 0.0)
        w_t = weights.transpose(1, 2)                      # [K, Co, Ci]
        if ctx.reverse_k:
            w_t = w_t.flip(0)
        # the operands rounded to the compute dtype and widened to float32
        # before they are gathered: the float32 matrices of a gather in the
        # compute dtype and its copy, the same values for the same matmuls,
        # with no [N, K*C] gather in bf16 and no copy of it
        gm, f = _rounded(g, cd), _rounded(feats, cd)
        w_t = (w_t.to(cd) if cd is not None else w_t).reshape(k * co, ci)
        dfeats = torch.matmul(_gathered(gm, table_t), w_t.float())
        dfeats = torch.where(in_mask[:, None], dfeats, 0.0)
        # d weights: one [K*Ci, N_out] @ [N_out, Co] product over the
        # re-gathered inputs
        dw = torch.matmul(_gathered(f, table).T, gm).reshape(k, ci, co)
        return (dfeats.to(feats.dtype), None, None, dw.to(weights.dtype),
                None, None, None, None)


def sparse_conv_adjoint(feats, table, table_t, weights, out_mask, in_mask,
                        reverse_k: bool = False,
                        compute_dtype: Optional[torch.dtype] = None):
    """The gather-matmul sparse conv (feats [N_in, Ci], table [N_out, K],
    weights [K, Ci, Co]) whose backward gathers over ``table_t``
    (indices into the output rows); see :class:`SparseConvAdjoint`.

    ``table_t`` is [B, N_in / B, K] per cloud, with sentinel N_out / B,
    and the backward folds it (so a forward with no backward to come never
    pays for it); or None for ``table`` itself (a same-level conv)."""
    return SparseConvAdjoint.apply(feats, table, table_t, weights, out_mask,
                                   in_mask, reverse_k, compute_dtype)
