"""KPConv: the point pyramid, the kernel-point convolution and its blocks
(port of ``apr_tpu/models/kpconv.py``).

- :func:`build_kp_pyramid` grid-subsamples each cloud of a batch at
  dl * 2^l (barycenters, one sort for all levels) and builds per level the
  conv table (radius neighbours), the pool table (coarse queries into the
  finer level, the finer level's radius) and the 1-NN upsample table.
  Levels of 8192 voxels or more search through the windowed radius search;
  a search whose slab overflowed its window reruns through the exact
  search (unless the caller keeps overflowed tables, as the grouped train
  build does).  The overflow flags of every windowed search of a build are
  read with one host sync, after all of them are queued.
- :class:`KPConvLayer` computes every kernel point's influence at once and
  reduces neighbours with one batched product, then mixes kernel points
  with one ``[F, K*Cin] @ [K*Cin, Cout]`` product; the pair axis folds into
  the rows with one shared shadow row at +1e6.
- Blocks work on stacked pairs [P, N, C] and every instance norm takes one
  statistic over all valid points of the stack (the reference normalises
  its concatenated src+tgt stack).

Submodules carry the flax tree's names (``Dense_0``,
``MaskedInstanceNorm_0``, ``conv``, ``unary1``, ...), so the bridge maps
names one to one.  ``compute_dtype="bfloat16"`` rounds the contraction's
operands to bf16 and multiplies and accumulates in float32; positions,
distances and influences stay float32.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apr_torch.models.kernel_points import load_kernels
from apr_torch.models.layers import MaskedInstanceNorm
from apr_torch.models.resunet import Dense
from apr_torch.ops.neighbors import knn, radius_neighbors, \
    windowed_radius_neighbors
from apr_torch.ops.pooling import gather_neighbors, gather_rows, \
    max_pool_neighbors
from apr_torch.ops.voxelize import voxelize_pyramid

log = logging.getLogger(__name__)

# levels with at least this many voxels search through the windowed search
WINDOW_MIN_SUPPORTS = 8192


# ---------------------------------------------------------------------------
# Point pyramid
# ---------------------------------------------------------------------------

class KPLevel(NamedTuple):
    """One level; a batched pyramid gives every field a leading dim B."""

    points: torch.Tensor      # [N_l, 3] barycenters
    mask: torch.Tensor        # [N_l]
    neighbors: torch.Tensor   # [N_l, cap_l] conv table (sentinel N_l)
    pools: torch.Tensor       # [N_{l+1}, cap_l] coarse -> fine ([1, 1] last)
    upsamples: torch.Tensor   # [N_l, 1] nearest coarse point ([1, 1] last)


class KPPyramid(NamedTuple):
    levels: Tuple[KPLevel, ...]


def select_cloud(pyr: KPPyramid, i: int) -> KPPyramid:
    """Cloud ``i`` of a batched pyramid."""
    return KPPyramid(levels=tuple(KPLevel(*(t[i] for t in lv))
                                  for lv in pyr.levels))


def build_kp_pyramid(
    points: torch.Tensor,
    mask: torch.Tensor,
    first_subsampling_dl: float = 0.3,
    conv_radius: float = 4.25,
    num_levels: int = 4,
    capacities: Sequence[int] = (16384, 4096, 1024, 256),
    neighbor_limits: Sequence[int] = (40, 40, 40, 40),
    overflow_fallback: bool = True,
) -> KPPyramid:
    """The KP pyramid of every cloud of points [B, N, 3] / mask [B, N]
    (the reference's collate_fn_descriptor).  The conv radius starts at
    ``first_subsampling_dl * conv_radius`` and doubles per level; pool
    tables use the finer level's radius, upsample tables the 1-NN into the
    coarser level.

    A windowed search whose slab overflowed its window in some cloud
    reruns, for those clouds, through the exact search.  With
    ``overflow_fallback=False`` an overflowed table stays as it is and the
    build makes no host sync, as the reference's grouped train build
    (``build_batch_group``) keeps it.  ``build_kp_pyramid.windowed`` and
    ``.fallbacks`` count the (search, cloud) pairs that went through the
    window and that fell back.
    """
    grids = voxelize_pyramid(points, first_subsampling_dl, capacities, mask)
    return kp_pyramid_tables(grids, first_subsampling_dl * conv_radius,
                             num_levels, neighbor_limits, overflow_fallback)


def kp_pyramid_tables(grids, radius: float, num_levels: int,
                      neighbor_limits: Sequence[int],
                      overflow_fallback: bool = True) -> KPPyramid:
    """:func:`build_kp_pyramid` after the voxelization: every level's conv,
    pool and upsample tables over ``grids`` (``voxelize_pyramid``'s
    levels), the conv radius ``radius`` (metres) at level 0."""
    pts = [g.barycenter for g in grids]
    msk = [g.mask for g in grids]
    b = pts[0].shape[0]
    pending = []   # (windowed output, overflow [B], exact-search arguments)

    def search(q, s, r, cap, q_mask, s_mask):
        if s.shape[1] < WINDOW_MIN_SUPPORTS:
            return radius_neighbors(q, s, r, cap, q_mask=q_mask,
                                    s_mask=s_mask)
        out, ovf = windowed_radius_neighbors(
            q, s, r, cap, q_mask=q_mask, s_mask=s_mask, with_overflow=True)
        build_kp_pyramid.windowed += b
        if overflow_fallback:
            pending.append((out, ovf, (q, s, r, cap, q_mask, s_mask)))
        return out

    levels = []
    r = radius
    for lvl in range(num_levels):
        nb = search(pts[lvl], pts[lvl], r, neighbor_limits[lvl], msk[lvl],
                    msk[lvl])
        if lvl + 1 < num_levels:
            pools = search(pts[lvl + 1], pts[lvl], r, neighbor_limits[lvl],
                           msk[lvl + 1], msk[lvl])
            up, _ = knn(pts[lvl], pts[lvl + 1], 1, q_mask=msk[lvl],
                        s_mask=msk[lvl + 1])
        else:
            pools = torch.zeros((b, 1, 1), dtype=torch.int32,
                                device=pts[0].device)
            up = pools.clone()
        levels.append(KPLevel(points=pts[lvl], mask=msk[lvl], neighbors=nb,
                              pools=pools, upsamples=up))
        r = r * 2

    if pending:
        # one host sync for every overflow flag of the build
        flags = torch.stack([ovf for _, ovf, _ in pending]).cpu() > 0
        for (out, _, (q, s, r, cap, q_mask, s_mask)), row in zip(pending,
                                                                  flags):
            clouds = torch.nonzero(row).flatten().to(out.device)
            if len(clouds) == 0:
                continue
            out[clouds] = radius_neighbors(
                q[clouds], s[clouds], r, cap, q_mask=q_mask[clouds],
                s_mask=s_mask[clouds])
            build_kp_pyramid.fallbacks += len(clouds)
            log.info("windowed radius search overflowed in %d cloud(s); "
                     "reran the exact search", len(clouds))
    return KPPyramid(levels=tuple(levels))


build_kp_pyramid.windowed = 0
build_kp_pyramid.fallbacks = 0


# ---------------------------------------------------------------------------
# Core KPConv layer
# ---------------------------------------------------------------------------

def _cast(t: torch.Tensor, cd: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` rounded to ``cd`` and held in float32 (float32 products of
    the rounded operands, float32 sums)."""
    return t if cd is None else t.to(cd).float()


class KPConvLayer(nn.Module):
    """forward(q_pts [P, Nq, 3], s_pts [P, Ns, 3], neighb [P, Nq, nmax],
    x [P, Ns, Cin]) -> [P, Nq, Cout] (or the same without the P axis).

    ``ones_input``: x is the constant-ones input feature, so the gathered
    features are the validity pattern and the contraction is a row sum of
    influences.  Influence is linear and neighbours sum over kernel points
    (the only ones the reference's KPFCNN builds).  ``deformable``: a
    rigid offset KPConv predicts per-query kernel-point shifts (times
    ``kp_extent``), and neighbours out of reach
    of every shifted kernel point drop out; ``modulated`` adds 2*sigmoid
    gates per kernel point.  The neighbour count that normalises the
    output counts valid neighbours whose gathered feature sum is > 0, the
    reference's proxy (kept: it changes the divisor)."""

    def __init__(self, in_channels: int, out_channels: int, kp_extent: float,
                 radius: float, num_kernel_points: int = 15,
                 deformable: bool = False, modulated: bool = False,
                 compute_dtype: Optional[str] = None,
                 ones_input: bool = False):
        super().__init__()
        if ones_input and (in_channels != 1 or deformable):
            raise ValueError("ones_input needs one input channel and a "
                             "rigid kernel")
        k = num_kernel_points
        self.out_channels = out_channels
        self.kp_extent = kp_extent
        self.num_kernel_points = k
        self.deformable = deformable
        self.modulated = modulated
        self.compute_dtype = (None if compute_dtype in (None, "float32")
                              else getattr(torch, compute_dtype))
        self.ones_input = ones_input
        # frozen (the reference's Parameter(requires_grad=False)); ringed at
        # 0.66 * radius, the scale of its shipped disposition file
        kp = load_kernels(0.66 * radius, k, deterministic=True)
        self.kernel_points = nn.Parameter(torch.from_numpy(kp),
                                          requires_grad=False)
        self.weights = nn.Parameter(torch.empty(k, in_channels, out_channels))
        if deformable:
            offset_dim = (4 if modulated else 3) * k
            self.offset_conv = KPConvLayer(
                in_channels, offset_dim, kp_extent, radius, k,
                compute_dtype=compute_dtype)
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def forward(self, q_pts, s_pts, neighb_inds, x):
        stacked = q_pts.dim() == 3
        if not stacked:
            q_pts, s_pts, neighb_inds, x = (
                q_pts[None], s_pts[None], neighb_inds[None], x[None])
        p, ns, cin = x.shape
        k = self.num_kernel_points
        cd = self.compute_dtype
        kernel_points = self.kernel_points.detach()

        offsets = modulations = None
        if self.deformable:
            raw = self.offset_conv(q_pts, s_pts, neighb_inds, x) \
                + self.offset_bias
            offsets = raw[..., :3 * k].reshape(p, -1, k, 3) * self.kp_extent
            if self.modulated:
                modulations = 2.0 * torch.sigmoid(raw[..., 3 * k:])

        # fold the pair axis into the rows: per-cloud index offsets, one
        # shared shadow row (the reference pads s_pts with a +1e6 row)
        nq, nmax = neighb_inds.shape[1:]
        f = p * nq
        valid = neighb_inds < ns
        offs = (torch.arange(p, dtype=neighb_inds.dtype,
                             device=x.device) * ns)[:, None, None]
        flat_idx = torch.where(valid, torch.clamp(neighb_inds, max=ns - 1)
                               + offs, p * ns).reshape(f, nmax).long()
        valid = valid.reshape(f, nmax)
        s_pad = torch.cat([s_pts.reshape(p * ns, 3),
                           s_pts.new_full((1, 3), 1e6)], 0)
        neighbors = s_pad[flat_idx] - q_pts.reshape(f, 3)[:, None, :]
        if self.ones_input:
            neighb_x = None
        else:
            # the shadow row p * ns is a zero row that takes no gradient
            neighb_x = _cast(gather_rows(x.reshape(p * ns, cin), flat_idx),
                             cd)                              # [F, nmax, Cin]

        # every kernel point's influence at once, in float32
        centers = kernel_points[None, None]                   # [1, 1, K, 3]
        if offsets is not None:
            centers = centers + offsets.reshape(f, k, 3)[:, None]
        diff = neighbors[:, :, None, :] - centers
        sq = (diff * diff).sum(-1)                            # [F, nmax, K]
        if self.deformable:
            valid = valid & (sq.amin(-1) < self.kp_extent ** 2)
        w = torch.where(valid[..., None], torch.clamp(
            1.0 - torch.sqrt(sq) / self.kp_extent, min=0.0), 0.0)
        if modulations is not None:
            w = w * modulations.reshape(f, k)[:, None, :]
        w = _cast(w, cd)

        # neighbour reduction, then kernel mixing: one product each
        if self.ones_input:
            m = w.sum(1)                                      # [F, K]
        else:
            m = torch.bmm(w.transpose(1, 2), neighb_x)        # [F, K, Cin]
        out = torch.matmul(_cast(m.reshape(f, k * cin), cd),
                           _cast(self.weights.reshape(k * cin, -1), cd))

        feat_nonzero = (valid if self.ones_input
                        else neighb_x.sum(-1) > 0.0)          # [F, nmax]
        n_valid = torch.clamp((valid & feat_nonzero).sum(1), min=1)
        out = (out / n_valid[:, None]).to(x.dtype).reshape(p, nq, -1)
        return out if stacked else out[0]


# ---------------------------------------------------------------------------
# Blocks (the reference's block_decider library)
# ---------------------------------------------------------------------------

def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


def _lift(single, *arrays):
    """A leading P=1 axis for unstacked single-cloud arguments."""
    return tuple(a[None] for a in arrays) if single else arrays


def _joint_norm(norm: MaskedInstanceNorm, x, mask):
    """One instance-norm statistic over every valid point of the [P, N, C]
    stack (the reference's stacked-pair normalisation)."""
    p, n, c = x.shape
    return norm(x.reshape(1, p * n, c), mask.reshape(1, p * n)).reshape(
        p, n, c)


class UnaryBlock(nn.Module):
    """Dense (no bias when normed), joint instance norm, leaky ReLU."""

    def __init__(self, in_dim: int, out_dim: int, use_norm: bool = True,
                 no_relu: bool = False):
        super().__init__()
        self.use_norm = use_norm
        self.no_relu = no_relu
        self.Dense_0 = Dense(in_dim, out_dim, use_bias=not use_norm)
        if use_norm:
            self.MaskedInstanceNorm_0 = MaskedInstanceNorm(out_dim)

    def forward(self, x, mask):
        single = x.dim() == 2
        x, mask = _lift(single, x, mask)
        x = self.Dense_0(x)
        if self.use_norm:
            x = _joint_norm(self.MaskedInstanceNorm_0, x, mask)
        if not self.no_relu:
            x = _leaky(x)
        x = torch.where(mask[..., None], x, 0.0)
        return x[0] if single else x


class SimpleBlock(nn.Module):
    """KPConv to out_dim // 2, joint instance norm, leaky ReLU."""

    def __init__(self, in_dim: int, out_dim: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 deformable: bool = False, modulated: bool = False,
                 compute_dtype: Optional[str] = None,
                 ones_input: bool = False):
        super().__init__()
        self.conv = KPConvLayer(
            in_dim, out_dim // 2, kp_extent, radius, num_kernel_points,
            deformable=deformable,
            modulated=modulated, compute_dtype=compute_dtype,
            ones_input=ones_input)
        self.MaskedInstanceNorm_0 = MaskedInstanceNorm(out_dim // 2)

    def forward(self, q_pts, s_pts, neighb, x, q_mask):
        single = x.dim() == 2
        q_pts, s_pts, neighb, x, q_mask = _lift(single, q_pts, s_pts, neighb,
                                                x, q_mask)
        h = self.conv(q_pts, s_pts, neighb, x)
        h = _joint_norm(self.MaskedInstanceNorm_0, h, q_mask)
        h = torch.where(q_mask[..., None], _leaky(h), 0.0)
        return h[0] if single else h


class ResnetBottleneckBlock(nn.Module):
    """unary (to out_dim // 4) -> KPConv -> norm -> unary (to out_dim),
    plus the shortcut (a max pool over the pool table when strided, a
    unary when the width changes)."""

    def __init__(self, in_dim: int, out_dim: int, radius: float,
                 kp_extent: float, strided: bool = False,
                 num_kernel_points: int = 15, deformable: bool = False,
                 modulated: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        mid = out_dim // 4
        self.strided = strided
        if in_dim != mid:
            self.unary1 = UnaryBlock(in_dim, mid)
        self.conv = KPConvLayer(
            mid, mid, kp_extent, radius, num_kernel_points,
            deformable=deformable, modulated=modulated,
            compute_dtype=compute_dtype)
        self.norm_conv = MaskedInstanceNorm(mid)
        self.unary2 = UnaryBlock(mid, out_dim, no_relu=True)
        if in_dim != out_dim:
            self.unary_shortcut = UnaryBlock(in_dim, out_dim, no_relu=True)

    def forward(self, q_pts, s_pts, neighb, x, q_mask, s_mask):
        """neighb [P, Nq, nmax] into the supports (the pool table when
        strided)."""
        single = x.dim() == 2
        q_pts, s_pts, neighb, x, q_mask, s_mask = _lift(
            single, q_pts, s_pts, neighb, x, q_mask, s_mask)
        h = self.unary1(x, s_mask) if hasattr(self, "unary1") else x
        h = self.conv(q_pts, s_pts, neighb, h)
        h = _leaky(_joint_norm(self.norm_conv, h, q_mask))
        h = self.unary2(h, q_mask)
        if self.strided:
            shortcut = torch.where(q_mask[..., None],
                                   max_pool_neighbors(x, neighb), 0.0)
        else:
            shortcut = x
        if hasattr(self, "unary_shortcut"):
            shortcut = self.unary_shortcut(shortcut, q_mask)
        out = torch.where(q_mask[..., None], _leaky(h + shortcut), 0.0)
        return out[0] if single else out


def nearest_upsample(x_coarse: torch.Tensor,
                     up_idx: torch.Tensor) -> torch.Tensor:
    """Each fine point takes its nearest coarse point's feature:
    [P, Nc, C] + [P, Nf, 1] -> [P, Nf, C] (sentinel -> zeros)."""
    return gather_neighbors(x_coarse, up_idx)[..., 0, :]


@torch.no_grad()
def reset_kp_parameters_(module: nn.Module, generator: torch.Generator):
    """Random weights from a CPU generator, in the reference's init
    families: KPConv weights variance-scaling(2, fan_in, uniform), dense
    kernels lecun-normal, biases zero (norms keep scale 1, bias 0).  Call
    before moving the module."""
    for m in module.modules():
        if isinstance(m, KPConvLayer):
            fan_in = m.weights.shape[0] * m.weights.shape[1]
            bound = math.sqrt(3.0 * 2.0 / fan_in)
            m.weights.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Dense):
            m.kernel.normal_(0.0, math.sqrt(1.0 / m.kernel.shape[0]),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
