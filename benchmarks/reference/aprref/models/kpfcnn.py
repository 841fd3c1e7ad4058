# Frozen copy of apr_torch/models/kpfcnn.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""KPFCNN, the Predator model: KPConv U-Net, overlap-attention GCN and the
overlap / saliency heads (port of ``apr_tpu/models/kpfcnn.py``).

The two clouds of a pair are stacked on a leading pair axis [2, N, ...];
every instance norm of the U-Net takes one statistic over both (the
reference concatenates src and tgt into one point stack).  The encoder is
simple + resnetb, then 3x [resnetb_strided, resnetb, resnetb] with the
width doubling after each strided block; a 1x1 bottleneck to
``gnn_feats_dim``; the GCN; the overlap scores and the cross-saliency
(temperature ``exp(epsilon) + 0.03``, ``epsilon`` learnt); the decoder
3x [nearest upsample + unary with the skip]; L2-normalised features and
sigmoid overlap / saliency, NaNs scrubbed.

``KPFCNNDecoder`` is the symmetric NPR decoder of Predator training: a
second KPConv U-Net over the same pyramids, fed the KPFCNN's features.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from reference.aprref.models.gcn import GCN
from reference.aprref.models.kpconv import KPLevel, KPPyramid, \
    ResnetBottleneckBlock, SimpleBlock, UnaryBlock, nearest_upsample
from reference.aprref.models.resunet import Dense


class KPFCNNOutputs(NamedTuple):
    feats0: torch.Tensor       # [N0, final_feats_dim] L2-normalised
    feats1: torch.Tensor
    overlap0: torch.Tensor     # [N0]
    overlap1: torch.Tensor
    saliency0: torch.Tensor    # [N0]
    saliency1: torch.Tensor


def _regular_score(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _l2_normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def stack_pair(pyr0: KPPyramid, pyr1: KPPyramid) -> KPPyramid:
    """Two same-capacity pyramids stacked onto a leading pair axis."""
    return KPPyramid(levels=tuple(
        KPLevel(*(torch.stack([a, b]) for a, b in zip(l0, l1)))
        for l0, l1 in zip(pyr0.levels, pyr1.levels)))


class KPEncoder(nn.Module):
    """4-level KPConv encoder over a stacked pyramid [P, N_l, ...]; returns
    (bottleneck feats [P, N3, 8 * first_feats_dim], skips per level)."""

    def __init__(self, in_dim: int = 1, first_feats_dim: int = 256,
                 first_subsampling_dl: float = 0.3, conv_radius: float = 4.25,
                 kp_extent: float = 2.0, num_kernel_points: int = 15,
                 deformable: bool = False, modulated: bool = False,
                 compute_dtype: Optional[str] = None,
                 ones_input: bool = True):
        super().__init__()
        r = first_subsampling_dl * conv_radius
        self.ones_input = ones_input

        def extent(radius):
            return radius * kp_extent / conv_radius

        # num_kernel_points reaches the first block only: the reference
        # builds every bottleneck block with its default of 15
        rk = dict(deformable=deformable, modulated=modulated,
                  compute_dtype=compute_dtype)
        out_dim = first_feats_dim
        self.enc_simple = SimpleBlock(
            in_dim, out_dim, r, extent(r), num_kernel_points=num_kernel_points,
            compute_dtype=compute_dtype, ones_input=ones_input)
        self.enc_l0_resnetb = ResnetBottleneckBlock(
            out_dim // 2, out_dim, r, extent(r), **rk)
        for lvl in range(3):
            # the strided block keeps the width; the next one widens
            setattr(self, f"enc_l{lvl}_strided", ResnetBottleneckBlock(
                out_dim, out_dim, r, extent(r), strided=True, **rk))
            out_dim *= 2
            r *= 2
            setattr(self, f"enc_l{lvl + 1}_resnetb1", ResnetBottleneckBlock(
                out_dim // 2, out_dim, r, extent(r), **rk))
            setattr(self, f"enc_l{lvl + 1}_resnetb2", ResnetBottleneckBlock(
                out_dim, out_dim, r, extent(r), **rk))
        self.skip_dims = (first_feats_dim, 2 * first_feats_dim,
                          4 * first_feats_dim)
        self.out_dim = out_dim

    def forward(self, pyr: KPPyramid, feats: Optional[torch.Tensor] = None):
        lv = pyr.levels
        if feats is None:
            # the reference's input feature: ones on valid points
            feats = lv[0].mask[..., None].float()
        x = self.enc_simple(lv[0].points, lv[0].points, lv[0].neighbors,
                            feats, lv[0].mask)
        x = self.enc_l0_resnetb(lv[0].points, lv[0].points, lv[0].neighbors,
                                x, lv[0].mask, lv[0].mask)
        skips = []
        for lvl in range(3):
            skips.append(x)
            fine, coarse = lv[lvl], lv[lvl + 1]
            x = getattr(self, f"enc_l{lvl}_strided")(
                coarse.points, fine.points, fine.pools, x, coarse.mask,
                fine.mask)
            for name in ("resnetb1", "resnetb2"):
                x = getattr(self, f"enc_l{lvl + 1}_{name}")(
                    coarse.points, coarse.points, coarse.neighbors, x,
                    coarse.mask, coarse.mask)
        return x, skips


class KPDecoder(nn.Module):
    """3x [nearest upsample + unary over concat(x, skip)], ending in a bare
    dense ``last_unary``; widths halve from in_dim // 2."""

    def __init__(self, in_dim: int, skip_dims: Sequence[int], out_dim: int):
        super().__init__()
        c, width = in_dim, in_dim // 2
        for lvl in range(2, -1, -1):
            c += skip_dims[lvl]
            if lvl > 0:
                setattr(self, f"dec_unary{lvl}", UnaryBlock(c, width))
                c, width = width, width // 2
            else:
                self.last_unary = Dense(c, out_dim)

    def forward(self, x, skips, pyr: KPPyramid):
        lv = pyr.levels
        for lvl in range(2, -1, -1):
            x = torch.cat([nearest_upsample(x, lv[lvl].upsamples),
                           skips[lvl]], dim=-1)
            if lvl > 0:
                x = getattr(self, f"dec_unary{lvl}")(x, lv[lvl].mask)
            else:
                x = torch.where(lv[0].mask[..., None], self.last_unary(x),
                                0.0)
        return x


class KPFCNN(nn.Module):
    """Pair forward: (pyr0, pyr1) -> :class:`KPFCNNOutputs`."""

    def __init__(self, final_feats_dim: int = 32, first_feats_dim: int = 256,
                 gnn_feats_dim: int = 256, dgcnn_k: int = 10,
                 num_head: int = 4,
                 nets: Sequence[str] = ("self", "cross", "self"),
                 first_subsampling_dl: float = 0.3, conv_radius: float = 4.25,
                 kp_extent: float = 2.0, num_kernel_points: int = 15,
                 condition_feature: bool = True, add_cross_score: bool = True,
                 deformable: bool = False, modulated: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.final_feats_dim = final_feats_dim
        self.condition_feature = condition_feature
        self.add_cross_score = add_cross_score
        self.encoder = KPEncoder(
            1, first_feats_dim, first_subsampling_dl, conv_radius, kp_extent,
            num_kernel_points, deformable, modulated, compute_dtype)
        g = gnn_feats_dim
        self.bottle = Dense(self.encoder.out_dim, g)
        self.gnn = GCN(g, nets, dgcnn_k, num_head)
        self.proj_gnn = Dense(g, g)
        self.proj_score = Dense(g, 1)
        self.epsilon = nn.Parameter(torch.tensor(-5.0))
        head_in = 1 + int(add_cross_score) + g
        self.decoder = KPDecoder(head_in, self.encoder.skip_dims,
                                 final_feats_dim + 2)

    def forward(self, pyr0: KPPyramid, pyr1: KPPyramid) -> KPFCNNOutputs:
        pyr = stack_pair(pyr0, pyr1)
        x, skips = self.encoder(pyr)                  # [2, N3, 8 * first]
        coarse = pyr.levels[-1]
        mask_c = coarse.mask
        f = torch.where(mask_c[..., None], self.bottle(x), 0.0)
        uncond = f
        f0, f1 = self.gnn(coarse.points[0], coarse.points[1], f[0], f[1],
                          mask_c[0], mask_c[1])
        g = torch.where(mask_c[..., None], self.proj_gnn(torch.stack([f0, f1])),
                        0.0)
        s = self.proj_score(g)                        # [2, N3, 1]

        nrm = _l2_normalize(g)
        temperature = torch.exp(self.epsilon) + 0.03
        inner = nrm[0] @ nrm[1].T                     # float32, TF32 off
        logits01 = torch.where(mask_c[1][None, :], inner / temperature, -1e9)
        logits10 = torch.where(mask_c[0][None, :], inner.T / temperature,
                               -1e9)
        sal = torch.stack([torch.softmax(logits01, dim=1) @ s[1],
                           torch.softmax(logits10, dim=1) @ s[0]])

        feat = g if self.condition_feature else uncond
        parts = [s, sal, feat] if self.add_cross_score else [s, feat]
        y = self.decoder(torch.cat(parts, dim=-1), skips, pyr)

        def heads(y, mask):
            feats = torch.where(mask[:, None],
                                _l2_normalize(y[:, :self.final_feats_dim]),
                                0.0)
            scores = [_regular_score(torch.clamp(torch.sigmoid(
                y[:, self.final_feats_dim + i]), 0, 1)) * mask
                for i in (0, 1)]
            return feats, scores[0], scores[1]

        feats0, overlap0, saliency0 = heads(y[0], pyr0.levels[0].mask)
        feats1, overlap1, saliency1 = heads(y[1], pyr1.levels[0].mask)
        return KPFCNNOutputs(feats0=feats0, feats1=feats1, overlap0=overlap0,
                             overlap1=overlap1, saliency0=saliency0,
                             saliency1=saliency1)


class KPFCNNDecoder(nn.Module):
    """Symmetric NPR decoder: (feats0, feats1, pyr0, pyr1) -> the two
    clouds' L2-normalised ``point_generation_ratio * 3`` offsets, [N0, r*3]
    each.  A second :class:`KPEncoder` (fed the features, not ones) and a
    :class:`KPDecoder`; its norms take joint statistics over both clouds,
    as the reference stacks them."""

    def __init__(self, in_dim: int = 32, point_generation_ratio: int = 4,
                 first_feats_dim: int = 256,
                 first_subsampling_dl: float = 0.3, conv_radius: float = 4.25,
                 kp_extent: float = 2.0, num_kernel_points: int = 15,
                 deformable: bool = False, modulated: bool = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.encoder = KPEncoder(
            in_dim, first_feats_dim, first_subsampling_dl, conv_radius,
            kp_extent, num_kernel_points, deformable, modulated,
            compute_dtype, ones_input=False)
        self.decoder = KPDecoder(self.encoder.out_dim, self.encoder.skip_dims,
                                 point_generation_ratio * 3)

    def forward(self, feats0, feats1, pyr0: KPPyramid, pyr1: KPPyramid):
        pyr = stack_pair(pyr0, pyr1)
        x, skips = self.encoder(pyr, torch.stack([feats0, feats1]))
        out = self.decoder(x, skips, pyr)
        out = torch.where(pyr.levels[0].mask[..., None], _l2_normalize(out),
                          0.0)
        return out[0], out[1]
