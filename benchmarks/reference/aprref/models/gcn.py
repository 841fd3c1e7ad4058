# Frozen copy of apr_torch/models/gcn.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Overlap-attention GCN: DGCNN self-attention and cross-attention over the
two clouds' superpoints (port of ``apr_tpu/models/gcn.py``).

The coordinate kNN excludes padded points and the point itself (with a
``where``: adding ``inf * eye`` would make NaNs); attention logits mask
invalid keys with -1e9; instance norms use masked moments.  The head split
is in the reference's channel order ``(dk, h)``: channel ``i * h + j`` is
component i of head j.  Submodules carry the flax names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reference.aprref import tally
from reference.aprref.models.layers import MaskedInstanceNorm
from reference.aprref.models.resunet import Dense
from reference.aprref.ops.neighbors import _pairwise_sqdist, _smallest_k
from reference.aprref.ops.pooling import gather_rows


def _graph_features(coords, feats, mask, k):
    """DGCNN edge features [N, k, 2C]: (centre, neighbour - centre) over
    the k nearest other valid points by coordinates (ties to the lower
    index, as ``lax.top_k``)."""
    n = coords.shape[0]
    d2 = _pairwise_sqdist(coords, coords)
    d2 = torch.where(mask[None, :], d2, float("inf"))
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    d2 = torch.where(eye, float("inf"), d2)
    _, idx = _smallest_k(d2, k)                       # [N, k]
    nb = gather_rows(feats, idx)
    center = feats[:, None, :].expand(-1, k, -1)
    return torch.cat([center, nb - center], dim=-1)


class SelfAttention(nn.Module):
    """Two edge convs over the coordinate-kNN graph, then a 1x1 conv over
    the concatenated levels; replaces the features."""

    def __init__(self, feature_dim: int, k: int = 10):
        super().__init__()
        c = feature_dim
        self.k = k
        for name, (i, o) in (("conv1", (2 * c, c)), ("conv2", (2 * c, 2 * c)),
                             ("conv3", (4 * c, c))):
            setattr(self, name, Dense(i, o, use_bias=False))
            setattr(self, name + "_in", MaskedInstanceNorm(o))

    def _conv_in(self, name, x, mask):
        """Conv2d 1x1 + InstanceNorm2d + leaky(0.2) over x [N, k, C]: the
        norm takes per-channel statistics over (N, k) of valid points."""
        n, k, _ = x.shape
        h = getattr(self, name)(x).reshape(1, n * k, -1)
        h = getattr(self, name + "_in")(h, mask.repeat_interleave(k)[None])
        return F.leaky_relu(h.reshape(n, k, -1), negative_slope=0.2)

    def forward(self, coords, feats, mask):
        x0 = feats
        x1 = self._conv_in("conv1", _graph_features(coords, x0, mask, self.k),
                           mask).amax(dim=1)
        x2 = self._conv_in("conv2", _graph_features(coords, x1, mask, self.k),
                           mask).amax(dim=1)
        x3 = torch.cat([x0, x1, x2], dim=-1)[:, None, :]
        out = self._conv_in("conv3", x3, mask)[:, 0, :]
        return torch.where(mask[:, None], out, 0.0)


def _attend(q, k, v, src_mask, dk):
    """Multi-head attention with heads on the last axis: q [N, dk, h],
    k [M, dk, h], v [M, dv, h] -> [N, dv, h]."""
    tally.add("fwd_flops", 2 * q.shape[0] * k.shape[0] * q.shape[2]
              * (q.shape[1] + v.shape[1]))
    logits = torch.einsum("ndh,mdh->hnm", q, k) / (dk ** 0.5)
    logits = torch.where(src_mask[None, None, :], logits, -1e9)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("hnm,mdh->ndh", attn, v)


class CrossAttention(nn.Module):
    """Multi-head attention message, merged, then MLP([2d, 2d, d]) over
    concat(x, message) with instance norm and ReLU, plus the residual."""

    def __init__(self, feature_dim: int, num_heads: int = 4):
        super().__init__()
        d = feature_dim
        self.num_heads = num_heads
        self.q, self.k, self.v, self.merge = (Dense(d, d) for _ in range(4))
        self.mlp1 = Dense(2 * d, 2 * d)
        self.mlp1_in = MaskedInstanceNorm(2 * d)
        self.mlp2 = Dense(2 * d, d)

    def forward(self, x, source, x_mask, src_mask):
        d = x.shape[-1]
        h = self.num_heads
        dk = d // h
        msg = _attend(self.q(x).reshape(-1, dk, h),
                      self.k(source).reshape(-1, dk, h),
                      self.v(source).reshape(-1, dk, h), src_mask, dk)
        msg = self.merge(msg.reshape(-1, d))
        y = self.mlp1(torch.cat([x, msg], dim=-1))
        y = torch.relu(self.mlp1_in(y[None], x_mask[None])[0])
        out = x + self.mlp2(y)
        return torch.where(x_mask[:, None], out, 0.0)


class CrossAttentionCat(nn.Module):
    """Coordinate-augmented cross attention: the source coordinates ride as
    3 extra value channels per head, and the message gains (weighted
    position - query position) and its norm before the merge."""

    def __init__(self, feature_dim: int, num_heads: int = 4):
        super().__init__()
        d, h = feature_dim, num_heads
        self.num_heads = h
        self.q, self.k, self.v = (Dense(d, d) for _ in range(3))
        self.merge = Dense(d + 7 * h, d + 7 * h)
        self.mlp1 = Dense(2 * d + 7 * h, 2 * d)
        self.mlp1_in = MaskedInstanceNorm(2 * d)
        self.mlp2 = Dense(2 * d, d)

    def forward(self, x, source, x_coords, src_coords, x_mask, src_mask):
        d = x.shape[-1]
        h = self.num_heads
        dk = d // h
        v = self.v(source).reshape(-1, dk, h)
        vc = torch.cat([v, src_coords[:, :, None].expand(-1, -1, h)], dim=1)
        xo = _attend(self.q(x).reshape(-1, dk, h),
                     self.k(source).reshape(-1, dk, h), vc, src_mask, dk)
        aug1 = xo[:, dk:dk + 3, :] - x_coords[:, :, None]
        aug2 = torch.linalg.vector_norm(aug1, dim=1, keepdim=True)
        y = torch.cat([xo, aug1, aug2], dim=1)            # [N, dk + 7, h]
        msg = self.merge(y.reshape(-1, (dk + 7) * h))
        z = self.mlp1(torch.cat([x, msg], dim=-1))
        z = torch.relu(self.mlp1_in(z[None], x_mask[None])[0])
        out = x + self.mlp2(z)
        return torch.where(x_mask[:, None], out, 0.0)


class GCN(nn.Module):
    """Self / cross blocks in the order of ``nets``; a self block replaces
    both clouds' features, a cross block updates feats0 first and feats1
    attends to the UPDATED feats0 (the reference's sequential order)."""

    def __init__(self, feature_dim: int,
                 nets: Sequence[str] = ("self", "cross", "self"), k: int = 10,
                 num_heads: int = 4):
        super().__init__()
        self.nets = tuple(nets)
        for i, name in enumerate(self.nets):
            if name == "self":
                block = SelfAttention(feature_dim, k)
            elif name == "cross":
                block = CrossAttention(feature_dim, num_heads)
            elif name == "cross_cat":
                block = CrossAttentionCat(feature_dim, num_heads)
            else:
                raise ValueError(name)
            setattr(self, f"{name}_{i}", block)

    def forward(self, coords0, coords1, feats0, feats1, mask0, mask1):
        for i, name in enumerate(self.nets):
            block = getattr(self, f"{name}_{i}")
            if name == "self":
                feats0 = block(coords0, feats0, mask0)
                feats1 = block(coords1, feats1, mask1)
            elif name == "cross":
                feats0 = block(feats0, feats1, mask0, mask1)
                feats1 = block(feats1, feats0, mask1, mask0)
            else:
                feats0 = block(feats0, feats1, coords0, coords1, mask0, mask1)
                feats1 = block(feats1, feats0, coords1, coords0, mask1, mask0)
        return feats0, feats1
