"""Sparse-voxel ResUNet encoder family (the FCGF path).

The port of ``apr_tpu/models/resunet.py``: a 4-level sparse U-Net (conv1
with a configurable kernel and a residual BasicBlock per level, three
stride-2 downsamplings, transposed-conv upsamplings with skip
concatenation, a 1x1 fusion conv, a final 1x1 conv with bias, optional L2
feature normalization) over padded [B, C_l, F] buffers with masks.  Every
shipped channel plan is kept.  Weights use the reference layouts: sparse
conv kernels [K, Ci, Co], dense kernels [Ci, Co].  With autograd on, every
gathered conv goes through :func:`sparse_conv_adjoint`, whose backward
gathers over the transpose kernel map; ``forward(..., stats_groups=2)`` in
train mode is the pair-folded encoder (per-side batch-norm statistics).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from apr_torch.device import resolve_device
from apr_torch.models.layers import get_norm
from apr_torch.models.sparse import SparsePyramid, fold_table, \
    sparse_conv_adjoint


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return None if name in (None, "float32") else getattr(torch, name)


class SparseConv(nn.Module):
    """Sparse convolution over a precomputed kernel-map table.

    ``ones_input=True``: the caller guarantees feats == mask (1 on real
    voxels, 0 on padding), FCGF's input convention.  The gathered [N, K, 1]
    matrix is then exactly the validity pattern of the table, so the conv is
    ``(table != sentinel) @ W`` with no gather.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int, use_bias: bool = False,
                 compute_dtype: Optional[str] = None,
                 ones_input: bool = False):
        super().__init__()
        if ones_input and in_channels != 1:
            raise ValueError("ones_input requires in_channels == 1")
        self.compute_dtype = _dtype(compute_dtype)
        self.ones_input = ones_input
        self.kernel = nn.Parameter(
            torch.empty(kernel_volume, in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, feats: torch.Tensor, table: torch.Tensor,
                out_mask: torch.Tensor, table_t: Optional[torch.Tensor] = None,
                in_mask: Optional[torch.Tensor] = None,
                reverse_k: bool = True) -> torch.Tensor:
        """``table_t``: the transpose kernel map [B, N_in, K] for the
        backward (default ``table`` with reversed offsets: the same-level
        case); it is folded only when a backward runs."""
        b, n_in, ci = feats.shape
        n_out, k = table.shape[1:]
        cd = self.compute_dtype
        if self.ones_input:
            valid = (table < n_in).reshape(b * n_out, k)
            w = self.kernel.reshape(k, -1)
            if cd is not None:
                w = w.to(cd)
            out = torch.matmul(valid.float(), w.float())
            out = torch.where(out_mask[..., None],
                              out.reshape(b, n_out, -1), 0.0)
        else:
            if in_mask is None:
                in_mask = out_mask
            out = sparse_conv_adjoint(
                feats.reshape(b * n_in, ci), fold_table(table, n_in),
                table_t, self.kernel, out_mask.reshape(-1),
                in_mask.reshape(-1), reverse_k, cd,
            ).reshape(b, n_out, -1)
        if self.bias is not None:
            out = torch.where(out_mask[..., None], out + self.bias, 0.0)
        return out


class Dense(nn.Module):
    """Per-voxel linear layer with the reference's [Ci, Co] kernel layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.kernel)
        return out if self.bias is None else out + self.bias


class BasicBlock(nn.Module):
    """Residual block: two 3^3 sparse convs + skip."""

    def __init__(self, channels: int, norm_type: str = "BN",
                 bn_momentum: float = 0.1,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.conv1 = SparseConv(channels, channels, 27, use_bias=True,
                                compute_dtype=compute_dtype)
        self.norm1 = get_norm(norm_type, channels, bn_momentum)
        self.conv2 = SparseConv(channels, channels, 27,
                                compute_dtype=compute_dtype)
        self.norm2 = get_norm(norm_type, channels, bn_momentum)

    def forward(self, feats, table, mask, stats_groups: int = 1):
        out = torch.relu(self.norm1(self.conv1(feats, table, mask), mask,
                                    stats_groups))
        out = self.norm2(self.conv2(out, table, mask), mask, stats_groups)
        out = torch.relu(out + feats)
        return torch.where(mask[..., None], out, 0.0)


class ResUNet2(nn.Module):
    """4-level sparse U-Net; returns per-voxel features at level 0.

    Call: model(feats [B, C0, in_channels], pyramid (batched SparsePyramid),
    stats_groups) -> [B, C0, out_channels].  In train mode the norms use
    batch statistics, per interleaved group of ``stats_groups`` clouds.
    """

    levels = 4

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 256),
                 tr_channels: Sequence[int] = (32, 64, 64, 128),
                 norm_type: str = "BN", block_norm_type: str = "BN",
                 bn_momentum: float = 0.1, normalize_feature: bool = False,
                 conv1_kernel_size: int = 5,
                 compute_dtype: Optional[str] = None,
                 ones_input: bool = False):
        super().__init__()
        ch, tr = tuple(channels), tuple(tr_channels)
        self.normalize_feature = normalize_feature
        self.conv1 = SparseConv(in_channels, ch[0], conv1_kernel_size ** 3,
                                compute_dtype=compute_dtype,
                                ones_input=ones_input)
        self.norm1 = get_norm(norm_type, ch[0], bn_momentum)
        self.block1 = BasicBlock(ch[0], block_norm_type, bn_momentum,
                                 compute_dtype)
        for lvl in range(1, 4):
            setattr(self, f"conv{lvl + 1}",
                    SparseConv(ch[lvl - 1], ch[lvl], 27,
                               compute_dtype=compute_dtype))
            setattr(self, f"norm{lvl + 1}",
                    get_norm(norm_type, ch[lvl], bn_momentum))
            setattr(self, f"block{lvl + 1}",
                    BasicBlock(ch[lvl], block_norm_type, bn_momentum,
                               compute_dtype))
        in_ch = ch[3]
        for lvl in range(3, 0, -1):
            setattr(self, f"conv{lvl + 1}_tr",
                    SparseConv(in_ch, tr[lvl], 27,
                               compute_dtype=compute_dtype))
            setattr(self, f"norm{lvl + 1}_tr",
                    get_norm(norm_type, tr[lvl], bn_momentum))
            setattr(self, f"block{lvl + 1}_tr",
                    BasicBlock(tr[lvl], block_norm_type, bn_momentum,
                               compute_dtype))
            in_ch = tr[lvl] + ch[lvl - 1]
        self.conv1_tr = Dense(in_ch, tr[0], use_bias=False)
        self.final = Dense(tr[0], out_channels, use_bias=True)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (a CPU generator; call before
        moving the module): kaiming-uniform over the K*Ci fan-in for sparse
        convs, lecun-normal for dense kernels, zero biases, identity norms."""
        for m in self.modules():
            if isinstance(m, SparseConv):
                fan_in = m.kernel.shape[0] * m.kernel.shape[1]
                bound = math.sqrt(6.0 / fan_in)
                m.kernel.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, Dense):
                m.kernel.normal_(0.0, math.sqrt(1.0 / m.kernel.shape[0]),
                                 generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()

    def forward(self, feats: torch.Tensor, pyramid: SparsePyramid,
                stats_groups: int = 1) -> torch.Tensor:
        masks = [lv.mask for lv in pyramid.levels]
        sg = stats_groups
        out_s1 = self.norm1(self.conv1(feats, pyramid.conv1_map, masks[0]),
                            masks[0], sg)
        out_s1 = self.block1(out_s1, pyramid.same_maps[0], masks[0], sg)
        skips = [out_s1]
        outs = [torch.relu(out_s1)]
        for lvl in range(1, 4):
            x = getattr(self, f"conv{lvl + 1}")(
                outs[-1], pyramid.down_maps[lvl - 1], masks[lvl],
                table_t=pyramid.up_maps[lvl - 1], in_mask=masks[lvl - 1],
                reverse_k=False)
            x = getattr(self, f"norm{lvl + 1}")(x, masks[lvl], sg)
            x = getattr(self, f"block{lvl + 1}")(
                x, pyramid.same_maps[lvl], masks[lvl], sg)
            skips.append(x)
            outs.append(torch.relu(x))

        out = outs[-1]
        for lvl in range(3, 0, -1):
            x = getattr(self, f"conv{lvl + 1}_tr")(
                out, pyramid.up_maps[lvl - 1], masks[lvl - 1],
                table_t=pyramid.down_maps[lvl - 1], in_mask=masks[lvl],
                reverse_k=False)
            x = getattr(self, f"norm{lvl + 1}_tr")(x, masks[lvl - 1], sg)
            x = getattr(self, f"block{lvl + 1}_tr")(
                x, pyramid.same_maps[lvl - 1], masks[lvl - 1], sg)
            # skip concat (ME.cat) with the encoder output of this level
            out = torch.cat([torch.relu(x), skips[lvl - 1]], dim=-1)

        out = torch.relu(self.conv1_tr(out))
        out = torch.where(masks[0][..., None], self.final(out), 0.0)
        if self.normalize_feature:
            norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            out = out / torch.clamp(norm, min=1e-12)
            out = torch.where(masks[0][..., None], out, 0.0)
        return out


# --- shipped channel plans ---

_VARIANTS = {
    "ResUNetBN2": dict(channels=(32, 64, 128, 256), tr_channels=(32, 64, 64, 128)),
    "ResUNetBN2B": dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 64)),
    "ResUNetBN2C": dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 64, 128)),
    "ResUNetBN2D": dict(channels=(32, 64, 128, 256), tr_channels=(64, 64, 128, 128)),
    "ResUNetBN2E": dict(channels=(128, 128, 128, 256), tr_channels=(64, 128, 128, 128)),
    "ResUNetFatBN": dict(channels=(32, 64, 128, 256), tr_channels=(128, 128, 128, 256)),
}


def make_resunet(name: str, device="cuda", seed: int = 0,
                 **kwargs) -> ResUNet2:
    """A shipped ResUNet variant by reference name, with random weights from
    ``seed``, on ``device``, in eval mode (a trainer switches it to train
    mode for its steps)."""
    dev = resolve_device(device)
    base = name.replace("IN2", "BN2")
    block_norm = "IN" if "IN2" in name else "BN"
    if base not in _VARIANTS:
        raise ValueError(
            f"unknown ResUNet variant {name!r}; known: "
            f"{sorted(_VARIANTS)} (+ IN2 spellings)")
    plan = _VARIANTS[base]
    model = ResUNet2(channels=plan["channels"],
                     tr_channels=plan["tr_channels"], norm_type="BN",
                     block_norm_type=block_norm, **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
