"""Plain sparse U-Nets, the SimpleNet family (port of
``apr_tpu/models/simpleunet.py``, the reference's
FCGF_APR/model/simpleunet.py).

L-level sparse U-Nets with one conv (+ norm + relu) per level, stride-2
downs, transposed-conv ups with skip concatenation, a 1x1 fusion conv and
a final 1x1 head.  Variants: SimpleNet{BN|IN}{|2|3}{|E}: 3, 4 or 5 levels,
E halving the channels.  The pyramid must have at least ``levels`` levels
(``len(config.capacities)``).  Norms are named as :class:`ResUNet2`'s:
``norm1`` .. ``normL`` down, ``normL_tr`` .. ``norm2_tr`` up.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from apr_torch.device import resolve_device
from apr_torch.models.layers import get_norm
from apr_torch.models.resunet import Dense, ResUNet2, SparseConv
from apr_torch.models.sparse import SparsePyramid


class SimpleUNet(nn.Module):
    """Call: model(feats [B, C0, in_channels], pyramid, stats_groups) ->
    [B, C0, out_channels]; train mode uses batch statistics."""

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128),
                 tr_channels: Sequence[int] = (32, 32, 64),
                 norm_type: str = "BN", bn_momentum: float = 0.1,
                 normalize_feature: bool = False, conv1_kernel_size: int = 3,
                 compute_dtype: Optional[str] = None,
                 ones_input: bool = False):
        super().__init__()
        ch, tr = tuple(channels), tuple(tr_channels)
        self.levels = len(ch)
        self.normalize_feature = normalize_feature
        self.conv1 = SparseConv(in_channels, ch[0], conv1_kernel_size ** 3,
                                compute_dtype=compute_dtype,
                                ones_input=ones_input)
        self.norm1 = get_norm(norm_type, ch[0], bn_momentum)
        for lvl in range(1, self.levels):
            setattr(self, f"conv{lvl + 1}",
                    SparseConv(ch[lvl - 1], ch[lvl], 27,
                               compute_dtype=compute_dtype))
            setattr(self, f"norm{lvl + 1}",
                    get_norm(norm_type, ch[lvl], bn_momentum))
        in_ch = ch[-1]
        for lvl in range(self.levels - 1, 0, -1):
            setattr(self, f"conv{lvl + 1}_tr",
                    SparseConv(in_ch, tr[lvl], 27,
                               compute_dtype=compute_dtype))
            setattr(self, f"norm{lvl + 1}_tr",
                    get_norm(norm_type, tr[lvl], bn_momentum))
            in_ch = tr[lvl] + ch[lvl - 1]
        self.conv1_tr = Dense(in_ch, tr[0], use_bias=False)
        self.final = Dense(tr[0], out_channels, use_bias=True)

    reset_parameters = ResUNet2.reset_parameters

    def forward(self, feats: torch.Tensor, pyramid: SparsePyramid,
                stats_groups: int = 1) -> torch.Tensor:
        if len(pyramid.levels) < self.levels:
            raise ValueError(f"pyramid has {len(pyramid.levels)} levels, "
                             f"the net needs {self.levels}")
        masks = [lv.mask for lv in pyramid.levels]
        sg = stats_groups
        x = torch.relu(self.norm1(self.conv1(feats, pyramid.conv1_map,
                                             masks[0]), masks[0], sg))
        outs = [x]
        for lvl in range(1, self.levels):
            x = getattr(self, f"conv{lvl + 1}")(
                x, pyramid.down_maps[lvl - 1], masks[lvl],
                table_t=pyramid.up_maps[lvl - 1], in_mask=masks[lvl - 1],
                reverse_k=False)
            x = torch.relu(getattr(self, f"norm{lvl + 1}")(x, masks[lvl],
                                                           sg))
            outs.append(x)
        for lvl in range(self.levels - 1, 0, -1):
            x = getattr(self, f"conv{lvl + 1}_tr")(
                x, pyramid.up_maps[lvl - 1], masks[lvl - 1],
                table_t=pyramid.down_maps[lvl - 1], in_mask=masks[lvl],
                reverse_k=False)
            x = torch.relu(getattr(self, f"norm{lvl + 1}_tr")(
                x, masks[lvl - 1], sg))
            x = torch.cat([x, outs[lvl - 1]], dim=-1)
        x = torch.relu(self.conv1_tr(x))
        x = torch.where(masks[0][..., None], self.final(x), 0.0)
        if self.normalize_feature:
            norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            x = torch.where(masks[0][..., None],
                            x / torch.clamp(norm, min=1e-12), 0.0)
        return x


_SIMPLE_PLANS = {
    "SimpleNet": dict(channels=(32, 64, 128), tr_channels=(32, 32, 64)),
    "SimpleNetE": dict(channels=(16, 32, 32), tr_channels=(16, 16, 32)),
    "SimpleNet2": dict(channels=(32, 64, 128, 256),
                       tr_channels=(32, 32, 64, 64)),
    "SimpleNet2E": dict(channels=(16, 32, 64, 128),
                        tr_channels=(16, 16, 32, 64)),
    "SimpleNet3": dict(channels=(32, 64, 128, 256, 512),
                       tr_channels=(32, 32, 64, 64, 128)),
    "SimpleNet3E": dict(channels=(16, 32, 64, 128, 256),
                        tr_channels=(16, 16, 32, 64, 128)),
}


def simplenet_names():
    """The reference's names: SimpleNet{BN|IN}{|2|3}{|E}."""
    return [f"SimpleNet{norm}{depth}{e}" for depth in ("", "2", "3")
            for norm in ("BN", "IN") for e in ("", "E")]


def make_simplenet(name: str, device="cuda", seed: int = 0,
                   **kwargs) -> SimpleUNet:
    """A SimpleNet variant by reference name ('SimpleNetBN2E' style), with
    random weights from ``seed``, on ``device``, in eval mode."""
    dev = resolve_device(device)
    base, norm = name, "BN"
    for n in ("BN", "IN"):
        if n in base:
            norm, base = n, base.replace(n, "")
    if base not in _SIMPLE_PLANS:
        raise ValueError(f"unknown SimpleNet variant {name!r}; known: "
                         f"{simplenet_names()}")
    model = SimpleUNet(norm_type=norm, **_SIMPLE_PLANS[base], **kwargs)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
