# Frozen copy of apr_torch/models/mlp.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""NPR generative decoder MLPs (port of ``apr_tpu/models/mlp.py``).

A small per-point MLP maps a feature vector to ``point_generation_ratio * 3``
non-negative coordinate offsets, with the reference's layer order: Linear ->
ReLU -> BatchNorm per hidden layer, then a final Linear -> ReLU (and, in the
Predator flavour, a final BatchNorm).  Submodules are named as in the flax
tree (``Dense_i``, ``MaskedBatchNorm_i``), so the bridge maps names one to
one.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from reference.aprref import tally
from reference.aprref.device import resolve_device
from reference.aprref.models.layers import MaskedBatchNorm
from reference.aprref.models.resunet import Dense


class GenerativeMLP(nn.Module):
    """Per-point offset generator; call with (feats [..., C], mask [...])."""

    def __init__(self, in_channels: int, hidden: Sequence[int] = (512, 256),
                 out_points: int = 6, bn_momentum: float = 0.1,
                 final_bn: bool = False):
        super().__init__()
        widths = [in_channels] + list(hidden) + [out_points * 3]
        self.n_dense = len(widths) - 1
        for i in range(self.n_dense):
            setattr(self, f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        n_bn = len(hidden) + int(final_bn)
        self.n_bn = n_bn
        for i in range(n_bn):
            setattr(self, f"MaskedBatchNorm_{i}",
                    MaskedBatchNorm(widths[i + 1], momentum=bn_momentum))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernels, zero biases (CPU generator; call before
        moving the module)."""
        for i in range(self.n_dense):
            d = getattr(self, f"Dense_{i}")
            d.kernel.normal_(0.0, math.sqrt(1.0 / d.kernel.shape[0]),
                             generator=generator)
            d.bias.zero_()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # the dense layers' work over the valid points only
        tally.add("fwd_flops", 2 * mask.sum() * sum(
            getattr(self, f"Dense_{i}").kernel.numel()
            for i in range(self.n_dense)))
        with tally.paused():
            for i in range(self.n_dense):
                x = torch.relu(getattr(self, f"Dense_{i}")(x))
                if i < self.n_bn:
                    x = getattr(self, f"MaskedBatchNorm_{i}")(x, mask)
        return torch.where(mask[..., None], x, 0.0)


# Shipped hidden-layer plans (FCGF_APR/model/mlp.py variants).
MLP_VARIANTS = {
    "GenerativeMLP": (512, 128),
    "GenerativeMLP_98": (512, 256),
    "GenerativeMLP_54": (32, 16),
    "GenerativeMLP_4": (16,),
    "GenerativeMLP_11_10_9": (2048, 1024, 512),
}


def make_generative_mlp(name: str, out_points: int, in_channels: int,
                        bn_momentum: float = 0.1, final_bn: bool = False,
                        device="cuda", seed: int = 0) -> GenerativeMLP:
    """A shipped generator by reference name, with random weights from
    ``seed``, on ``device``, in eval mode."""
    dev = resolve_device(device)
    model = GenerativeMLP(in_channels, MLP_VARIANTS[name], out_points,
                          bn_momentum, final_bn)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
