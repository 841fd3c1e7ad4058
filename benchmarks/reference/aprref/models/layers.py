# Frozen copy of apr_torch/models/layers.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref, trimmed to what the cells run;
# see reference/aprref/__init__.py.
"""Norm layers over sentinel-masked point sets.

With padded fixed-capacity buffers, padding rows must not enter any
statistic, so moments are masked.  The port of
``apr_tpu/models/layers.py``.  Running stats follow the torch convention
(new = (1 - momentum) * old + momentum * batch) with the BIASED masked
variance, as the reference's flax norm keeps them.
"""

from __future__ import annotations

import torch
from torch import nn


def masked_moments(x: torch.Tensor, mask: torch.Tensor, dims):
    """Mean and variance of x [..., C] over ``dims``, counting only rows
    where ``mask`` (x's shape without C) is True (a two-pass variance)."""
    w = mask.to(x.dtype)[..., None]
    total = (x * w).sum(dim=dims, keepdim=True)
    count = w.sum(dim=dims, keepdim=True)
    n_k = torch.clamp(count, min=1.0)
    mean_k = total / n_k
    sq = (torch.square(x - mean_k) * w).sum(dim=dims)
    var = sq / n_k.squeeze(tuple(dims))
    return mean_k.reshape(var.shape), var


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of x [..., N, C] with running stats.

    ``scale``/``bias`` are the affine parameters and the ``mean``/``var``
    buffers the running statistics, named as in the flax tree.  In train
    mode the batch moments normalise and the buffers are updated in place
    (under no_grad).  ``stats_groups=G`` treats the leading batch axis as G
    interleaved stat groups (row i in group i % G): per-group moments and
    normalisation, and the momentum updates applied group after group, as
    G sequential forwards of the ungrouped norm would (the pair fold).
    """

    def __init__(self, channels: int, momentum: float = 0.1,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    @torch.no_grad()
    def _update(self, means, variances) -> None:
        m = self.momentum
        rm, rv = self.mean, self.var
        for mean, var in zip(means, variances):
            rm = (1.0 - m) * rm + m * mean
            rv = (1.0 - m) * rv + m * var
        self.mean.copy_(rm)
        self.var.copy_(rv)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                stats_groups: int = 1) -> torch.Tensor:
        if self.training:
            g, c = stats_groups, x.shape[-1]
            x = x.reshape((x.shape[0] // g, g) + x.shape[1:])
            mg = mask.reshape((mask.shape[0] // g, g) + mask.shape[1:])
            mean, var = masked_moments(
                x, mg, (0,) + tuple(range(2, x.dim() - 1)))     # [g, C]
            self._update(mean.detach(), var.detach())
            shape = (1, g) + (1,) * (x.dim() - 3) + (c,)
            mean, var = mean.reshape(shape), var.reshape(shape)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.epsilon))
        y = (y * self.scale + self.bias).reshape(mask.shape + y.shape[-1:])
        return torch.where(mask[..., None], y, 0.0)


class MaskedInstanceNorm(nn.Module):
    """InstanceNorm: per-cloud, per-channel stats over the valid points of
    x [B, N, C] (no running stats, so train and eval agree)."""

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.epsilon = epsilon
        if affine:
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                stats_groups: int = 1) -> torch.Tensor:
        # per-cloud stats already: the pair fold's grouping changes nothing
        axis = x.dim() - 2  # the points axis
        mean, var = masked_moments(x, mask, (axis,))
        mean = mean.unsqueeze(axis)
        var = var.unsqueeze(axis)
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.epsilon))
        if self.scale is not None:
            y = y * self.scale + self.bias
        return torch.where(mask[..., None], y, 0.0)


def get_norm(norm_type: str, channels: int, momentum: float = 0.1
             ) -> nn.Module:
    """The reference's get_norm (FCGF_APR/model/common.py:4-10): "BN" a
    :class:`MaskedBatchNorm`, "IN" a :class:`MaskedInstanceNorm`."""
    if norm_type == "BN":
        return MaskedBatchNorm(channels, momentum=momentum)
    if norm_type == "IN":
        return MaskedInstanceNorm(channels)
    raise ValueError(f"Type {norm_type}, not defined")
