"""Norm layers over sentinel-masked point sets.

With padded fixed-capacity buffers, padding rows must not enter any
statistic, so moments are masked.  The port of
``apr_tpu/models/layers.py``: ``MaskedBatchNorm`` runs in running-average
(eval) mode only in this slice; its batch-moment branch and the
``stats_groups`` pair fold come with training.
"""

from __future__ import annotations

import torch
from torch import nn


def masked_moments(x: torch.Tensor, mask: torch.Tensor, dims):
    """Mean and variance of x [..., C] over ``dims``, counting only rows
    where ``mask`` (x's shape without C) is True."""
    w = mask.to(x.dtype)[..., None]
    n = torch.clamp(w.sum(dim=dims), min=1.0)
    n_k = torch.clamp(w.sum(dim=dims, keepdim=True), min=1.0)
    mean_k = (x * w).sum(dim=dims, keepdim=True) / n_k
    var = (torch.square(x - mean_k) * w).sum(dim=dims) / n
    return mean_k.reshape(var.shape), var


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of x [..., N, C] with running stats.

    ``scale``/``bias`` are the affine parameters and the ``mean``/``var``
    buffers the running statistics, named as in the flax tree.
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm batch statistics (train mode) arrive with "
                "the training slice (slice 2); call .eval()")
        y = (x - self.mean) * torch.reciprocal(
            torch.sqrt(self.var + self.epsilon))
        y = y * self.scale + self.bias
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

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        axis = x.dim() - 2  # the points axis
        mean, var = masked_moments(x, mask, (axis,))
        mean = mean.unsqueeze(axis)
        var = var.unsqueeze(axis)
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + self.epsilon))
        if self.scale is not None:
            y = y * self.scale + self.bias
        return torch.where(mask[..., None], y, 0.0)
