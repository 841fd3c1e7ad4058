# Frozen copy of apr_torch/geometry/kabsch.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Rigid alignment: weighted Kabsch via SVD, and the Newton-polar fit that
RANSAC runs per hypothesis (port of ``apr_tpu/geometry/kabsch.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) + b * (f * g - d * i) + c * (d * h - e * g)


def _homogeneous(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def kabsch(source: torch.Tensor, target: torch.Tensor,
           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Best-fit rigid transform T (4x4) minimizing
    sum_i w_i ||T src_i - tgt_i||^2; source/target [N, 3], weights [N]."""
    if weights is None:
        weights = torch.ones(source.shape[0], dtype=source.dtype,
                             device=source.device)
    w = weights / torch.clamp(weights.sum(), min=1e-12)
    mu_s = (source * w[:, None]).sum(dim=0)
    mu_t = (target * w[:, None]).sum(dim=0)
    cov = ((source - mu_s) * w[:, None]).T @ (target - mu_t)   # [3, 3]
    u, _, vt = torch.linalg.svd(cov)
    # proper rotation: flip the axis of least significance if det < 0
    d = torch.sign(torch.linalg.det(vt.T @ u.T))
    diag = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    r = vt.T @ diag @ u.T
    return _homogeneous(r, mu_t - r @ mu_s)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 3, 3] (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    return co / det[..., None, None]


def kabsch_fast(source: torch.Tensor, target: torch.Tensor,
                newton_iters: int = 8) -> torch.Tensor:
    """Rigid fit of source/target [..., n, 3] via a scaled Newton polar
    decomposition, X <- (gamma X + X^-T / gamma) / 2, instead of an SVD.

    A reflective covariance (det < 0, degenerate samples) gives an orthogonal
    matrix with det -1, not a rotation: callers gate on det > 0.
    """
    n = source.shape[-2]
    mu_s = source.mean(dim=-2, keepdim=True)
    mu_t = target.mean(dim=-2, keepdim=True)
    cov = (source - mu_s).transpose(-1, -2) @ (target - mu_t) / n
    x = cov.transpose(-1, -2)  # polar(cov^T) maps source -> target
    scale = torch.sqrt(torch.abs(_det3(x))) ** (2.0 / 3.0)
    x = x / torch.clamp(scale, min=1e-12)[..., None, None]
    for _ in range(newton_iters):
        x_inv_t = _inv3(x).transpose(-1, -2)
        gamma = (torch.linalg.matrix_norm(x_inv_t)
                 / torch.clamp(torch.linalg.matrix_norm(x), min=1e-20)) ** 0.5
        gamma = gamma[..., None, None]
        x = 0.5 * (gamma * x + x_inv_t / gamma)
    t = mu_t[..., 0, :] - (x @ mu_s.transpose(-1, -2))[..., 0]
    return _homogeneous(x, t)
