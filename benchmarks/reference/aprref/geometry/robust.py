# Frozen copy of apr_torch/geometry/robust.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Robust IRLS rigid-pose refinement (port of
``apr_tpu/geometry/robust.py``, the reference's est_quad_linear_robust):
20 iterations of weighted small-angle linearized least squares; the 6-dof
update [rx, ry, rz, tx, ty, tz] solves the 6x6 normal equations, and the
weights follow ``par / (residual + par)`` with ``par`` halved every 5
iterations.  Rows with zero initial weight (the padding of fixed-capacity
correspondence buffers) stay excluded on every iteration.
"""

from __future__ import annotations

from typing import Optional

import torch

from reference.aprref.geometry.se3 import make_transform, rotation_from_euler


def _build_normal_system(pts0, pts1, w2):
    """(A^T A, A^T b) of the weighted small-angle system; w2 is the squared
    weight per point."""
    zeros, ones = torch.zeros_like(pts0[:, 0]), torch.ones_like(pts0[:, 0])
    x, y, z = pts0[:, 0], pts0[:, 1], pts0[:, 2]
    # rows of A for residual components (x, y, z), columns [rx ry rz tx ty tz]
    a0 = torch.stack([zeros, z, -y, ones, zeros, zeros], 1)
    a1 = torch.stack([-z, zeros, x, zeros, ones, zeros], 1)
    a2 = torch.stack([y, -x, zeros, zeros, zeros, ones], 1)
    wa0, wa1, wa2 = (a * w2[:, None] for a in (a0, a1, a2))
    ata = a0.T @ wa0 + a1.T @ wa1 + a2.T @ wa2
    atb = (wa0.T @ (pts1[:, 0] - x) + wa1.T @ (pts1[:, 1] - y)
           + wa2.T @ (pts1[:, 2] - z))
    return ata, atb


def est_rigid_robust(pts0: torch.Tensor, pts1: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     num_iters: int = 20,
                     par_init: float = 1.0) -> torch.Tensor:
    """Robust rigid transform [4, 4] aligning pts0 -> pts1 (both [N, 3]);
    ``weights`` [N] are the initial confidences."""
    if weights is None:
        weights = torch.ones_like(pts0[:, 0])
    support = (weights > 0).to(pts0.dtype)
    eye6 = 1e-9 * torch.eye(6, dtype=pts0.dtype, device=pts0.device)
    pts0_curr, weight, par = pts0, weights, par_init
    trans = torch.eye(4, dtype=pts0.dtype, device=pts0.device)
    for i in range(num_iters):
        if i > 0 and i % 5 == 0:
            par = par * 0.5
        ata, atb = _build_normal_system(pts0_curr, pts1, weight * weight)
        x = torch.linalg.solve(ata + eye6, atb)
        trans_curr = make_transform(rotation_from_euler(x[:3]), x[3:])
        pts0_curr = pts0_curr @ trans_curr[:3, :3].T + trans_curr[:3, 3]
        weight = support * par / (
            torch.linalg.vector_norm(pts0_curr - pts1, dim=1) + par)
        trans = trans_curr @ trans
    return trans
