# Frozen copy of apr_torch/geometry/se3.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""SE(3) rigid-transform math, 4x4 homogeneous convention (port of
``apr_tpu/geometry/se3.py``)."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def apply_transform(points: torch.Tensor,
                    transform: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to points [..., 3]."""
    return points @ transform[:3, :3].T + transform[:3, 3]


def rotation_angle_deg(r_est: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation deviation in degrees:
    arccos((trace(R_est^T R_gt) - 1) / 2)."""
    cos = (torch.trace(r_est.T @ r_gt) - 1.0) * 0.5
    return torch.arccos(torch.clamp(cos, -1.0, 1.0)) * (180.0 / math.pi)


def translation_error(t_est: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """RTE: Euclidean distance between translation vectors."""
    return torch.linalg.vector_norm(t_est - t_gt)


def rotation_from_euler(angles: torch.Tensor) -> torch.Tensor:
    """R = Rz(c) @ Ry(b) @ Rx(a) for angles [a, b, c] (radians)."""
    a, b, c = angles[0], angles[1], angles[2]
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rx = mat([[one, zero, zero], [zero, a.cos(), -a.sin()],
              [zero, a.sin(), a.cos()]])
    ry = mat([[b.cos(), zero, b.sin()], [zero, one, zero],
              [-b.sin(), zero, b.cos()]])
    rz = mat([[c.cos(), -c.sin(), zero], [c.sin(), c.cos(), zero],
              [zero, zero, one]])
    return rz @ ry @ rx


def make_transform(rotation: torch.Tensor,
                   translation: torch.Tensor) -> torch.Tensor:
    t = torch.eye(4, dtype=rotation.dtype, device=rotation.device)
    t[:3, :3] = rotation
    t[:3, 3] = translation
    return t


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Transform equivalent to applying ``b`` first, then ``a``."""
    return a @ b


def inverse(transform: torch.Tensor) -> torch.Tensor:
    r = transform[:3, :3]
    t = transform[:3, 3]
    return make_transform(r.T, -r.T @ t)


def random_rigid_transform(generator: Optional[torch.Generator] = None,
                           rotation_range_deg: float = 360.0
                           ) -> torch.Tensor:
    """Random rotation about the origin (no translation): Euler angles
    uniform in +-range/2 from three float32 uniforms of ``generator`` (the
    reference's ``sample_random_trans`` with a zero pivot)."""
    u = torch.rand(3, generator=generator, dtype=torch.float32)
    angles = (u - 0.5) * np.float32(rotation_range_deg * math.pi / 180.0)
    return make_transform(rotation_from_euler(angles),
                          torch.zeros(3, dtype=torch.float32))
