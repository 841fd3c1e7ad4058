"""SE(3) rigid-transform math, 4x4 homogeneous convention (port of
``apr_tpu/geometry/se3.py``: the functions the registration eval uses)."""

from __future__ import annotations

import math

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
