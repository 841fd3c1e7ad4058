# Frozen copy of apr_torch/registration/metrics.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Registration metrics: RTE / RRE, success (RTE < 2 m and RRE < 5 deg,
the reference's criterion), the hit ratio of matched pairs and the clamped
mean distance of estimated against GT-warped points.  Port of
``apr_tpu/registration/metrics.py``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from reference.aprref.geometry.se3 import apply_transform, rotation_angle_deg


def registration_errors(t_est: torch.Tensor,
                        t_gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(RTE meters, RRE degrees)."""
    rte = torch.linalg.vector_norm(t_est[:3, 3] - t_gt[:3, 3])
    rre = rotation_angle_deg(t_est[:3, :3], t_gt[:3, :3])
    return rte, rre


def registration_success(t_est: torch.Tensor, t_gt: torch.Tensor,
                         rte_thresh: float = 2.0,
                         rre_thresh: float = 5.0) -> torch.Tensor:
    rte, rre = registration_errors(t_est, t_gt)
    return (rte < rte_thresh) & (rre < rre_thresh)


def hit_ratio(xyz0: torch.Tensor, xyz1_nn: torch.Tensor, t_gt: torch.Tensor,
              thresh: float, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Fraction of matched pairs within ``thresh`` after the GT warp."""
    d = torch.linalg.vector_norm(apply_transform(xyz0, t_gt) - xyz1_nn,
                                 dim=1)
    hit = (d < thresh).float()
    if mask is None:
        return hit.mean()
    w = mask.float()
    return (hit * w).sum() / torch.clamp(w.sum(), min=1.0)


def corr_dist(t_est: torch.Tensor, t_gt: torch.Tensor, xyz0: torch.Tensor,
              weight: Optional[torch.Tensor] = None,
              max_dist: float = 1.0) -> torch.Tensor:
    """Clamped mean distance between the est- and gt-warped copies of
    xyz0 (weighted when ``weight`` is given)."""
    d = torch.linalg.vector_norm(
        apply_transform(xyz0, t_est) - apply_transform(xyz0, t_gt), dim=1)
    d = torch.clamp(d, max=max_dist)
    if weight is None:
        return d.mean()
    return (d * weight).sum() / torch.clamp(weight.sum(), min=1e-9)
