"""Registration metrics: RTE / RRE and success (RTE < 2 m and RRE < 5 deg,
the reference's criterion).  Port of ``apr_tpu/registration/metrics.py``."""

from __future__ import annotations

from typing import Tuple

import torch

from apr_torch.geometry.se3 import rotation_angle_deg


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
