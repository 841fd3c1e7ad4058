"""Rigid-transform math of the port (the names of
``apr_tpu.geometry``)."""

from apr_torch.geometry.kabsch import kabsch
from apr_torch.geometry.robust import est_rigid_robust
from apr_torch.geometry.se3 import apply_transform, compose, inverse, \
    random_rigid_transform, rotation_angle_deg, rotation_from_euler

__all__ = [
    "apply_transform",
    "compose",
    "inverse",
    "rotation_from_euler",
    "random_rigid_transform",
    "rotation_angle_deg",
    "kabsch",
    "est_rigid_robust",
]
