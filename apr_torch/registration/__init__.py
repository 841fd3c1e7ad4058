"""Correspondences, RANSAC and registration metrics of the port (the
names of ``apr_tpu.registration``)."""

from apr_torch.registration.matching import feature_nn_correspondences, \
    gt_correspondences, mutual_nn_correspondences
from apr_torch.registration.metrics import corr_dist, hit_ratio, \
    registration_errors, registration_success
from apr_torch.registration.ransac import RansacResult, ransac_pose

__all__ = [
    "feature_nn_correspondences",
    "mutual_nn_correspondences",
    "gt_correspondences",
    "ransac_pose",
    "RansacResult",
    "registration_errors",
    "registration_success",
    "hit_ratio",
    "corr_dist",
]
