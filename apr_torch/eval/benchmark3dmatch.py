"""3DMatch-style trajectory benchmark (port of
``apr_tpu/eval/benchmark3dmatch.py``, the reference's
Predator_APR/lib/benchmark.py): registration recall and precision per scene
from estimated and ground-truth trajectories and information matrices, by
the transformation error of Choi et al.,

    err^2 = (1 / |corr|) * xi^T * Info * xi,  xi = [t, q_xyz] of T_gt^-1 T_est

A pair counts as registered when err^2 < tau^2 (tau = 0.2 m); consecutive
fragments (odometry) are left out.  Host numpy, as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from apr_torch.utils.trajectory import CameraPose, read_info, read_trajectory


def transformation_error(
    t_est: np.ndarray, t_gt: np.ndarray, info: np.ndarray
) -> float:
    """Choi et al. RMSE^2 proxy (benchmark.py computes the same 6-vector)."""
    delta = np.linalg.inv(t_gt) @ t_est
    # quaternion-ish small-angle parameterization used by the benchmark
    r = delta[:3, :3]
    q = _rot_to_quat(r)
    if q[0] < 0:  # reference mat2quat convention: w >= 0
        q = -q
    # er = [t, +q_xyz] exactly like the reference computeTransformationErr
    # (Predator_APR/lib/benchmark.py:54-73) — the sign matters through the
    # info matrix's translation-rotation cross terms
    xi = np.concatenate([delta[:3, 3], q[1:]])
    den = max(info[0, 0], 1e-12)
    return float(xi @ info @ xi / den)


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    if w < 1e-6:
        # fall back to largest diagonal element branch
        i = int(np.argmax([r[0, 0], r[1, 1], r[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1 + r[i, i] - r[j, j] - r[k, k])) * 2
        q = np.zeros(4)
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
        return q
    x = (r[2, 1] - r[1, 2]) / (4 * w)
    y = (r[0, 2] - r[2, 0]) / (4 * w)
    z = (r[1, 0] - r[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


def benchmark_scene(
    est_poses: List[CameraPose],
    gt_poses: List[CameraPose],
    gt_infos: List[CameraPose],
    err2_threshold: float = 0.04,  # tau = 0.2 m
) -> Dict[str, float]:
    """Registration recall/precision of one scene."""
    gt_by_pair = {(p.meta[0], p.meta[1]): i for i, p in enumerate(gt_poses)}
    n_gt = sum(
        1 for p in gt_poses if p.meta[1] - p.meta[0] > 1
    )
    good, n_est_nonconsecutive = 0, 0
    for p in est_poses:
        i, j = p.meta[0], p.meta[1]
        if j - i <= 1:
            continue
        n_est_nonconsecutive += 1
        key = (i, j)
        if key not in gt_by_pair:
            continue
        gidx = gt_by_pair[key]
        err2 = transformation_error(
            p.pose, gt_poses[gidx].pose, gt_infos[gidx].pose
        )
        if err2 < err2_threshold:
            good += 1
    return dict(
        recall=good / max(n_gt, 1),
        precision=good / max(n_est_nonconsecutive, 1),
        n_gt=n_gt,
        n_good=good,
    )


def benchmark(est_dir: str, gt_dir: str, scenes: List[str]) -> Dict[str, float]:
    """Aggregate recall over scenes (benchmark.py `benchmark` driver)."""
    recalls, precisions = [], []
    for scene in scenes:
        est = read_trajectory(os.path.join(est_dir, scene, "est.log"))
        gt = read_trajectory(os.path.join(gt_dir, scene, "gt.log"))
        info = read_info(os.path.join(gt_dir, scene, "gt.info"))
        s = benchmark_scene(est, gt, info)
        recalls.append(s["recall"])
        precisions.append(s["precision"])
    return dict(
        recall=float(np.mean(recalls)),
        precision=float(np.mean(precisions)),
        per_scene=dict(zip(scenes, recalls)),
    )
