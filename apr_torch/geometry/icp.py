"""Point-to-point ICP and the information matrix of the offline GT
preparation (port of ``apr_tpu/geometry/icp.py``: Open3D's
``registration_icp`` with max_corr_dist 0.2 and at most 200 iterations, and
``get_information_matrix_from_point_clouds``), which refine the KITTI
odometry poses into the ``icp/`` cache (``python -m
apr_torch.tools.prepare_icp_cache``).

Each correspondence search is one launch of kernel K2 on the card that
``device`` names (:class:`apr_torch.utils.pointcloud.NearestSearch`: a
float32 search, the picked pair's distance again in float64, the bound
strict).  The rest is the reference's float64 numpy in the reference's
order (the rmse before the ``n_ok < 3`` break, ``t = delta @ t``, the stop
when both relative changes fall below their thresholds after the first
iteration), so the card and the CPU give the same bits, and the port
equals the reference wherever the float32 search picks the float64
nearest.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from apr_torch.utils.pointcloud import NearestSearch


class ICPResult(NamedTuple):
    transformation: np.ndarray  # [4, 4]
    fitness: float              # matched fraction of source points
    inlier_rmse: float
    num_iterations: int         # correspondence searches (K2 launches)


def _best_fit_transform(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Kabsch in float64 with the ``diag(1, 1, sign(det))`` reflection
    fix, for the ICP inner step."""
    mu_s = src.mean(0)
    mu_t = tgt.mean(0)
    cov = (src - mu_s).T @ (tgt - mu_t)
    u, _, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = mu_t - r @ mu_s
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


def registration_icp(
    source: np.ndarray,
    target: np.ndarray,
    max_correspondence_distance: float = 0.2,
    init: Optional[np.ndarray] = None,
    max_iteration: int = 200,
    relative_fitness: float = 1e-6,
    relative_rmse: float = 1e-6,
    device="cuda",
) -> ICPResult:
    """Open3D registration_icp-compatible point-to-point ICP of ``source``
    [N, 3] onto ``target`` [M, 3]: stop when the changes of fitness and
    inlier RMSE both fall below the thresholds, or after ``max_iteration``
    searches."""
    t = np.eye(4) if init is None else np.array(init, dtype=np.float64)
    search = NearestSearch(target, device)
    src = source.astype(np.float64)

    prev_fitness, prev_rmse = 0.0, 0.0
    fitness, rmse = 0.0, 0.0
    it = 0
    for it in range(max_iteration):
        warped = src @ t[:3, :3].T + t[:3, 3]
        dist, idx = search.query(warped, max_correspondence_distance)
        ok = np.isfinite(dist)
        n_ok = int(ok.sum())
        fitness = n_ok / max(len(src), 1)
        rmse = float(np.sqrt((dist[ok] ** 2).mean())) if n_ok else 0.0
        if n_ok < 3:
            break
        delta = _best_fit_transform(warped[ok], target[idx[ok]])
        t = delta @ t
        if (
            it > 0
            and abs(fitness - prev_fitness) < relative_fitness
            and abs(rmse - prev_rmse) < relative_rmse
        ):
            break
        prev_fitness, prev_rmse = fitness, rmse

    return ICPResult(
        transformation=t, fitness=fitness, inlier_rmse=rmse,
        num_iterations=it + 1,
    )


def information_matrix(
    source: np.ndarray,
    target: np.ndarray,
    max_correspondence_distance: float,
    transformation: np.ndarray,
    device="cuda",
) -> np.ndarray:
    """Open3D get_information_matrix_from_point_clouds: the sum over
    correspondences of J^T J with J = [skew(-q) | I] for the target point q
    of each (one K2 launch).  ``source`` is warped as given, no cast."""
    warped = source @ transformation[:3, :3].T + transformation[:3, 3]
    dist, idx = NearestSearch(target, device).query(
        warped, max_correspondence_distance)
    ok = np.isfinite(dist)
    q = target[idx[ok]]
    n = len(q)
    g = np.zeros((6, 6))
    if n == 0:
        return g
    # J rows per point: [ [0, z, -y, 1, 0, 0], [-z, 0, x, 0, 1, 0],
    #                     [y, -x, 0, 0, 0, 1] ]
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    zeros = np.zeros(n)
    ones = np.ones(n)
    j0 = np.stack([zeros, z, -y, ones, zeros, zeros], 1)
    j1 = np.stack([-z, zeros, x, zeros, ones, zeros], 1)
    j2 = np.stack([y, -x, zeros, zeros, zeros, ones], 1)
    g = j0.T @ j0 + j1.T @ j1 + j2.T @ j2
    return g
