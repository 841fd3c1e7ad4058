# Frozen copy of apr_torch/models/kernel_points.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Kernel-point dispositions for KPConv (numpy; the port's own copy of
``apr_tpu/models/kernel_points.py`` and of its cached dispositions).

Kernel positions come from a repulsive-potential optimisation inside the
unit sphere (one point pinned at the centre), cached in ``dispositions/``;
``load_kernels`` scales them by the radius and, unless ``deterministic``,
rotates them at random about z and jitters them (sigma 0.01), as the
Predator reference does per instantiation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_CACHE_DIR = os.path.join(os.path.dirname(__file__), "dispositions")


def optimize_kernel_points(num_points: int, dimension: int = 3,
                           fixed: str = "center", num_iter: int = 10000,
                           seed: int = 42) -> np.ndarray:
    """Repulsion optimisation in the unit sphere; returns [K, dim] with the
    mean radius of the non-centre points at 1.  ``fixed='center'`` pins
    point 0 at the origin."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (num_points * 5, dimension))
    pts = pts[np.linalg.norm(pts, axis=1) < 1.0][:num_points]
    while len(pts) < num_points:
        extra = rng.uniform(-1, 1, (num_points, dimension))
        extra = extra[np.linalg.norm(extra, axis=1) < 1.0]
        pts = np.concatenate([pts, extra])[:num_points]
    if fixed in ("center", "verticals"):
        pts[0] = 0.0

    step = 1e-2
    for it in range(num_iter):
        diff = pts[:, None, :] - pts[None, :, :]
        d2 = (diff ** 2).sum(-1)
        np.fill_diagonal(d2, 1.0)
        # inverse-square repulsion plus a constant pull to the centre
        force = (diff / (d2[..., None] ** 1.5 + 1e-9)).sum(1)
        force -= pts * 3.0 * num_points / 4.0
        norm = np.linalg.norm(force, axis=1, keepdims=True)
        force = force / np.maximum(norm, 1.0) * np.minimum(norm, 1.0)
        if fixed == "center":
            force[0] = 0.0
        pts = pts + step * force
        if it % 1000 == 999:
            step *= 0.7

    r = np.linalg.norm(pts, axis=1)
    if fixed == "center":
        pts = pts / max(r[1:].mean(), 1e-9)
    else:
        pts = pts / max(r.mean(), 1e-9)
    return pts.astype(np.float32)


def load_kernels(radius: float, num_kpoints: int = 15, dimension: int = 3,
                 fixed: str = "center",
                 rng: Optional[np.random.Generator] = None,
                 deterministic: bool = False) -> np.ndarray:
    """Cached dispositions scaled by ``radius`` [K, dim]; unless
    ``deterministic``, a random z-rotation and sigma-0.01 jitter first."""
    cache = os.path.join(_CACHE_DIR,
                         f"k_{num_kpoints:03d}_{fixed}_{dimension}D.npy")
    if os.path.exists(cache):
        kp = np.load(cache)
    else:
        kp = optimize_kernel_points(num_kpoints, dimension, fixed)
        os.makedirs(_CACHE_DIR, exist_ok=True)
        np.save(cache, kp)

    if deterministic:
        return (radius * kp).astype(np.float32)

    rng = rng or np.random.default_rng()
    theta = rng.random() * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)
    kp = kp + rng.normal(scale=0.01, size=kp.shape)
    return (radius * kp @ r).astype(np.float32)
