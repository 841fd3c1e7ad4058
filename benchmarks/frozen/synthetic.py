# Frozen copy of apr_torch/data/synthetic.py at commit bc3af59: the
# traffic generator of the benchmark (synthetic_pair, pad_points), kept
# here so that a change to the port cannot change the traffic.
"""Synthetic LiDAR-like scenes for tests and benchmarks (numpy only).

These generators produce structured scenes (ground plane + walls + scattered
boxes, ring-style sampling) whose geometry is rich enough for registration
and reconstruction to be meaningful, with known ground-truth poses and a
denser "aggregated" cloud playing the APC role.

The benchmark's copy keeps the scene, view and pair generators and
``pad_points``; the KITTI-tree writers of the original are left out.
"""

from __future__ import annotations

import numpy as np


def _scene_surface_points(rng: np.random.Generator, n: int, extent: float):
    """Sample points from a synthetic urban-ish scene (planes + boxes)."""
    out = []
    # ground plane with gentle undulation
    n_ground = n // 3
    xy = rng.uniform(-extent, extent, (n_ground, 2))
    z = 0.1 * np.sin(xy[:, 0] * 0.15) + 0.05 * np.cos(xy[:, 1] * 0.2)
    out.append(np.column_stack([xy, z]))
    # a few walls
    n_wall = n // 3
    walls = []
    n_w = 6
    for _ in range(n_w):
        cx, cy = rng.uniform(-extent, extent, 2)
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(5, 25)
        height = rng.uniform(2, 6)
        t = rng.uniform(-0.5, 0.5, (n_wall // n_w, 1)) * length
        h = rng.uniform(0, 1, (n_wall // n_w, 1)) * height
        d = np.array([np.cos(ang), np.sin(ang)])
        pts = np.column_stack(
            [cx + t[:, 0] * d[0], cy + t[:, 0] * d[1], h[:, 0]]
        )
        walls.append(pts)
    out.append(np.concatenate(walls))
    # scattered boxes (cars / poles)
    n_box = n - n_ground - len(out[1])
    boxes = []
    n_b = 20
    for _ in range(n_b):
        c = np.array([*rng.uniform(-extent, extent, 2), rng.uniform(0.2, 1.0)])
        size = rng.uniform(0.5, 3.0, 3)
        pts = c + rng.uniform(-0.5, 0.5, (max(n_box // n_b, 1), 3)) * size
        boxes.append(pts)
    out.append(np.concatenate(boxes))
    pts = np.concatenate(out)[:n]
    return pts.astype(np.float32)


def _lidar_depth_buffer(
    scene: np.ndarray,
    sensor: np.ndarray,
    rng: np.random.Generator,
    max_range: float,
    n_rings: int = 48,
    az_bins: int = 2048,
    elev_lo: float = -0.42,   # ~-24 deg
    elev_hi: float = 0.07,    # ~+4 deg
    noise: float = 0.01,
) -> np.ndarray:
    """Spinning-LiDAR scan structure via a spherical depth buffer.

    Real scans are NOT thinned uniform samples: beams live on discrete
    elevation RINGS swept in azimuth, the nearest surface per beam wins
    (self-occlusion), and ring spacing makes density fall off with range
    geometrically.  This models all three at once: bin each visible scene
    point by (ring, azimuth) and keep the nearest point per bin — a
    57k-cell spherical z-buffer.  Range-dependent density then EMERGES from
    ring divergence instead of being painted on with Bernoulli thinning,
    and walls genuinely shadow what is behind them.  This is the round-5
    A/B arm testing the hypothesis the uniform-proxy null left open: that
    APG's multi-viewpoint APC compensates precisely for ring/occlusion
    structure (docs/PERF.md A/B section; reference README.md:6 claim).
    """
    rel = scene - sensor[None, :]
    r = np.linalg.norm(rel, axis=1)
    keep = (r < max_range) & (r > 1.5)
    rel, r = rel[keep], r[keep]
    az = np.arctan2(rel[:, 1], rel[:, 0])
    elev = np.arcsin(np.clip(rel[:, 2] / r, -1.0, 1.0))
    ring_f = (elev - elev_lo) / (elev_hi - elev_lo) * (n_rings - 1)
    ring = np.rint(ring_f).astype(np.int64)
    # a beam only hits what lies within ~1/3 ring spacing of its elevation
    on_ring = (np.abs(ring_f - ring) < 0.34) & (ring >= 0) & (ring < n_rings)
    rel, r, az, ring = rel[on_ring], r[on_ring], az[on_ring], ring[on_ring]
    azb = np.floor((az + np.pi) / (2 * np.pi) * az_bins).astype(np.int64)
    azb = np.clip(azb, 0, az_bins - 1)
    bins = ring * az_bins + azb
    # nearest return per beam: sort by (bin, range), keep first of each bin
    order = np.lexsort((r, bins))
    bins_sorted = bins[order]
    first = np.ones(len(order), bool)
    first[1:] = bins_sorted[1:] != bins_sorted[:-1]
    pts = rel[order[first]]
    pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    return pts.astype(np.float32)


def _sample_view(
    scene: np.ndarray,
    sensor: np.ndarray,
    yaw: float,
    rng: np.random.Generator,
    n_points: int,
    max_range: float = 80.0,
    noise: float = 0.01,
    lidar_structured: bool = False,
) -> np.ndarray:
    """Sample one sensor view of a SHARED world scene.

    Body-frame convention: x_body = R(yaw)^T (x_world - sensor).
    Range cut + range-dependent thinning + measurement noise differ per view
    (independent rng), so the two frames observe the same world through
    different samplings — like two LiDAR scans of one street.
    ``lidar_structured`` swaps the Bernoulli thinning for the spherical
    depth buffer of :func:`_lidar_depth_buffer` (rings + occlusion).
    """
    if lidar_structured:
        pts = _lidar_depth_buffer(scene, sensor, rng, max_range, noise=noise)
    else:
        rel = scene - sensor[None, :]
        r = np.linalg.norm(rel, axis=1)
        keep = r < max_range
        pts = rel[keep]
        p_keep = np.clip(
            12.0 / np.maximum(np.linalg.norm(pts[:, :2], axis=1), 2.0),
            0.05, 1.0
        )
        pts = pts[rng.uniform(size=len(pts)) < p_keep]
        pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    if len(pts) > n_points:
        pts = pts[rng.choice(len(pts), n_points, replace=False)]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (pts @ rot).astype(np.float32)  # pts @ R == R^T x per point


def _multiview_apc(
    scene: np.ndarray,
    key_pos: np.ndarray,
    key_yaw: float,
    travel_dir: np.ndarray,
    rng: np.random.Generator,
    apc_points: int,
    max_range: float,
    complement_dist: float,
    frames_one_side: int,
    lidar_structured: bool = False,
) -> np.ndarray:
    """APC with true multi-viewpoint structure, mirroring the reference's APG
    (FCGF_APR/lib/complement_data_loader.py:518-632): complement frames are
    rendered from sensor origins shifted ``complement_dist * (i+1)`` along the
    travel direction on BOTH sides of the key frame, each with its own
    visibility culling + range thinning, registered into the key frame's
    body coordinates, concatenated, and cropped to the key frame's radius.

    Regions far from the key sensor are sparse in the key scan (thinning
    ~ 1/r) but densely observed by the complement frame parked next to them —
    so a decoder reconstructing this APC from key-frame features must
    hallucinate geometry the key scan barely sees, exactly the recipe's
    "dense geometry from sparse evidence" pressure.  Same-viewpoint
    densification (the pre-round-4 behavior, kept for
    ``complement_dist=0``) carries no such occluded structure.
    """
    n_frames = 2 * frames_one_side
    per_frame = max(apc_points // n_frames * 2, 1)
    c, s = np.cos(key_yaw), np.sin(key_yaw)
    r_key = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    chunks = []
    for side in (-1.0, 1.0):
        for i in range(frames_one_side):
            pos_c = key_pos + travel_dir * (side * complement_dist * (i + 1))
            pos_c = pos_c + np.array(
                [0, 0, rng.uniform(-0.2, 0.2)], np.float32)
            if lidar_structured:
                # structured complement scan in the complement body frame
                # (no yaw), shifted back to world coords
                pts = _lidar_depth_buffer(scene, pos_c, rng, max_range)
                pts = pts + pos_c[None, :]
            else:
                # world-frame visible points from this complement origin
                rel = scene - pos_c[None, :]
                r = np.linalg.norm(rel, axis=1)
                pts = scene[r < max_range]
                rr = np.maximum(
                    np.linalg.norm(pts[:, :2] - pos_c[None, :2], axis=1), 2.0)
                p_keep = np.clip(12.0 / rr, 0.05, 1.0)
                pts = pts[rng.uniform(size=len(pts)) < p_keep]
                pts = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
            if len(pts) > per_frame:
                pts = pts[rng.choice(len(pts), per_frame, replace=False)]
            chunks.append(pts)
    apc_world = np.concatenate(chunks).astype(np.float32)
    # register into the key body frame, crop to the key frame's radius
    # (reference crop: complement_data_loader.py:623-628)
    apc = (apc_world - key_pos[None, :]) @ r_key
    apc = apc[np.linalg.norm(apc, axis=1) < max_range]
    if len(apc) > apc_points:
        apc = apc[rng.choice(len(apc), apc_points, replace=False)]
    return apc.astype(np.float32)


def synthetic_pair(
    seed: int = 0,
    n_points: int = 30000,
    distance: float = 15.0,
    apc_points: int = 60000,
    extent: float = 60.0,
    max_range: float = 80.0,
    apc_complement_dist: float = 0.0,
    apc_frames_one_side: int = 3,
    lidar_structured: bool = False,
):
    """A distant pair + APC targets with exact ground truth.

    Returns dict with: points0, points1 (each in its own sensor frame,
    sampled from ONE shared world scene), t_gt (4x4 mapping frame0 coords ->
    frame1 coords), apc0, apc1 (denser aggregated clouds in each frame's
    coordinates — the reconstruction targets of the APG recipe).

    ``max_range`` sets each sensor's visibility radius.  When it is smaller
    than the scene extent + pair distance, the two views share only a
    lens-shaped overlap region that shrinks with ``distance`` — the
    low-overlap structure that makes real distant pairs hard (LoKITTI pairs
    at 40-50 m overlap by well under half a scan,
    FCGF_APR/config/file_LoKITTI_50.npy).

    ``apc_complement_dist > 0`` switches the APC targets from same-viewpoint
    densification to true multi-viewpoint aggregation (see
    :func:`_multiview_apc`), matching the reference's complement-frame
    spacing knob ``complement_pair_dist`` ×
    ``num_complement_one_side`` (FCGF_APR/scripts/train_apr_kitti.sh:21-22).
    """
    rng = np.random.default_rng(seed)
    scene = _scene_surface_points(
        np.random.default_rng(int(rng.integers(1 << 31))),
        int(max(n_points, apc_points) * 4),
        extent,
    )
    yaw = float(rng.uniform(-0.3, 0.3))
    pos0 = np.array([0.0, 0.0, 1.8], np.float32)
    d_ang = rng.uniform(0, 2 * np.pi)
    travel = np.array([np.cos(d_ang), np.sin(d_ang), 0.0], np.float32)
    pos1 = pos0 + travel * distance + np.array(
        [0.0, 0.0, rng.uniform(-0.2, 0.2)], np.float32)

    p0 = _sample_view(scene, pos0, 0.0, rng, n_points, max_range=max_range,
                      lidar_structured=lidar_structured)
    p1 = _sample_view(scene, pos1, yaw, rng, n_points, max_range=max_range,
                      lidar_structured=lidar_structured)

    # x_body = R^T (x_world - pos):  x1 = R1^T (x0 + pos0 - pos1)
    c, s = np.cos(yaw), np.sin(yaw)
    r1 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t_gt = np.eye(4, dtype=np.float32)
    t_gt[:3, :3] = r1.T
    t_gt[:3, 3] = r1.T @ (pos0 - pos1)

    if apc_complement_dist > 0:
        apc0 = _multiview_apc(scene, pos0, 0.0, travel, rng, apc_points,
                              max_range, apc_complement_dist,
                              apc_frames_one_side, lidar_structured)
        apc1 = _multiview_apc(scene, pos1, yaw, travel, rng, apc_points,
                              max_range, apc_complement_dist,
                              apc_frames_one_side, lidar_structured)
    else:
        apc0 = _sample_view(scene, pos0, 0.0, rng, apc_points,
                            max_range=max_range,
                            lidar_structured=lidar_structured)
        apc1 = _sample_view(scene, pos1, yaw, rng, apc_points,
                            max_range=max_range,
                            lidar_structured=lidar_structured)
    return dict(points0=p0, points1=p1, t_gt=t_gt, apc0=apc0, apc1=apc1)


def pad_points(points: np.ndarray, capacity: int):
    """Pad/truncate [N, 3] to [capacity, 3] + mask."""
    n = min(len(points), capacity)
    out = np.zeros((capacity, 3), np.float32)
    mask = np.zeros((capacity,), bool)
    out[:n] = points[:n]
    mask[:n] = True
    return out, mask
