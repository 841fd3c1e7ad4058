"""Inputs from the seed: the pool of synthetic pairs and each step's or
pair's fresh rigid jitter about z, on the host."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from frozen.synthetic import pad_points, synthetic_pair


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63)] + list(keys))


def make_pool(scene_seed: int, n_pairs: int, points: int, apc_points: int,
              min_dist: float, max_dist: float, seed: int) -> List[Dict]:
    """``n_pairs`` distinct synthetic pairs at distances drawn from
    [min_dist, max_dist], all from the mix's ``scene_seed``, in an order
    drawn from the run's ``seed``: every seed gets the same set of scenes
    and sizes (and so the same work) in another order."""
    r = rng(scene_seed, 1)
    seeds = r.integers(0, 1 << 62, size=n_pairs)
    dists = r.uniform(min_dist, max_dist, size=n_pairs)
    pairs = [synthetic_pair(seed=int(s), n_points=points, distance=float(d),
                            apc_points=apc_points)
             for s, d in zip(seeds, dists)]
    return [pairs[i] for i in rng(seed, 5).permutation(n_pairs)]


def _yaw(theta: float, t) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float64)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:2, 3] = t
    return m


def _move(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``points`` under the rigid motion ``m``, in float32 (torch's CPU
    product: a third of numpy's time on a frame)."""
    rot = torch.from_numpy(m[:3, :3].T.astype(np.float32))
    shift = torch.from_numpy(m[:3, 3].astype(np.float32))
    return torch.addmm(shift, torch.from_numpy(points), rot).numpy()


def motions(seed: int, index: int, yaw_deg: float, shift_m: float):
    """The two clouds' rigid motions about z of jitter ``index``."""
    r = rng(seed, 2, index)
    return [_yaw(np.deg2rad(r.uniform(-yaw_deg, yaw_deg)),
                 r.uniform(-shift_m, shift_m, size=2)) for _ in range(2)]


def jittered(pair: Dict, seed: int, index: int, yaw_deg: float,
             shift_m: float) -> Dict:
    """``pair``'s two clouds, each moved by its own rigid motion about z
    drawn from (seed, index), and t_gt moved to match."""
    m0, m1 = motions(seed, index, yaw_deg, shift_m)
    t_gt = m1 @ pair["t_gt"].astype(np.float64) @ np.linalg.inv(m0)
    return dict(points0=_move(pair["points0"], m0),
                points1=_move(pair["points1"], m1),
                t_gt=t_gt.astype(np.float32))


class PaddedPool:
    """A pool of batches of pairs and each step's batch of it, padded to
    the trainer's capacities under fresh rigid jitters about z.  Only the
    valid rows are moved (padding stays zero and masked), so the feed's
    host work stays a few milliseconds a step."""

    KEYS = ("points0", "points1", "apc0", "apc1")

    def __init__(self, pairs: Sequence[Dict], batch_size: int,
                 point_capacity: int, apc_capacity: int):
        self.b = batch_size
        self.caps = dict(points0=point_capacity, points1=point_capacity,
                         apc0=apc_capacity, apc1=apc_capacity)
        self.batches = []
        for first in range(0, len(pairs), batch_size):
            group = pairs[first:first + batch_size]
            cols = {k: [pad_points(p[k], self.caps[k]) for p in group]
                    for k in self.KEYS}
            masks = {k: np.stack([m for _, m in v]) for k, v in cols.items()}
            counts = {k: [int(m.sum()) for _, m in v]
                      for k, v in cols.items()}
            points = {k: [p[:n] for (p, _), n in zip(v, counts[k])]
                      for k, v in cols.items()}
            t_gt = np.stack([p["t_gt"] for p in group]).astype(np.float64)
            self.batches.append((points, masks, t_gt))

    def raw(self, seed: int, step: int, yaw_deg: float, shift_m: float,
            batched: bool):
        """The nine arrays a trainer's ``build_batch`` takes (points0,
        mask0, points1, mask1, apc0, apc0_mask, apc1, apc1_mask, t_gt) of
        step ``step``, with a leading batch dim when ``batched``.  Pair i of
        the step takes jitter index ``step * B + i``."""
        points, masks, t_gt = self.batches[step % len(self.batches)]
        moves = [motions(seed, step * self.b + i, yaw_deg, shift_m)
                 for i in range(self.b)]
        out = {}
        for k in self.KEYS:
            side = int(k[-1])
            arr = np.zeros((self.b, self.caps[k], 3), np.float32)
            for i, p in enumerate(points[k]):
                arr[i, :len(p)] = _move(p, moves[i][side])
            out[k] = arr
        m0 = np.stack([m[0] for m in moves])
        m1 = np.stack([m[1] for m in moves])
        t = (m1 @ t_gt @ np.linalg.inv(m0)).astype(np.float32)
        raw = (out["points0"], masks["points0"], out["points1"],
               masks["points1"], out["apc0"], masks["apc0"], out["apc1"],
               masks["apc1"], t)
        return raw if batched else tuple(x[0] for x in raw)
