"""Occupancy-driven capacity bucketing for the eval pipeline (numpy only).

The eval step's cost scales with the static voxel capacity, not with the
cloud's actual occupancy: every gather in the encoder touches all
``capacities[0]`` rows, padded or not.  Bucketing picks, per pair, the
smallest of a few halved capacity tiers that holds both clouds.  Halving
keeps the level-capacity ratios, so a cloud in tier d behaves exactly like a
2d-times-denser cloud at full capacity.

Copy of ``apr_tpu/eval/bucketing.py``; the reference's choices are kept as
they are (``select_divisor`` looks only at level-0 occupancy).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def voxel_occupancy(points: np.ndarray, voxel_size: float) -> int:
    """Number of occupied voxels of a raw cloud (host-side, exact)."""
    if len(points) == 0:
        return 0
    grid = np.floor(np.asarray(points) / voxel_size).astype(np.int64)
    return len(np.unique(grid, axis=0))


def select_divisor(
    occ: int,
    n_points: int,
    base_capacity: int,
    point_capacity: int,
    max_tiers: int = 2,
    headroom: float = 1.0,
) -> int:
    """Largest power-of-two divisor d (1, 2, 4, ...) such that the cloud
    still fits: occ * headroom <= base_capacity / d and n_points <=
    point_capacity / d.  ``max_tiers`` bounds how far below worst case the
    capacities may shrink (2 -> divisors up to 4)."""
    d = 1
    for _ in range(max_tiers):
        nd = d * 2
        if (occ * headroom <= base_capacity // nd
                and n_points <= point_capacity // nd):
            d = nd
        else:
            break
    return d


def bucket_for_pair(
    pair: dict,
    voxel_size: float,
    base_capacities: Sequence[int],
    point_capacity: int,
    max_tiers: int = 2,
) -> Tuple[int, Tuple[int, ...]]:
    """(point_capacity, capacities) for the smallest tier holding BOTH
    clouds of the pair."""
    d = min(
        select_divisor(
            voxel_occupancy(pair["points0"], voxel_size),
            len(pair["points0"]), base_capacities[0], point_capacity,
            max_tiers),
        select_divisor(
            voxel_occupancy(pair["points1"], voxel_size),
            len(pair["points1"]), base_capacities[0], point_capacity,
            max_tiers),
    )
    return point_capacity // d, tuple(c // d for c in base_capacities)
