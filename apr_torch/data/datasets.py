"""Datasets of registration pairs (port of ``apr_tpu/data/datasets.py``).

A dataset yields *pair dicts* (numpy, on the host):
    points0, points1: [N, 3] raw clouds in their own sensor frames
    apc0, apc1:       [M, 3] aggregated point cloud targets (training)
    t_gt:             [4, 4] ground truth mapping frame 0 -> frame 1

:class:`SyntheticPairDataset` backs the tests and the chip smoke run; the
KITTI, nuScenes, 3DMatch and ModelNet loaders are ROADMAP item C1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import synthetic_pair

_C1 = ("PairComplementKittiDataset", "KITTIPairDataset", "KITTINMPairDataset",
       "KITTIRandDistPairDataset", "PairComplementNuscenesDataset",
       "IndoorDataset", "ThreeDMatchPairDataset", "ModelNetHdf")


class PairDataset:
    """Abstract: len() + get_pair(i)."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def get_pair(self, index: int) -> Dict[str, np.ndarray]:  # pragma: no cover
        raise NotImplementedError


class SyntheticPairDataset(PairDataset):
    """Deterministic synthetic pairs, the same as the reference's for the
    same arguments: pair ``i`` of a phase has seed ``seed + {train: 0,
    val: 10000, test: 20000}[phase] + i`` and a sensor distance drawn
    uniformly in [min_dist, max_dist] from it."""

    def __init__(self, num_pairs: int = 64, n_points: int = 30000,
                 apc_points: int = 60000, min_dist: float = 5.0,
                 max_dist: float = 20.0, extent: float = 60.0,
                 seed: int = 0, phase: str = "train"):
        self.num_pairs = num_pairs
        self.n_points = n_points
        self.apc_points = apc_points
        self.min_dist = min_dist
        self.max_dist = max_dist
        self.extent = extent
        self.base_seed = seed + {"train": 0, "val": 10_000,
                                 "test": 20_000}[phase]

    def __len__(self):
        return self.num_pairs

    def get_pair(self, index: int) -> Dict[str, np.ndarray]:
        seed = self.base_seed + index
        dist = float(np.random.default_rng(seed).uniform(self.min_dist,
                                                         self.max_dist))
        return synthetic_pair(seed=seed, n_points=self.n_points,
                              apc_points=self.apc_points, distance=dist,
                              extent=self.extent)


def make_dataset(config: APRConfig, phase: str) -> PairDataset:
    """The dataset of ``config.dataset`` for ``phase`` (train / val /
    test), as the reference's make_data_loader names them."""
    name = config.dataset
    if name in ("SyntheticPairDataset", "synthetic"):
        return SyntheticPairDataset(
            num_pairs={"train": 64, "val": 16, "test": 16}[phase],
            min_dist=config.pair_min_dist, max_dist=config.pair_max_dist,
            seed=config.seed, phase=phase)
    if name in _C1:
        raise NotImplementedError(
            f"dataset {name!r}: the real-dataset loaders are ROADMAP item C1 "
            f"and not ported yet; use dataset='synthetic'")
    raise ValueError(f"unknown dataset: {name}")
