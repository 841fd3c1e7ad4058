"""ModelNet40 HDF5 pairs with RPMNet-style pair generation (port of
``apr_tpu/data/modelnet.py``).

The reference's Predator_APR/datasets/modelnet.py:15-241 and the transform
stack of datasets/transforms.py:13-380: object clouds of the
modelnet40_ply_hdf5_2048 archive; each item becomes a (source, target) pair
by crop, resample and a random SE(3) (:func:`apr_torch.geometry.rotation.
rotvec_matrix`); t_gt maps source -> target.  ``h5py`` is imported when a
dataset is made, as the reference does, and nowhere else.
"""


from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np

from apr_torch.config import APRConfig
from apr_torch.data.datasets import PairDataset
from apr_torch.geometry.rotation import rotvec_matrix


# --- RPMNet-style transforms (numpy) ---------------------------------------

def uniform_2_sphere(rng, num: Optional[int] = None):
    phi = rng.uniform(0.0, 2 * np.pi, num)
    cos_theta = rng.uniform(-1.0, 1.0, num)
    theta = np.arccos(cos_theta)
    x = np.sin(theta) * np.cos(phi)
    y = np.sin(theta) * np.sin(phi)
    z = np.cos(theta)
    return np.stack([x, y, z], axis=-1)


def resample(rng, points: np.ndarray, k: int) -> np.ndarray:
    """Resample to exactly k points (with replacement if needed)."""
    n = len(points)
    if k <= n:
        idx = rng.choice(n, k, replace=False)
    else:
        idx = np.concatenate(
            [rng.permutation(n), rng.choice(n, k - n, replace=True)]
        )
    return points[idx]


def random_crop(rng, points: np.ndarray, keep_ratio: float) -> np.ndarray:
    """Crop to the half-space-ish fraction along a random direction."""
    if keep_ratio >= 1.0:
        return points
    direction = uniform_2_sphere(rng)
    centered = points[:, :3] - points[:, :3].mean(0)
    dist = centered @ direction
    thresh = np.percentile(dist, (1.0 - keep_ratio) * 100)
    return points[dist > thresh]


def random_se3(rng, rot_mag_deg: float = 45.0, trans_mag: float = 0.5):
    axis = uniform_2_sphere(rng)
    angle = np.radians(rng.uniform(0, rot_mag_deg))
    r = rotvec_matrix(axis * angle)
    t = rng.uniform(-trans_mag, trans_mag, 3)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = r
    out[:3, 3] = t
    return out


class ModelNetHdf(PairDataset):
    def __init__(
        self,
        config: APRConfig,
        phase: str,
        num_points: int = 1024,
        partial_ratio: Sequence[float] = (0.7, 0.7),
        rot_mag: float = 45.0,
        trans_mag: float = 0.5,
        noise_std: float = 0.01,
        categories: Optional[Sequence[str]] = None,
    ):
        self.config = config
        self.num_points = num_points
        self.partial_ratio = partial_ratio
        self.rot_mag = rot_mag
        self.trans_mag = trans_mag
        self.noise_std = noise_std
        self.rng = np.random.RandomState(config.seed)

        import h5py

        root = config.kitti_root
        split = "train" if phase == "train" else "test"
        files_list = os.path.join(root, f"{split}_files.txt")
        if os.path.exists(files_list):
            with open(files_list) as f:
                h5_files = [
                    os.path.join(root, os.path.basename(l.strip()))
                    for l in f if l.strip()
                ]
        else:
            h5_files = sorted(glob.glob(os.path.join(root, f"*{split}*.h5")))
        clouds, labels = [], []
        for fn in h5_files:
            with h5py.File(fn, "r") as f:
                clouds.append(np.asarray(f["data"][:], np.float32))
                labels.append(np.asarray(f["label"][:]).reshape(-1))
        self.points = np.concatenate(clouds)
        self.labels = np.concatenate(labels)
        if categories is not None:
            shapes_path = os.path.join(root, "shape_names.txt")
            with open(shapes_path) as f:
                names = [l.strip() for l in f]
            keep_ids = [names.index(c) for c in categories]
            mask = np.isin(self.labels, keep_ids)
            self.points = self.points[mask]
            self.labels = self.labels[mask]

    def __len__(self):
        return len(self.points)

    def get_pair(self, index: int) -> Dict[str, np.ndarray]:
        rng = self.rng
        cloud = self.points[index][:, :3]
        src = random_crop(rng, cloud, self.partial_ratio[0])
        tgt = random_crop(rng, cloud, self.partial_ratio[1])
        src = resample(rng, src, self.num_points)
        tgt = resample(rng, tgt, self.num_points)

        t_gt = random_se3(rng, self.rot_mag, self.trans_mag)
        tgt = tgt @ t_gt[:3, :3].T + t_gt[:3, 3]
        if self.noise_std > 0:
            src = src + rng.normal(0, self.noise_std, src.shape)
            tgt = tgt + rng.normal(0, self.noise_std, tgt.shape)

        empty = np.zeros((0, 3), np.float32)
        return dict(
            points0=src.astype(np.float32),
            points1=tgt.astype(np.float32),
            apc0=empty, apc1=empty,
            t_gt=t_gt.astype(np.float32),
            label=np.int32(self.labels[index]),
        )
