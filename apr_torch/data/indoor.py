"""3DMatch indoor fragment pairs (port of ``apr_tpu/data/indoor.py``).

The reference's Predator_APR/datasets/indoor.py:14-84: pairs come from pkl
info dicts {src, tgt, rot, trans, overlap}; fragments are torch-saved
[N, 3] arrays (``torch.load``) or ``.npy``; in training a random zyx Euler
rotation (:func:`apr_torch.geometry.rotation.euler_matrix`) turns ONE side
(coin flip) and updates rot / trans, plus uniform noise.  Items are pair
dicts (t_gt maps src -> tgt; no APC: the indoor path trains without the
generative branch).
"""


from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

import torch

from apr_torch.config import APRConfig
from apr_torch.data.datasets import PairDataset
from apr_torch.geometry.rotation import euler_matrix


def load_info(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


class IndoorDataset(PairDataset):
    def __init__(self, config: APRConfig, phase: str,
                 augment_noise: float = 0.005,
                 data_augmentation: bool = True,
                 max_points: int = 30000):
        self.config = config
        self.base_dir = config.kitti_root
        info_path = os.path.join(
            config.kitti_root, "configs", f"{phase}_info.pkl"
        )
        if not os.path.exists(info_path):
            info_path = os.path.join(config.kitti_root, f"{phase}_info.pkl")
        self.infos = load_info(info_path)
        self.rng = np.random.RandomState(config.seed)
        self.augment_noise = augment_noise
        self.data_augmentation = data_augmentation and phase == "train"
        self.max_points = max_points

    def __len__(self):
        return len(self.infos["rot"])

    def _load_fragment(self, rel_path: str) -> np.ndarray:
        path = os.path.join(self.base_dir, rel_path)
        if path.endswith(".pth"):
            return np.asarray(torch.load(path, weights_only=False))
        return np.load(path)

    def get_pair(self, index: int) -> Dict[str, np.ndarray]:
        rot = np.array(self.infos["rot"][index], dtype=np.float64)
        trans = np.array(self.infos["trans"][index], dtype=np.float64)
        if trans.ndim == 1:
            trans = trans[:, None]
        src = self._load_fragment(self.infos["src"][index]).astype(np.float32)
        tgt = self._load_fragment(self.infos["tgt"][index]).astype(np.float32)

        for name in ("src", "tgt"):
            pcd = src if name == "src" else tgt
            if pcd.shape[0] > self.max_points:
                idx = self.rng.permutation(pcd.shape[0])[: self.max_points]
                if name == "src":
                    src = pcd[idx]
                else:
                    tgt = pcd[idx]

        if self.data_augmentation:
            euler = self.rng.rand(3) * np.pi * 2
            rot_ab = euler_matrix("zyx", euler)
            if self.rng.rand() > 0.5:
                src = src @ rot_ab.T
                rot = rot @ rot_ab.T
            else:
                tgt = tgt @ rot_ab.T
                rot = rot_ab @ rot
                trans = rot_ab @ trans
            src = src + (self.rng.rand(*src.shape) - 0.5) * self.augment_noise
            tgt = tgt + (self.rng.rand(*tgt.shape) - 0.5) * self.augment_noise

        t_gt = np.eye(4, dtype=np.float32)
        t_gt[:3, :3] = rot
        t_gt[:3, 3] = trans[:, 0]
        empty = np.zeros((0, 3), np.float32)
        return dict(
            points0=src.astype(np.float32),
            points1=tgt.astype(np.float32),
            apc0=empty, apc1=empty,
            t_gt=t_gt,
            overlap=np.float32(self.infos.get("overlap", [0.0])[index]
                               if "overlap" in self.infos else 0.0),
        )
