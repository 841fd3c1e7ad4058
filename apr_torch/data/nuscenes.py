"""nuScenes pairs with APG aggregation over a KITTI-format converted tree
(port of ``apr_tpu/data/nuscenes.py``).

The reference's PairComplementNuscenesDataset
(FCGF_APR/lib/complement_data_loader.py:826-1220): the tree is
``{root}/{split}/sequences/<log>/velodyne/*.bin`` with a per-sequence
``poses.npy`` (lidar -> world, 4x4 per frame); sequences are log names;
pairs and complement frames come from :func:`apr_torch.data.kitti.
generate_pairs`; ICP refinements are read from ``{root}/icp_nuscenes/``
when present; the train split keeps ``files[::3][:1200]``; LoNuScenes
reads ``file_LoNUSCENES_50.npy`` (the root's own, else the packaged copy).
"""


from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List, Tuple

import numpy as np

from apr_torch.config import APRConfig
from apr_torch.data.kitti import (
    KittiComplementDataset,
    generate_pairs,
)

log = logging.getLogger(__name__)


class NuscenesComplementDataset(KittiComplementDataset):
    """Same recipe as KITTI over the converted nuScenes tree.

    Differences from KITTI (reference :826-1220): sequences are log-name
    directories under {root}/{split}/sequences; poses come from poses.npy
    (lidar->world, no calib chain); train subsample files[::3][:1200];
    LoNuScenes fixed pairs for test.
    """

    def __init__(self, config: APRConfig, phase: str):
        self.config = config
        self.phase = phase
        self.root = os.path.join(config.kitti_root, phase)
        self.rng = np.random.RandomState(config.seed)
        self.use_old_pose = True  # asserted upstream in the reference
        self.complement_range = (
            config.num_complement_one_side * config.complement_pair_dist
        )
        self.load_neighbourhood = phase != "test"
        self.icp_path = os.path.join(config.kitti_root, "icp_nuscenes")
        self.poses: Dict[str, np.ndarray] = {}
        self.files: List[Tuple] = []
        self._prepare()
        if phase == "train":
            self.files = self.files[::3][:1200]
        if phase == "test" and config.LoNUSCENES:
            self._load_lonuscenes()

    # --- overrides ------------------------------------------------------

    def _seq_dir(self, log_name: str) -> str:  # type: ignore[override]
        return os.path.join(self.root, "sequences", str(log_name))

    def _velodyne_fn(self, log_name, t: int) -> str:  # type: ignore[override]
        return os.path.join(self._seq_dir(log_name), "velodyne", "%06d.bin" % t)

    def _frame_ids(self, log_name) -> List[int]:  # type: ignore[override]
        fnames = glob.glob(os.path.join(self._seq_dir(log_name), "velodyne", "*.bin"))
        return sorted(int(os.path.basename(f)[:-4]) for f in fnames)

    def _get_poses(self, log_name) -> np.ndarray:  # type: ignore[override]
        if log_name not in self.poses:
            self.poses[log_name] = np.load(
                os.path.join(self._seq_dir(log_name), "poses.npy")
            )
        return self.poses[log_name]

    def _pair_transform(self, drive, t0, t1, pos0, pos1):  # type: ignore[override]
        # nuScenes poses are already lidar->world: pure matrix math, cached
        # ICP refinement optional via the same cache layout
        key = "%s_%d_%d" % (drive, t0, t1)
        fn = os.path.join(self.icp_path, key + ".npy")
        if os.path.exists(fn):
            return np.load(fn)
        return np.linalg.inv(pos1) @ pos0

    def _complement_transforms(self, drive, t_key, t_cmpls, pos_key, pos_cmpls):
        # type: ignore[override]
        inv = np.linalg.inv(pos_key)
        out = []
        for t_c, p in zip(t_cmpls, pos_cmpls):
            key = "%s_%d_%d" % (drive, t_c, t_key)
            fn = os.path.join(self.icp_path, key + ".npy")
            out.append(np.load(fn) if os.path.exists(fn) else inv @ p)
        return out

    def _prepare(self):
        seq_root = os.path.join(self.root, "sequences")
        if not os.path.isdir(seq_root):
            log.warning("no nuScenes tree at %s", seq_root)
            return
        for log_name in sorted(os.listdir(seq_root)):
            inames = self._frame_ids(log_name)
            if not inames:
                continue
            poses = self._get_poses(log_name)
            ts = poses[:, :3, 3]
            pairs = generate_pairs(
                ts, inames,
                self.config.pair_min_dist, self.config.pair_max_dist,
                self.config.complement_pair_dist,
                self.config.num_complement_one_side,
                self.complement_range,
                with_complement=self.load_neighbourhood,
            )
            for p in pairs:
                self.files.append((log_name,) + p)
        log.info("nuScenes %s: %d pairs", self.phase, len(self.files))

    def _load_lonuscenes(self):
        # a pair list at the dataset root takes precedence; the packaged
        # copy of the reference's benchmark (FCGF_APR/config/
        # file_LoNUSCENES_50.npy, (994, 3) object [log, t0, t1]) is the
        # default
        path = os.path.join(self.config.kitti_root,
                            "file_LoNUSCENES_50.npy")
        if not os.path.exists(path):
            path = os.path.join(os.path.dirname(__file__), "splits",
                                "file_LoNUSCENES_50.npy")
        pairs = np.load(path, allow_pickle=True)
        self.files = [(str(d), int(t0), int(t1)) for d, t0, t1 in pairs]
        log.info("LoNuScenes: %d fixed pairs", len(self.files))
