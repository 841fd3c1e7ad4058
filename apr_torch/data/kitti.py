"""KITTI odometry / SemanticKITTI pairs with APG complement aggregation (port
of ``apr_tpu/data/kitti.py``).

The same pair lists, complement frames and items as the reference, from
the same files and seeds:

- ``generate_pairs`` walks each sequence drawing a target distance in
  [pair_min_dist, pair_max_dist] from the GLOBAL ``np.random`` stream after
  ``np.random.seed(0)``; a pair is kept only if both frames have a full
  complement neighbourhood (``find_complement_frames``);
- poses: SemanticKITTI SLAM poses (``use_old_pose=False``: ``poses.txt``
  through the ``calib.txt`` Tr chain, pure matrix math) or the odometry
  poses with the ICP cache ``{root}/icp/{drive}_{t1}_{t0}.npy``, which
  ``tools/prepare_icp_cache.py`` fills offline (a missing file raises);
- per item: the ``.bin`` clouds, the complements moved into the key frame,
  the rotation (the reference's degrees-fed-radians range) or the Predator
  ``d3feat_augment``, the APC crop to the key frame's radius, the random
  scale, ``mutate_neighbour_percentage`` and the test-time
  ``downsample_single``; the per-dataset draws come from
  ``np.random.RandomState(config.seed)`` in ``get_pair`` order;
- LoKITTI: the fixed pairs of ``file_LoKITTI_50.npy`` (the root's own, else
  the packaged copy of the reference's file).

The scipy rotations of the reference are :mod:`apr_torch.geometry.rotation`.
Voxelization and correspondences run later, on the device
(``training/batching.py``).
"""


from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from apr_torch.config import APRConfig
from apr_torch.data.datasets import PairDataset
from apr_torch.geometry.rotation import euler_matrix, expm, vector_norm

log = logging.getLogger(__name__)

# default split: train 00-05, val 06-07, test 08-10 (config/train_kitti.txt)
DEFAULT_SPLITS = {
    "train": [0, 1, 2, 3, 4, 5],
    "val": [6, 7],
    "test": [8, 9, 10],
}

# velo->cam calibration constant used for the odometry-pose chain
# (complement_data_loader.py:343-354)
_VELO2CAM_R = np.array([
    7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02, 7.280733e-04,
    -9.998902e-01, 9.998621e-01, 7.523790e-03, 1.480755e-02
]).reshape(3, 3)
_VELO2CAM_T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01])


def velo2cam_matrix() -> np.ndarray:
    m = np.hstack([_VELO2CAM_R, _VELO2CAM_T.reshape(3, 1)])
    return np.vstack([m, [0, 0, 0, 1]]).T


def parse_calibration(path: str) -> Dict[str, np.ndarray]:
    calib = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, content = line.strip().split(":", 1)
            values = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def load_slam_poses(seq_dir: str) -> np.ndarray:
    """SemanticKITTI poses.txt in LiDAR frame: Tr^-1 @ pose @ Tr per frame."""
    calib = parse_calibration(os.path.join(seq_dir, "calib.txt"))
    tr = calib["Tr"]
    tr_inv = np.linalg.inv(tr)
    poses = []
    with open(os.path.join(seq_dir, "poses.txt")) as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            # Tr_inv @ (pose @ Tr): same association as the reference's
            # nested matmuls (:289) so the chain is bit-identical
            poses.append(tr_inv @ (pose @ tr))
    return np.asarray(poses)


def load_odometry_poses(root: str, drive: int) -> np.ndarray:
    """KITTI odometry ground-truth camera poses (data_odometry_poses)."""
    path = os.path.join(root, "poses", "%02d.txt" % drive)
    raw = np.genfromtxt(path).reshape(-1, 3, 4)
    n = raw.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = raw
    return out


def find_complement_frames(
    ts: np.ndarray, frame: int, complement_pair_dist: float,
    num_one_side: int, complement_range: float,
) -> Tuple[bool, List[int]]:
    """Reference _get_complement_frames parity (:298-335).

    ts: [T, 3] per-frame positions of this sequence.  Returns
    (skip, [left frames (furthest-first order as reference), right frames]).
    """
    window = int(10 * complement_range)
    out: List[int] = []
    left_bound = max(0, frame - window)
    left_dist = np.linalg.norm(ts[left_bound:frame] - ts[frame], axis=1)
    for i in range(num_one_side):
        need = complement_pair_dist * (i + 1)
        cand = np.where(left_dist > need)[0]
        if len(cand) == 0:
            return True, []
        out.append(left_bound + cand[-1])
    right_dist = np.linalg.norm(ts[frame:frame + window] - ts[frame], axis=1)
    for i in range(num_one_side):
        need = complement_pair_dist * (i + 1)
        cand = np.where(right_dist > need)[0]
        if len(cand) == 0:
            return True, []
        out.append(frame + cand[0])
    return False, out


# hand-curated bad pairs the reference walk skips on the odometry-pose path
# only (complement_data_loader.py:119-125 + the `skip_2 and use_old_pose`
# gate at :240-241); data artifact copied by contract
DISCARD_PAIRS = frozenset([
    (5, 1151, 1220), (2, 926, 962), (2, 2022, 2054),
    (1, 250, 266), (0, 3576, 3609), (2, 2943, 2979),
    (1, 411, 423), (2, 2241, 2271), (0, 1536, 1607),
    (0, 1338, 1439), (7, 784, 810), (2, 1471, 1498),
    (2, 3829, 3862), (0, 1780, 1840), (2, 3294, 3356),
    (2, 2420, 2453), (2, 4146, 4206), (0, 2781, 2829),
    (0, 3351, 3451), (1, 428, 444), (0, 3073, 3147),
])


def generate_pairs(
    ts: np.ndarray,
    inames: Sequence[int],
    min_dist: float,
    max_dist: float,
    complement_pair_dist: float,
    num_one_side: int,
    complement_range: float,
    with_complement: bool = True,
    discard: Optional[frozenset] = None,
    drive: Optional[int] = None,
) -> List[Tuple]:
    """Reference prepare_kitty_ply walk (:222-250), np.random.seed(0).

    ``discard``/``drive``: when set (the use_old_pose path), pairs in the
    reference's hand-curated DISCARD_PAIRS are skipped with curr += 1
    (:240-242), which also shifts the subsequent walk."""
    files = []
    iset = set(inames)
    curr = inames[min(int(complement_range * 5), len(inames) // 2)]
    np.random.seed(0)
    while curr in iset:
        dist_tmp = min_dist + np.random.rand() * (max_dist - min_dist)
        right = np.linalg.norm(
            ts[curr:curr + int(10 * complement_range)] - ts[curr], axis=1
        )
        beyond = np.where(right > dist_tmp)[0]
        if len(beyond) == 0:
            curr += 1
            continue
        nxt = beyond[0] + curr - 1
        skip0, cmpl0 = find_complement_frames(
            ts, curr, complement_pair_dist, num_one_side, complement_range
        )
        skip1, cmpl1 = find_complement_frames(
            ts, nxt, complement_pair_dist, num_one_side, complement_range
        )
        if discard is not None and (drive, curr, nxt) in discard:
            skip1 = True
        if skip0 or skip1:
            curr += 1
            continue
        if with_complement:
            files.append((curr, nxt, cmpl0, cmpl1))
        else:
            files.append((curr, nxt))
        curr = nxt + 1
    return files


class KittiComplementDataset(PairDataset):
    """PairComplementKittiDataset parity over a KITTI-format tree."""

    def __init__(self, config: APRConfig, phase: str,
                 splits: Optional[Dict[str, List[int]]] = None):
        self.config = config
        self.phase = phase
        self.root = config.kitti_root
        self.rng = np.random.RandomState(config.seed)
        self.use_old_pose = config.use_old_pose
        # the reference's window is 10*complement_range frames with
        # complement_range = num_complement_one_side * complement_pair_dist
        self.complement_range = (
            config.num_complement_one_side * config.complement_pair_dist
        )
        self.load_neighbourhood = phase != "test"
        self.icp_path = os.path.join(
            self.root, "icp" if self.use_old_pose else "icp_slam"
        )
        splits = splits or DEFAULT_SPLITS
        self.drives = splits[phase]
        self.poses: Dict[int, np.ndarray] = {}
        self.files: List[Tuple] = []
        self._prepare()
        if phase == "test" and config.LoKITTI:
            self._load_lokitti()

    # --- sequence scanning ---------------------------------------------

    def _seq_dir(self, drive: int) -> str:
        return os.path.join(self.root, "sequences", "%02d" % drive)

    def _velodyne_fn(self, drive: int, t: int) -> str:
        return os.path.join(self._seq_dir(drive), "velodyne", "%06d.bin" % t)

    def _frame_ids(self, drive: int) -> List[int]:
        fnames = glob.glob(os.path.join(self._seq_dir(drive), "velodyne", "*.bin"))
        return sorted(int(os.path.basename(f)[:-4]) for f in fnames)

    def _get_poses(self, drive: int) -> np.ndarray:
        if drive not in self.poses:
            if self.use_old_pose:
                self.poses[drive] = load_odometry_poses(self.root, drive)
            else:
                self.poses[drive] = load_slam_poses(self._seq_dir(drive))
        return self.poses[drive]

    def _prepare(self):
        for drive in self.drives:
            inames = self._frame_ids(drive)
            if not inames:
                log.warning("no frames for drive %02d under %s", drive, self.root)
                continue
            poses = self._get_poses(drive)
            ts = poses[:, :3, 3]
            pairs = generate_pairs(
                ts, inames,
                self.config.pair_min_dist, self.config.pair_max_dist,
                self.config.complement_pair_dist,
                self.config.num_complement_one_side,
                self.complement_range,
                with_complement=self.load_neighbourhood,
                discard=DISCARD_PAIRS if self.use_old_pose else None,
                drive=drive,
            )
            for p in pairs:
                self.files.append((drive,) + p)
        log.info("KITTI %s: %d pairs from drives %s",
                 self.phase, len(self.files), self.drives)

    def _load_lokitti(self):
        # a user-supplied pair list at the dataset root takes precedence;
        # the vendored reference artifact is the default
        path = os.path.join(self.root, "file_LoKITTI_50.npy")
        if not os.path.exists(path):
            path = os.path.join(os.path.dirname(__file__), "splits",
                                "file_LoKITTI_50.npy")
        pairs = np.load(path)
        self.files = [(int(d), int(t0), int(t1)) for d, t0, t1 in pairs]
        log.info("LoKITTI: %d fixed pairs", len(self.files))

    # --- pose / GT helpers ---------------------------------------------

    def _pair_transform(self, drive, t0, t1, pos0, pos1) -> np.ndarray:
        """GT mapping frame-t0 coords into frame-t1 coords.

        SLAM path: pure matrix math (reference :391 M2 = inv(pos_curr) @
        pos_next with curr=t1, next=t0).  Odometry path: read the ICP cache
        (produced offline by tools/prepare_icp_cache.py, same layout as the
        reference's hidden first-epoch ICP stage)."""
        if not self.use_old_pose:
            return np.linalg.inv(pos1) @ pos0
        key = "%d_%d_%d" % (drive, t0, t1)
        fn = os.path.join(self.icp_path, key + ".npy")
        if os.path.exists(fn):
            return np.load(fn)
        raise FileNotFoundError(
            f"ICP cache missing: {fn}; run tools/prepare_icp_cache.py "
            f"(the reference computes these lazily inside __getitem__)"
        )

    def _complement_transforms(self, drive, t_key, t_cmpls, pos_key, pos_cmpls):
        if not self.use_old_pose:
            inv = np.linalg.inv(pos_key)
            return [inv @ p for p in pos_cmpls]
        out = []
        for t_c in t_cmpls:
            key = "%d_%d_%d" % (drive, t_c, t_key)
            fn = os.path.join(self.icp_path, key + ".npy")
            if not os.path.exists(fn):
                raise FileNotFoundError(
                    f"ICP cache missing: {fn}; run tools/prepare_icp_cache.py"
                )
            out.append(np.load(fn))
        return out

    def _get_xyz(self, drive: int, t: int) -> np.ndarray:
        xyzr = np.fromfile(self._velodyne_fn(drive, t), dtype=np.float32)
        return xyzr.reshape(-1, 4)[:, :3]

    # --- item assembly --------------------------------------------------

    def __len__(self):
        return len(self.files)

    def get_pair(self, index: int) -> Dict[str, np.ndarray]:
        c = self.config
        entry = self.files[index]
        if self.load_neighbourhood:
            drive, t0, t1, cmpl0, cmpl1 = entry
        else:
            drive, t0, t1 = entry[:3]
            cmpl0 = cmpl1 = []
        poses = self._get_poses(drive)
        pos0, pos1 = poses[t0], poses[t1]

        xyz0 = self._get_xyz(drive, t0)
        xyz1 = self._get_xyz(drive, t1)
        trans = self._pair_transform(drive, t0, t1, pos0, pos1)

        def assemble_apc(t_key, pos_key, t_cmpls, xyz_key):
            if not t_cmpls:
                return np.zeros((0, 3), np.float32)
            pos_cmpls = [poses[t] for t in t_cmpls]
            if c.mutate_neighbour_percentage > 0:
                # fault-injection ablation (:536-544): corrupt rotations.
                # PARITY NOTE: on the use_old_pose=True path with a warm ICP
                # cache the mutation is a no-op — the reference's
                # multiway_registration also returns cached transforms and
                # ignores the mutated poses (complement_data_loader.py:
                # 1040-1065); the mutation only reaches results through the
                # ICP/pose-graph INITIALIZATION on cache misses, and fully
                # on the SLAM-pose path
                n_vic = int(c.mutate_neighbour_percentage * len(pos_cmpls))
                vics = self.rng.choice(len(pos_cmpls), n_vic, replace=False)
                pos_cmpls = [p.copy() for p in pos_cmpls]
                for v in vics:
                    ang = (self.rng.rand(3) - 0.5) * np.pi * 2
                    rot = euler_matrix("zyx", ang)
                    pos_cmpls[v][:3, :3] = pos_cmpls[v][:3, :3] @ rot
            ms = self._complement_transforms(
                drive, t_key, t_cmpls, pos_key, pos_cmpls
            )
            parts = []
            for t_c, m in zip(t_cmpls, ms):
                x = self._get_xyz(drive, t_c)
                parts.append(_apply(x, m))
            return np.concatenate(parts, 0).astype(np.float32)

        apc0 = assemble_apc(t0, pos0, cmpl0, xyz0)
        apc1 = assemble_apc(t1, pos1, cmpl1, xyz1)

        if self.phase == "test" and c.downsample_single != 1.0:
            # reference test branch downsamples BEFORE the rotation
            # augmentation (:746-749 vs :634-637 on the train branch), so
            # the re-centering mean is taken over the downsampled cloud
            idx = self.rng.choice(len(xyz0), int(len(xyz0) * c.downsample_single))
            xyz0 = xyz0[idx]

        if c.d3feat_augmentation and self.phase == "train":
            # Predator flavor (kitti.py:494-517) replaces the FCGF-style
            # rotation/scale below
            out = d3feat_augment(
                dict(points0=xyz0.astype(np.float32),
                     points1=xyz1.astype(np.float32),
                     apc0=apc0.astype(np.float32),
                     apc1=apc1.astype(np.float32),
                     t_gt=trans.astype(np.float32),
                     meta=np.asarray([drive, t0, t1])),
                self.rng, noise=c.augment_noise,
                shift_range=c.augment_shift_range,
                scale_min=c.min_scale, scale_max=c.max_scale,
            )
            # the key-frame-radius APC crop applies AFTER augmentation on
            # this branch too (reference order, :601-628)
            for pk, ak in (("points0", "apc0"), ("points1", "apc1")):
                apc = out[ak]
                if len(apc):
                    r2 = (out[pk] ** 2).sum(-1).max()
                    out[ak] = apc[(apc ** 2).sum(-1) < r2]
            return out

        # random rotation + re-centering.  Branch-exact reference parity:
        # the complement branch ALWAYS augments because test_augmentation is
        # hard-coded True in __init__ (:139) and the gate is
        # `random_rotation or test_augmentation` (:598) with the 2*pi range
        # (:600-601); the no-neighbourhood (test) branch gates on
        # random_rotation alone with the pi/4 range (:753-755).  NOTE quirk
        # preserved: the helper expects a range in DEGREES but is passed
        # radians, so the effective rotation is only
        # +-(range * pi/180 / 2) — ~3.1 deg (train) / ~0.4 deg (test) —
        # and T[:3,3] = R @ (-mean) re-centers each cloud at the origin.
        if self.load_neighbourhood or c.random_rotation:
            rot_range = np.pi * 2 if self.load_neighbourhood else np.pi / 4
            t0_aug = _sample_random_trans(xyz0, self.rng, rot_range)
            t1_aug = _sample_random_trans(xyz1, self.rng, rot_range)
            trans = t1_aug @ trans @ np.linalg.inv(t0_aug)
            xyz0 = _apply(xyz0, t0_aug)
            xyz1 = _apply(xyz1, t1_aug)
            apc0 = _apply(apc0, t0_aug)
            apc1 = _apply(apc1, t1_aug)

        # crop the APC to the key frame's max radius AFTER augmentation
        # (reference order, :601-628: rotate everything, then crop)
        if len(apc0):
            apc0 = apc0[(apc0 ** 2).sum(-1) < (xyz0 ** 2).sum(-1).max()]
        if len(apc1):
            apc1 = apc1[(apc1 ** 2).sum(-1) < (xyz1 ** 2).sum(-1).max()]

        if c.random_scale and self.rng.rand() < 0.95 and self.phase == "train":
            scale = c.min_scale + (c.max_scale - c.min_scale) * self.rng.rand()
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
            apc0 = scale * apc0
            apc1 = scale * apc1
            trans = trans.copy()
            trans[:3, 3] *= scale

        return dict(
            points0=xyz0.astype(np.float32),
            points1=xyz1.astype(np.float32),
            apc0=apc0.astype(np.float32),
            apc1=apc1.astype(np.float32),
            t_gt=trans.astype(np.float32),
            meta=np.asarray([drive, t0, t1]),
        )


def d3feat_augment(pair: Dict[str, np.ndarray], rng,
                   noise: float = 0.01, shift_range: float = 2.0,
                   scale_min: float = 0.8, scale_max: float = 1.2
                   ) -> Dict[str, np.ndarray]:
    """D3Feat-style augmentation of the Predator KITTI flavor
    (Predator_APR/datasets/kitti.py:494-517): per-cloud uniform noise, a
    random zyx-Euler rotation applied to ONE side (coin flip), a global
    scale, and a per-cloud shift in [-shift_range, shift_range]^3.

    Deviation from the reference, documented: the reference feeds the
    augmented clouds to the network but keeps GT/losses in the raw frame
    (it returns both copies); here one buffer serves both, so every
    component is folded into t_gt consistently — the same invariance
    pressure without duplicate buffers.
    """
    p0 = pair["points0"] + (rng.rand(*pair["points0"].shape) - 0.5) * noise
    p1 = pair["points1"] + (rng.rand(*pair["points1"].shape) - 0.5) * noise
    apc0, apc1 = pair["apc0"], pair["apc1"]
    trans = pair["t_gt"].copy()

    rot = euler_matrix("zyx", rng.rand(3) * np.pi * 2)
    r4 = np.eye(4)
    r4[:3, :3] = rot
    if rng.rand() > 0.5:
        p0 = p0 @ rot.T
        apc0 = apc0 @ rot.T
        trans = trans @ np.linalg.inv(r4)
    else:
        p1 = p1 @ rot.T
        apc1 = apc1 @ rot.T
        trans = r4 @ trans

    scale = scale_min + (scale_max - scale_min) * rng.rand()
    p0, p1, apc0, apc1 = p0 * scale, p1 * scale, apc0 * scale, apc1 * scale
    trans[:3, 3] *= scale

    shift0 = rng.uniform(-shift_range, shift_range, 3)
    shift1 = rng.uniform(-shift_range, shift_range, 3)
    p0, apc0 = p0 + shift0, apc0 + shift0
    p1, apc1 = p1 + shift1, apc1 + shift1
    # src' = src + a, tgt' = tgt + b  =>  trans' = T(b) @ trans @ T(-a)
    trans[:3, 3] = trans[:3, 3] + shift1 - trans[:3, :3] @ shift0

    return dict(
        pair,
        points0=p0.astype(np.float32),
        points1=p1.astype(np.float32),
        apc0=apc0.astype(np.float32),
        apc1=apc1.astype(np.float32),
        t_gt=trans.astype(np.float32),
    )


class KittiBaselinePairDataset(PairDataset):
    """The three baseline (non-APG) FCGF pairings over KITTI odometry
    (FCGF_APR/lib/data_loaders.py:284-700), selected by ``mode``:

    - ``time_diff`` (KITTIPairDataset): every (t, t+dt) with
      dt in [2, kitti_max_time_diff) that exists on disk (:319-327);
    - ``nm`` (KITTINMPairDataset): sequence walk pairing each frame with the
      first frame >10 m away within the next 100 frames (next[0]+curr-1 index
      quirk preserved, :575-592), minus the problematic (8, 15, 58) pair;
    - ``rand_dist`` (KITTIRandDistPairDataset): walk with per-step target
      distance U(5, 45) and window int(dist*10) (:667-694).

    GT transforms come from the odometry velo2cam chain, refined by the ICP
    cache ``{root}/icp/{drive}_{t0}_{t1}.npy`` when present (the reference
    computes these lazily in __getitem__, :447-470; here
    tools/prepare_icp_cache.py produces them offline).  Baseline items carry
    no APC (the generative branch is APR-only); rotation augmentation uses
    the baseline's pi/4 range (:477 — with the same degrees/radians quirk as
    the complement path).
    """

    MODES = ("time_diff", "nm", "rand_dist")

    def __init__(self, config: APRConfig, phase: str, mode: str,
                 splits: Optional[Dict[str, List[int]]] = None):
        assert mode in self.MODES, mode
        self.config = config
        self.phase = phase
        self.mode = mode
        self.root = config.kitti_root
        self.rng = np.random.RandomState(config.seed)
        self.icp_path = os.path.join(self.root, "icp")
        # the reference's baselines never rotate: every KITTI*PairDataset
        # __init__ sets TEST_RANDOM_ROTATION = False before
        # PairDataset.__init__ (data_loaders.py:291,302-305,556,649), at
        # every phase
        self.random_rotation = False
        self.drives = (splits or DEFAULT_SPLITS)[phase]
        self.poses: Dict[int, np.ndarray] = {}
        self.files: List[Tuple[int, int, int]] = []
        self._prepare()

    _seq_dir = KittiComplementDataset._seq_dir
    _velodyne_fn = KittiComplementDataset._velodyne_fn
    _frame_ids = KittiComplementDataset._frame_ids
    _get_xyz = KittiComplementDataset._get_xyz

    def _get_poses(self, drive: int) -> np.ndarray:
        if drive not in self.poses:
            self.poses[drive] = load_odometry_poses(self.root, drive)
        return self.poses[drive]

    def _prepare(self):
        c = self.config
        np.random.seed(0)
        for drive in self.drives:
            inames = self._frame_ids(drive)
            if not inames:
                log.warning("no frames for drive %02d under %s", drive,
                            self.root)
                continue
            iset = set(inames)
            if self.mode == "time_diff":
                for t in inames:
                    for dt in range(2, c.kitti_max_time_diff):
                        if t + dt in iset:
                            self.files.append((drive, t, t + dt))
                continue
            ts = self._get_poses(drive)[:, :3, 3]
            curr = inames[0]
            while curr in iset:
                if self.mode == "nm":
                    need, window = 10.0, 100
                else:
                    need = 5.0 + np.random.rand() * 40.0
                    window = int(need * 10)
                d = np.linalg.norm(ts[curr:curr + window] - ts[curr], axis=1)
                beyond = np.where(d > need)[0]
                if len(beyond) == 0:
                    curr += 1
                    continue
                nxt = beyond[0] + curr - 1
                if nxt in iset:
                    self.files.append((drive, curr, nxt))
                    curr = nxt + 1
                else:
                    curr += 1
        if self.mode == "nm" and (8, 15, 58) in self.files:
            self.files.remove((8, 15, 58))
        log.info("KITTI baseline (%s) %s: %d pairs", self.mode, self.phase,
                 len(self.files))

    def _gt_transform(self, drive: int, t0: int, t1: int) -> np.ndarray:
        fn = os.path.join(self.icp_path, "%d_%d_%d.npy" % (drive, t0, t1))
        if os.path.exists(fn):
            return np.load(fn)
        # unrefined odometry chain (the ICP cache's initialization, :455-456)
        poses = self._get_poses(drive)
        v2c = velo2cam_matrix()
        m = (v2c @ poses[t0].T @ np.linalg.inv(poses[t1].T)
             @ np.linalg.inv(v2c)).T
        if not getattr(self, "_warned_icp", False):
            log.warning("ICP cache missing under %s; using unrefined "
                        "odometry GT (run tools/prepare_icp_cache.py)",
                        self.icp_path)
            self._warned_icp = True
        return m

    def __len__(self):
        return len(self.files)

    def get_pair(self, index: int) -> Dict[str, np.ndarray]:
        c = self.config
        drive, t0, t1 = self.files[index]
        xyz0 = self._get_xyz(drive, t0)
        xyz1 = self._get_xyz(drive, t1)
        trans = self._gt_transform(drive, t0, t1)

        if self.random_rotation:
            t0_aug = _sample_random_trans(xyz0, self.rng, np.pi / 4)
            t1_aug = _sample_random_trans(xyz1, self.rng, np.pi / 4)
            trans = t1_aug @ trans @ np.linalg.inv(t0_aug)
            xyz0 = _apply(xyz0, t0_aug)
            xyz1 = _apply(xyz1, t1_aug)

        if c.random_scale and self.rng.rand() < 0.95 and self.phase == "train":
            scale = c.min_scale + (c.max_scale - c.min_scale) * self.rng.rand()
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1
            trans = trans.copy()
            trans[:3, 3] *= scale

        empty = np.zeros((0, 3), np.float32)
        return dict(
            points0=xyz0.astype(np.float32),
            points1=xyz1.astype(np.float32),
            apc0=empty,
            apc1=empty,
            t_gt=trans.astype(np.float32),
            meta=np.asarray([drive, t0, t1]),
        )


def _apply(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    # the reference's apply_transform casts the transform to float32 BEFORE
    # the product (complement_data_loader.py:65-70); so does this
    t = t.astype(np.float32)
    return points @ t[:3, :3].T + t[:3, 3]


def _sample_random_trans(pcd: np.ndarray, rng, rotation_range: float = 360):
    """Reference sample_random_trans parity (complement_data_loader.py:29-38):
    random axis, angle = rotation_range * pi/180 * U(-0.5, 0.5), and the
    translation R @ (-mean) re-centers the rotated cloud at the origin.
    The same draws and the same expm(cross(I, axis/|axis| * theta)) as the
    reference (:mod:`apr_torch.geometry.rotation` for scipy's ``expm`` and
    ``norm``)."""
    axis = rng.rand(3) - 0.5
    theta = rotation_range * np.pi / 180.0 * (rng.rand(1) - 0.5)
    r = expm(np.cross(np.eye(3), axis / vector_norm(axis) * theta))
    t = np.eye(4)
    t[:3, :3] = r
    t[:3, 3] = r.dot(-np.mean(pcd, axis=0))
    return t
