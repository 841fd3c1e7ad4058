"""Fill the ICP transform cache of the KITTI odometry-pose path (the
counterpart of the root ``tools/prepare_icp_cache.py``).

The reference computes these transforms lazily inside its first training
epoch; this tool runs that stage ahead of time and writes the reference's
layout, ``{kitti_root}/icp/{drive}_{t_src}_{t_key}.npy`` (float64 [4, 4]),
for every train pair of ``--phase`` (odometry init, then ICP on 5 cm
dedups) and every complement frame of each side (multiway pose-graph
registration, or per-complement ICP with ``--pairwise``).  Files that exist
are kept.  ``KittiComplementDataset(use_old_pose=True)`` and the FCGF
baseline loaders read them.  Every ICP correspondence search is one launch
of kernel K2 on the card (``--device``, default cuda; ``--device cpu``
runs its plain version).

    python -m apr_torch.tools.prepare_icp_cache --kitti_root ./data/kitti \\
        --phase train [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

from apr_torch.config import APRConfig
from apr_torch.data.kitti import KittiComplementDataset, velo2cam_matrix
from apr_torch.data.multiway import _voxel_dedup, \
    multiway_complement_transforms
from apr_torch.device import resolve_device
from apr_torch.geometry.icp import registration_icp


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="apr_torch ICP cache builder")
    ap.add_argument("--kitti_root", required=True)
    ap.add_argument("--phase", default="train",
                    choices=["train", "val", "test"])
    ap.add_argument("--pair_min_dist", type=float, default=5.0)
    ap.add_argument("--pair_max_dist", type=float, default=20.0)
    ap.add_argument("--complement_pair_dist", type=float, default=10.0)
    ap.add_argument("--num_complement_one_side", type=int, default=3)
    ap.add_argument("--icp_voxel_size", type=float, default=0.05)
    ap.add_argument("--pairwise", action="store_true",
                    help="per-complement pairwise ICP instead of multiway "
                         "pose-graph registration (the reference's "
                         "debug_use_old_complement path)")
    ap.add_argument("--device", default="cuda")
    return ap


def odo_init(v2c: np.ndarray, pos_src: np.ndarray,
             pos_tgt: np.ndarray) -> np.ndarray:
    """Frame src -> frame tgt from the odometry camera poses through the
    velo2cam chain."""
    return (v2c @ pos_src.T @ np.linalg.inv(pos_tgt.T)
            @ np.linalg.inv(v2c)).T


def main(argv=None):
    """Write the missing cache entries; returns {"written": n, "icp_path":
    the cache directory}."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = APRConfig(
        kitti_root=args.kitti_root,
        use_old_pose=True,
        pair_min_dist=args.pair_min_dist,
        pair_max_dist=args.pair_max_dist,
        complement_pair_dist=args.complement_pair_dist,
        num_complement_one_side=args.num_complement_one_side,
    )
    ds = KittiComplementDataset(cfg, args.phase)
    os.makedirs(ds.icp_path, exist_ok=True)
    v2c = velo2cam_matrix()

    def dedup(x):
        return _voxel_dedup(x, args.icp_voxel_size, dev)

    n_done = 0
    for entry in ds.files:
        if ds.load_neighbourhood:
            drive, t0, t1, cmpl0, cmpl1 = entry
        else:
            drive, t0, t1 = entry[:3]
            cmpl0 = cmpl1 = []
        poses = ds._get_poses(drive)

        # the pair's GT: odometry init, refined by ICP
        fn = os.path.join(ds.icp_path, "%d_%d_%d.npy" % (drive, t0, t1))
        if not os.path.exists(fn):
            reg = registration_icp(
                dedup(ds._get_xyz(drive, t0)), dedup(ds._get_xyz(drive, t1)),
                0.2, odo_init(v2c, poses[t0], poses[t1]), max_iteration=200,
                device=dev,
            )
            np.save(fn, reg.transformation)
            n_done += 1

        # each side's complement transforms
        for t_key, t_cmpls in ((t0, cmpl0), (t1, cmpl1)):
            if not t_cmpls:
                continue
            missing = [
                t_c for t_c in t_cmpls
                if not os.path.exists(os.path.join(
                    ds.icp_path, "%d_%d_%d.npy" % (drive, t_c, t_key)))
            ]
            if not missing:
                continue
            xyz_key = ds._get_xyz(drive, t_key)
            xyz_cmpls = [ds._get_xyz(drive, t) for t in t_cmpls]
            inits = [odo_init(v2c, poses[t], poses[t_key]) for t in t_cmpls]
            if args.pairwise:
                key_ds = dedup(xyz_key)
                ms = [registration_icp(dedup(x), key_ds, 0.2, init,
                                       max_iteration=200,
                                       device=dev).transformation
                      for x, init in zip(xyz_cmpls, inits)]
            else:
                ms = multiway_complement_transforms(
                    xyz_key, xyz_cmpls, inits,
                    cfg.num_complement_one_side, args.icp_voxel_size,
                    device=dev,
                )
            for t_c, m in zip(t_cmpls, ms):
                np.save(os.path.join(
                    ds.icp_path, "%d_%d_%d.npy" % (drive, t_c, t_key)), m)
                n_done += 1
    print(f"wrote {n_done} cache entries to {ds.icp_path}")
    return {"written": n_done, "icp_path": ds.icp_path}


if __name__ == "__main__":
    main(sys.argv[1:])
