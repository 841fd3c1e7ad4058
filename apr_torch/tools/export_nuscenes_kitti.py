"""nuScenes -> KITTI-format converter (the counterpart of the root
``tools/export_nuscenes_kitti.py``).

Walks every nuScenes log of a split and writes each LiDAR sweep of its
key frames as a KITTI-style velodyne ``.bin`` (x, y, z, intensity as
float32) plus one ``poses.npy`` a sequence, the float64 lidar -> world
4x4 of each frame (ego pose @ calibrated sensor), under
``{out_root}/{split}/sequences/{log_name}/``: the layout
``apr_torch/data/nuscenes.py`` reads.

Host numpy only: the conversion touches no card, so it takes no
``--device`` and ``chip_smoke.py`` has no phase for it.  It needs the
nuscenes-devkit, imported inside :func:`main` only, so nothing else of the
package depends on it.

    python -m apr_torch.tools.export_nuscenes_kitti --nusc_root /data/nuscenes
        --out_root ./data/nuscenes --split train
"""

import argparse
import os
import sys

import numpy as np


def quaternion_matrix(w, x, y, z) -> np.ndarray:
    """Rotation matrix [3, 3] of a quaternion (w, x, y, z), normalised by
    its squared norm on the way (the identity for a zero quaternion)."""
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def pose_matrix(translation, rotation_wxyz) -> np.ndarray:
    """The float64 4x4 of a translation and a (w, x, y, z) rotation."""
    t = np.eye(4)
    t[:3, :3] = quaternion_matrix(*rotation_wxyz)
    t[:3, 3] = translation
    return t


def export_scene(nusc, scene, nusc_root: str, seq_dir: str) -> int:
    """Write one scene's frames and poses into ``seq_dir``; returns the
    number of frames."""
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    poses = []
    token = scene["first_sample_token"]
    frame = 0
    while token:
        sample = nusc.get("sample", token)
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        ego = nusc.get("ego_pose", sd["ego_pose_token"])
        cal = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        poses.append(pose_matrix(ego["translation"], ego["rotation"])
                     @ pose_matrix(cal["translation"], cal["rotation"]))
        scan = np.fromfile(os.path.join(nusc_root, sd["filename"]),
                           dtype=np.float32).reshape(-1, 5)[:, :4]
        scan.astype(np.float32).tofile(
            os.path.join(seq_dir, "velodyne", "%06d.bin" % frame))
        frame += 1
        token = sample["next"]
    np.save(os.path.join(seq_dir, "poses.npy"),
            np.asarray(poses, dtype=np.float64))
    return frame


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nusc_root", required=True)
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--split", default="train",
                    choices=["train", "val", "test"])
    args = ap.parse_args(argv)

    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils.splits import create_splits_logs
    except ImportError as e:
        raise SystemExit(
            "nuscenes-devkit is required for conversion; install it in an "
            "environment with network access and re-run") from e

    nusc = NuScenes(version=args.version, dataroot=args.nusc_root)
    split_logs = create_splits_logs(args.split, nusc)
    for scene in nusc.scene:
        log = nusc.get("log", scene["log_token"])
        if log["logfile"] not in split_logs:
            continue
        seq_dir = os.path.join(args.out_root, args.split, "sequences",
                               scene["name"])
        frames = export_scene(nusc, scene, args.nusc_root, seq_dir)
        print(f"{scene['name']}: {frames} frames")


if __name__ == "__main__":
    main(sys.argv[1:])
