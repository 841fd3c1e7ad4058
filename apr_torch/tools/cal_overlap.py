"""Overlap ratios of every fragment pair of a directory (the counterpart of
the root ``tools/cal_overlap.py``): for each pair of ``*.npy`` clouds in
sorted order, the smaller of the two directed shares of points with a
neighbour in the other cloud within ``--voxel``
(:func:`apr_torch.utils.pointcloud.compute_overlap_ratio`, two K2 launches
on the card).  Writes "name_i name_j ratio" lines, ratio to 6 decimals.

    python -m apr_torch.tools.cal_overlap --dir ./fragments --voxel 0.0625 \\
        [--out overlaps.txt] [--device cuda]
"""

import argparse
import glob
import os
import sys

import numpy as np

from apr_torch.device import resolve_device
from apr_torch.utils.pointcloud import compute_overlap_ratio


def main(argv=None):
    ap = argparse.ArgumentParser(description="apr_torch fragment overlaps")
    ap.add_argument("--dir", required=True,
                    help="directory of .npy fragment point clouds")
    ap.add_argument("--voxel", type=float, default=0.0625)
    ap.add_argument("--out", default="overlaps.txt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    files = sorted(glob.glob(os.path.join(args.dir, "*.npy")))
    clouds = [np.load(f) for f in files]
    with open(args.out, "w") as f:
        for i in range(len(clouds)):
            for j in range(i + 1, len(clouds)):
                ratio = compute_overlap_ratio(clouds[i], clouds[j], np.eye(4),
                                              args.voxel, dev)
                f.write(f"{os.path.basename(files[i])} "
                        f"{os.path.basename(files[j])} {ratio:.6f}\n")
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
