"""Stage breakdown of the FCGF device-side batch build (``make_pair_batch``;
the counterpart of the root ``tools/profile_build.py``).

Each stage runs K chained iterations, each on points jittered from the
previous iteration's output, read three ways (device ms from CUDA events,
wall ms on the host clock, busy ms / launches / top kernels from one
profiled iteration: ``apr_torch/utils/profiling.py::time_stage``).  The
full build makes one grouped launch of kernel K1.

    python -m apr_torch.tools.profile_build [--batch 4] [--k 16]
        [--device cuda]
"""

import argparse
import sys

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.models.sparse import SparseLevel, build_pyramid_from_level
from apr_torch.ops.voxelize import dedup_points, voxelize, voxelize_lean
from apr_torch.training.batching import make_pair_batch
from apr_torch.utils.profiling import device_line, jitter, time_stage

# the reference's fixed sizes
CONFIG = dict(voxel_size=0.3, point_capacity=32768,
              capacities=(16384, 8192, 4096, 2048), apc_capacity=65536,
              conv1_kernel_size=5)
PAIR = dict(n_points=30000, apc_points=60000, distance=15.0, extent=60.0)


def raw_arrays(batch: int, cfg: APRConfig, device):
    """The nine padded arrays of ``batch`` synthetic pairs (seeds 0..),
    as tensors on ``device``."""
    cols = [[] for _ in range(9)]
    for s in range(batch):
        d = synthetic_pair(s, **PAIR)
        vals = [*pad_points(d["points0"], cfg.point_capacity),
                *pad_points(d["points1"], cfg.point_capacity),
                *pad_points(d["apc0"], cfg.apc_capacity),
                *pad_points(d["apc1"], cfg.apc_capacity), d["t_gt"]]
        for c, v in zip(cols, vals):
            c.append(v)
    return tuple(torch.from_numpy(np.stack(c)).to(device) for c in cols)


def stages(cfg: APRConfig, raw):
    """The build's stages by the reference's labels, each a function of
    the first cloud's points [B, N, 3] (the input the protocol jitters)
    that returns all it computed."""
    p0, m0, p1, m1, a0, am0, a1, am1, tg = raw
    common = dict(voxel_size=cfg.voxel_size,
                  capacities=tuple(cfg.capacities),
                  conv1_kernel_size=cfg.conv1_kernel_size,
                  corr_cap=cfg.corr_capacity_per_point,
                  search_multiplier=(
                      cfg.positive_pair_search_voxel_size_multiplier),
                  device=p0.device)
    both_m = torch.cat([m0, m1], 0)

    def full(p):
        return make_pair_batch(p, m0, p1, m1, a0, am0, a1, am1, tg, **common)

    def no_corr(p):
        return make_pair_batch(p, m0, p1, m1, a0, am0, a1, am1, tg,
                               with_correspondences=False, **common)

    def pyramids_only(p):
        coords, keys, vmask, _ = voxelize_lean(
            torch.cat([p, p1], 0), cfg.voxel_size, cfg.capacities[0], both_m)
        return build_pyramid_from_level(SparseLevel(coords, keys, vmask),
                                        tuple(cfg.capacities),
                                        cfg.conv1_kernel_size)

    def voxelize_only(p):
        return voxelize_lean(torch.cat([p, p1], 0), cfg.voxel_size,
                             cfg.capacities[0], both_m)

    apc_m = torch.cat([am0, am1], 0)

    def apc_points(p):
        return torch.cat([a0 + p[:, :1, :] * 0, a1], 0)

    def apc_dedup_full(p):
        # the full voxelization and a representative gather per voxel
        apc = apc_points(p)
        n = apc.shape[1]
        g = voxelize(apc, cfg.voxel_size, n, apc_m)
        rep = g.rep.clamp(max=n - 1).long()
        pts = torch.gather(apc, 1, rep[..., None].expand(-1, -1, 3))
        return torch.where((g.rep < n)[..., None], pts, 0.0), g.mask

    def apc_dedup_lean(p):
        return dedup_points(apc_points(p), cfg.voxel_size, apc_m)

    return {
        "full build": full,
        "build w/o GT correspondences": no_corr,
        "pyramids+maps only (2B fold)": pyramids_only,
        "voxelize only (2B fold)": voxelize_only,
        "APC dedup via full voxelize (r3 path)": apc_dedup_full,
        "APC dedup via dedup_points (lean)": apc_dedup_lean,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = APRConfig(**CONFIG)
    raw = raw_arrays(args.batch, cfg, dev)
    print(f"# profile_build batch {args.batch} k {args.k} caps "
          f"{cfg.capacities} points {PAIR['n_points']} APC "
          f"{PAIR['apc_points']}; {device_line(dev)}", flush=True)
    rows = []
    for label, fn in stages(cfg, raw).items():
        row, _ = time_stage(label, fn, raw[0], jitter, args.k, dev,
                            unit="build")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
