"""Decompose the batch / pyramid build's cost (the counterpart of the root
``tools/profile_pyramid.py``), at the reference's shapes: B = 8 clouds of
N = 32768 uniform points, level 0 capped at 16384 voxels, caps
16384/8192/4096/2048.

The reference timed its single-map fast path (``kernel_map_same_fast``)
against the naive map.  The port builds every map of a pyramid from one
grouped K1 launch instead, so beside the reference's stages this times
the port's pieces, each stage cumulative from the points: the levels,
``pyramid_searches`` + the grouped K1 launch, ``zrun_decode`` of every
map; ``transpose_kernel_map`` and the rest of ``build_pyramid`` are what
the full stage adds.  The differences (busy and wall) are printed at the
end.  Protocol:
``apr_torch/utils/profiling.py::time_stage``.

    python -m apr_torch.tools.profile_pyramid [--device cuda]
"""

import argparse
import sys

import numpy as np
import torch

from apr_torch.device import resolve_device
from apr_torch.models.sparse import SparseLevel, build_pyramid, \
    downsample_level, kernel_map_same, pyramid_searches, zrun_decode, \
    zrun_search
from apr_torch.ops.searchsorted import searchsorted_left, \
    searchsorted_left_many
from apr_torch.ops.voxelize import voxelize
from apr_torch.utils.profiling import device_line, difference, jitter, \
    time_stage

# the reference's fixed sizes (module constants a test may override)
B, N, C0 = 8, 32768, 16384
CAPS = (16384, 8192, 4096, 2048)
VOXEL = 0.3
CONV1 = 5
K = 8


def make_points(device):
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-60, 60, (B, N, 3))
                           .astype(np.float32)).to(device)
    return pts, torch.ones((B, N), dtype=torch.bool, device=device)


def stages(mask):
    """The stages by label, each a function of the points [B, N, 3] that
    returns all it computed."""
    def vox(p):
        return voxelize(p, VOXEL, C0, mask)

    def level0(p):
        g = vox(p)
        return SparseLevel(g.coords, g.keys, g.mask)

    def levels(p):
        out = [level0(p)]
        for cap in CAPS[1:]:
            out.append(downsample_level(out[-1], cap))
        return tuple(out)

    def conv1_zrun(p):
        lv = level0(p)
        s = zrun_search(lv.keys, lv.keys, lv.coords, lv.mask, CONV1)
        return zrun_decode(s, searchsorted_left(s.support, s.t0))

    def searches(p):
        lvs = levels(p)
        named = pyramid_searches(lvs, CONV1)
        return lvs, named, searchsorted_left_many(
            [(s.support, s.t0) for _, s in named])

    def decoded(p):
        lvs, named, j0s = searches(p)
        return lvs, [zrun_decode(s, j0) for (_, s), j0 in zip(named, j0s)]

    return {
        "voxelize x8": vox,
        "voxelize + build_pyramid x8": lambda p: build_pyramid(
            vox(p), CAPS, CONV1),
        "voxelize + downsample levels x8": levels,
        "voxelize + conv1 map naive x8": lambda p: kernel_map_same(
            level0(p), CONV1),
        "voxelize + conv1 map z-run x8": conv1_zrun,
        "voxelize + one 27-off same map x8": lambda p: kernel_map_same(
            level0(p), 3),
        "levels + pyramid_searches + grouped K1 x8": searches,
        "levels + searches + K1 + zrun_decode x8": decoded,
    }


DIFFERENCES = (
    ("downsample levels alone", "voxelize + downsample levels x8",
     "voxelize x8"),
    ("pyramid_searches + grouped K1 alone",
     "levels + pyramid_searches + grouped K1 x8",
     "voxelize + downsample levels x8"),
    ("zrun_decode of every map alone",
     "levels + searches + K1 + zrun_decode x8",
     "levels + pyramid_searches + grouped K1 x8"),
    ("transpose_kernel_map + assembly alone", "voxelize + build_pyramid x8",
     "levels + searches + K1 + zrun_decode x8"),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    pts, mask = make_points(dev)
    print(f"# profile_pyramid B {B} N {N} C0 {C0} caps {CAPS} k {K}; "
          f"{device_line(dev)}", flush=True)
    rows = {}
    for label, fn in stages(mask).items():
        rows[label], _ = time_stage(label, fn, pts, jitter, K, dev,
                                    unit="8 clouds")
    for label, a, b in DIFFERENCES:
        print(difference(label, rows[a], rows[b], "8 clouds"))
    return list(rows.values())


if __name__ == "__main__":
    main(sys.argv[1:])
