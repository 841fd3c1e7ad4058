"""RANSAC hard-end study: recall vs hypothesis count vs escalation (the
counterpart of the root ``tools/sweep_ransac.py``).

The reference evaluates with Open3D's adaptive criteria, whose trial count
grows as the inlier ratio falls; the port draws a fixed parallel batch of
hypotheses.  This maps where a fixed batch loses and whether in-program
escalation (``ransac_pose(escalation_factor=...)``) recovers it.

Protocol: controlled correspondence sets of M = 5000 matched pairs with an
EXACT inlier ratio p: p*M true matches under a random SE(3) pose (0.1 m
jitter, inside the 0.3 m threshold), the rest matched to uniform noise.
Recall at ratio p is then P(some sampled 4-tuple is all-inlier and the
scoring picks it); the analytic line 1 - (1 - p^4)^32768 is printed
beside it.  Success is RTE < 2 m and RRE < 5 deg.  The sets are made on
the host (numpy); RANSAC runs on the card (``--device``, default cuda).

    python -m apr_torch.tools.sweep_ransac [--pairs 50] [--m 5000]
        [--ratios 0.02,0.03,0.05,0.08,0.12] [--hyps 8192,32768,131072,262144]
        [--esc_base 32768 --esc_factor 8 --esc_min_inliers 30]
"""

import argparse
import sys
import time

import numpy as np
import torch

from apr_torch.device import resolve_device
from apr_torch.geometry.rotation import euler_matrix
from apr_torch.registration.ransac import ransac_pose


def make_set(rng, m, ratio, extent=40.0, jitter=0.1):
    """(src [m, 3], tgt [m, 3], t_gt [4, 4]) with round(m * ratio) (at
    least 4) inliers; the rotation is scipy's intrinsic ZYX Euler."""
    n_inl = max(int(round(m * ratio)), 4)
    src = rng.uniform(-extent, extent, (m, 3)).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = euler_matrix("ZYX", rng.uniform(-0.5, 0.5, 3)).astype(
        np.float32)
    t[:3, 3] = rng.uniform(-20, 20, 3)
    tgt = (src @ t[:3, :3].T + t[:3, 3]).astype(np.float32)
    tgt += rng.normal(0, jitter / np.sqrt(3), tgt.shape).astype(np.float32)
    outl = rng.permutation(m)[n_inl:]
    tgt[outl] = rng.uniform(-extent, extent, (len(outl), 3)).astype(np.float32)
    return src, tgt.astype(np.float32), t


def errors(t_est, t_gt):
    """(translation error, rotation error in degrees) of two [4, 4]."""
    dt = np.linalg.norm(t_est[:3, 3] - t_gt[:3, 3])
    cos = (np.trace(t_est[:3, :3].T @ t_gt[:3, :3]) - 1) / 2
    dr = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    return dt, dr


def configs_of(hyps, esc_base, esc_factor, esc_rungs, esc_confidence):
    """The sweep's columns: (num_hypotheses, escalation factor, rungs,
    confidence) for each fixed batch, then the escalation column(s)."""
    configs = [(h, 0, 1, 0.0) for h in hyps]
    configs.append((esc_base, esc_factor, 1, 0.0))
    if esc_rungs > 0:
        configs.append((esc_base, esc_factor, esc_rungs, esc_confidence))
    return configs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=50)
    ap.add_argument("--m", type=int, default=5000)
    ap.add_argument("--ratios", default="0.02,0.03,0.05,0.08,0.12")
    ap.add_argument("--hyps", default="8192,32768,131072,262144")
    ap.add_argument("--esc_base", type=int, default=32768)
    ap.add_argument("--esc_factor", type=int, default=8)
    ap.add_argument("--esc_min_inliers", type=int, default=30)
    ap.add_argument("--esc_rungs", type=int, default=0,
                    help="when > 0, add a second escalation column with "
                         "this many rungs + the confidence trigger")
    ap.add_argument("--esc_confidence", type=float, default=0.999)
    ap.add_argument("--thresh", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ratios = [float(x) for x in args.ratios.split(",")]
    hyps = [int(x) for x in args.hyps.split(",")]
    rng = np.random.default_rng(7)
    sets = {r: [make_set(rng, args.m, r) for _ in range(args.pairs)]
            for r in ratios}
    configs = configs_of(hyps, args.esc_base, args.esc_factor,
                         args.esc_rungs, args.esc_confidence)
    print(f"# pairs={args.pairs} m={args.m} thresh={args.thresh} "
          f"success=RTE<2m ∧ RRE<5°", flush=True)
    print(f"# esc config: base={args.esc_base} x{args.esc_factor} when "
          f"best inliers < {args.esc_min_inliers}; conf-trigger column: "
          f"rungs={args.esc_rungs} conf={args.esc_confidence}", flush=True)
    print("ratio  analytic32k " + " ".join(
        f"H={h//1024}k" + ("" if not e else
                           (f"esc{r}c" if c > 0 else "esc"))
        for h, e, r, c in configs), flush=True)
    table = {}
    for r in ratios:
        cells, times = [], []
        for h, esc, rungs, conf in configs:
            # every pair enqueued, one drain per column
            t0 = time.time()
            results = []
            for i, (src, tgt, _) in enumerate(sets[r]):
                gen = torch.Generator(dev).manual_seed(1000 * i + h + esc)
                results.append(ransac_pose(
                    gen, torch.from_numpy(src).to(dev),
                    torch.from_numpy(tgt).to(dev),
                    distance_threshold=args.thresh, num_hypotheses=h,
                    escalation_factor=esc,
                    escalation_min_inliers=args.esc_min_inliers,
                    escalation_rungs=rungs,
                    escalation_confidence=conf).transform)
            transforms = [t.cpu().numpy() for t in results]
            t_total = time.time() - t0
            succ = 0
            for t_est, (_, _, t_gt) in zip(transforms, sets[r]):
                dt, dr = errors(t_est, t_gt)
                succ += int(dt < 2.0 and dr < 5.0)
            cells.append(succ / args.pairs)
            times.append(t_total / args.pairs)
        analytic = 1 - (1 - r ** 4) ** 32768
        table[r] = cells
        print(f"{r:5.2f}  {analytic:10.3f}  "
              + "  ".join(f"{c:.3f}" for c in cells)
              + "   | s/pair: "
              + " ".join(f"{t:.3f}" for t in times), flush=True)
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
