"""A/B validation of the APR recipe's core claim on synthetic scenes (the
counterpart of the root ``tools/validate_apr_gain.py``).

The claim: adding the APC-reconstruction branch to a contrastive feature
extractor improves distant-pair registration recall.  Two arms share
seeds, data, init and step count:

  arm A ("apr"):      FCGFTrainer with loss_ratio 2e-3: hardest contrastive
                      + Chamfer-vs-APC on the encoder;
  arm B ("baseline"): the same program with loss_ratio 0 (plain FCGF).

Both are evaluated with the reference protocol (feature-NN matching +
RANSAC, RTE < 2 m and RRE < 5 deg) on held-out pairs (seeds 1000+) at
distances beyond the training range; the in-range 12 m set is the
control.  The analysis is paired: per distance, the discordant-pair
counts, a Wald interval of the recall difference and an exact McNemar
test, pooled over ``--seeds`` repetitions (each a disjoint training-scene
pool: scene seeds start at ``seed0 * pool_pairs``).  Prints one RESULT line
per arm, repetition and distance, then one PAIRED line per distance, in
the reference tool's format, so logs of either package pool together
(``python -m apr_torch.tools.pool_apr_gain``).  Runs on the card
(``--device``, default cuda).

    python -m apr_torch.tools.validate_apr_gain [--steps 1500]
        [--eval_pairs 24] [--pool_pairs 96] [--seeds 1] [--seed0 0]
"""

import argparse
import math
import sys
import time

import numpy as np
import torch

from apr_torch.data.synthetic import synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.eval import FeatureTester
from apr_torch.tools.validate_convergence import raw_batch, train
from apr_torch.tools.validate_convergence import make_config as \
    convergence_config
from apr_torch.training import get_trainer

EVAL_SEED_BASE = 1000  # eval scene seeds live at 1000+; train seeds stay below
TRAIN_POINTS = 7000    # points and APC points of each training cloud


def make_config(loss_ratio, **fields):
    """validate_convergence's recipe with the ablated ``loss_ratio``: the
    two arms differ in this one scalar."""
    return convergence_config(loss_ratio=loss_ratio, **fields)


def train_pools(seed0: int, pool_pairs: int, train_dists):
    """(scene seed, distance) of each training pair of repetition
    ``seed0``, two a batch; the pool starts at ``seed0 * pool_pairs`` and
    must stay below the eval seeds."""
    base = seed0 * pool_pairs
    assert base + pool_pairs <= EVAL_SEED_BASE, (
        f"training scene seeds [{base}, {base + pool_pairs}) would overlap "
        f"the eval seed range ({EVAL_SEED_BASE}+): lower --seed0 or "
        f"--pool_pairs")
    n_batches = max(pool_pairs // 2, 1)
    return [[(base + 2 * i + j, train_dists[(2 * i + j) % len(train_dists)])
             for j in (0, 1)] for i in range(n_batches)]


def run_arm(label, cfg, train_dists, eval_sets, steps, pool_pairs, extent,
            max_range, apc_complement_dist, seed0=0, lidar_structured=False,
            device="cuda"):
    """Train one arm on repetition ``seed0``'s pool and evaluate it on
    every eval set: {distance: {"summary", "success"}}.  The weights come
    from ``seed0``; step k draws from its own generator (seed0, k + 1),
    apart from the init's stream."""
    dev = resolve_device(device)
    trainer = get_trainer(cfg, device=dev, seed=seed0)
    batches = [trainer.build_batch(raw_batch([synthetic_pair(
        s, n_points=TRAIN_POINTS, apc_points=TRAIN_POINTS, distance=dist,
        extent=extent,
        max_range=max_range, apc_complement_dist=apc_complement_dist,
        lidar_structured=lidar_structured) for s, dist in group], cfg))
        for group in train_pools(seed0, pool_pairs, train_dists)]
    train(trainer, batches, steps,
          lambda step: torch.Generator(dev).manual_seed(
              seed0 * 2**32 + step + 1),
          label=f"# [{label} seed0={seed0}] ")

    tester = FeatureTester(cfg, trainer, device=dev)
    results = {}
    for dist, pairs in eval_sets.items():
        stats = tester.test(pairs, pipelined=False)
        s = stats.summary()
        results[dist] = {"summary": s,
                         "success": np.asarray(stats.success, dtype=bool)}
        print(f"RESULT arm={label} seed0={seed0} eval_dist={dist} "
              f"recall={s['recall']:.3f} "
              f"rte_mean={s.get('rte_mean', float('nan')):.3f} "
              f"rre_mean={s.get('rre_mean', float('nan')):.3f} "
              f"n={s['n_pairs']}", flush=True)
    return results


def mcnemar_exact_p(n01: int, n10: int) -> float:
    """Two-sided exact McNemar test: under H0 the n01+n10 discordant pairs
    split Binomial(n, 1/2); p = 2 * P(X <= min(n01, n10)), capped at 1."""
    n = n01 + n10
    if n == 0:
        return 1.0
    k = min(n01, n10)
    cdf = sum(math.comb(n, i) for i in range(k + 1)) / (2.0 ** n)
    return min(1.0, 2.0 * cdf)


def paired_delta_ci(n01: int, n10: int, n: int, z: float = 1.96):
    """Wald CI for the paired recall difference (n10 - n01) / n."""
    if n == 0:
        return 0.0, 0.0, 0.0
    d = (n10 - n01) / n
    se = math.sqrt(max(n01 + n10 - (n10 - n01) ** 2 / n, 0.0)) / n
    return d, d - z * se, d + z * se


def paired_line(dist, a: np.ndarray, b: np.ndarray) -> str:
    """The PAIRED line of one distance from the arms' per-pair successes
    (apr ``a``, baseline ``b``)."""
    n = len(a)
    n10 = int(np.sum(a & ~b))   # apr succeeded, baseline failed
    n01 = int(np.sum(~a & b))   # baseline succeeded, apr failed
    d, lo, hi = paired_delta_ci(n01, n10, n)
    p = mcnemar_exact_p(n01, n10)
    return (f"PAIRED eval_dist={dist} apr={a.mean():.3f} "
            f"baseline={b.mean():.3f} delta={d:+.3f} "
            f"ci95=[{lo:+.3f},{hi:+.3f}] "
            f"discordant={n10}/{n01} (apr-only/baseline-only) "
            f"mcnemar_p={p:.4f} n={n}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval_pairs", type=int, default=24)
    ap.add_argument("--pool_pairs", type=int, default=96,
                    help="distinct training scenes (2 per batch)")
    ap.add_argument("--train_dists", default="6,10,14,18")
    ap.add_argument("--eval_dists", default="12,40,48,56")
    ap.add_argument("--eval_points", type=int, default=7000,
                    help="points per eval cloud (sparser = harder)")
    ap.add_argument("--extent", type=float, default=60.0,
                    help="scene radius (m)")
    ap.add_argument("--max_range", type=float, default=35.0,
                    help="sensor visibility radius (m); < extent + distance "
                         "gives distant pairs a shrinking overlap")
    ap.add_argument("--apc_complement_dist", type=float, default=10.0,
                    help="complement-frame spacing for multi-viewpoint APC "
                         "targets; 0 = same-viewpoint densification")
    ap.add_argument("--lidar_structured", action="store_true",
                    help="spherical depth-buffer scans (rings + occlusion "
                         "+ range falloff) instead of thinned uniform "
                         "sampling")
    ap.add_argument("--arms", default="apr,baseline",
                    help="subset of arms to run (apr | baseline)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="independent repetitions seed0..seed0+seeds-1, "
                         "each with a disjoint training-scene pool")
    ap.add_argument("--seed0", type=int, default=0,
                    help="first repetition index; training scene seeds "
                         "start at seed0 * pool_pairs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    train_dists = [float(x) for x in args.train_dists.split(",")]
    eval_dists = [float(x) for x in args.eval_dists.split(",")]
    # held-out scenes shared across arms and repetitions: the analysis is
    # paired
    eval_sets = {
        dist: [synthetic_pair(EVAL_SEED_BASE + 100 * di + s,
                              n_points=args.eval_points, apc_points=4,
                              distance=dist, extent=args.extent,
                              max_range=args.max_range,
                              lidar_structured=args.lidar_structured)
               for s in range(args.eval_pairs)]
        for di, dist in enumerate(eval_dists)}

    arm_labels = args.arms.split(",")
    outcomes = {lab: {d: [] for d in eval_dists} for lab in arm_labels}
    t0 = time.time()
    for rep in range(args.seeds):
        seed0 = args.seed0 + rep
        for label in arm_labels:
            ratio = 2e-3 if label == "apr" else 0.0
            print(f"# arm={label} seed0={seed0} loss_ratio={ratio} "
                  f"steps={args.steps} train_dists={train_dists} "
                  f"eval_dists={eval_dists} "
                  f"apc_complement_dist={args.apc_complement_dist}",
                  flush=True)
            res = run_arm(label, make_config(ratio), train_dists, eval_sets,
                          args.steps, args.pool_pairs, args.extent,
                          args.max_range, args.apc_complement_dist,
                          seed0=seed0,
                          lidar_structured=args.lidar_structured,
                          device=args.device)
            for d in eval_dists:
                outcomes[label][d].append(res[d]["success"])

    lines = []
    if {"apr", "baseline"} <= set(arm_labels):
        print(f"# paired pooled analysis over {args.seeds} repetition(s), "
              f"n = seeds x eval_pairs per distance ({time.time() - t0:.0f}"
              f" s)", flush=True)
        for dist in eval_dists:
            lines.append(paired_line(dist,
                                     np.concatenate(outcomes["apr"][dist]),
                                     np.concatenate(
                                         outcomes["baseline"][dist])))
            print(lines[-1], flush=True)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
