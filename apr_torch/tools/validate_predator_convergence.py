"""End-to-end Predator-APR training-quality validation on synthetic scenes
(the counterpart of the root ``tools/validate_predator_convergence.py``).

Trains the full Predator recipe (circle + overlap / saliency BCE + the NPR
generative branch) from scratch on synthetic LiDAR-like pairs and
evaluates registration recall on HELD-OUT scenes (seeds 1000+) with the
reference eval protocol (overlap * saliency weighted sampling +
feature-NN matching + RANSAC).  The saliency loss joins after half the
steps.  Runs on the card (``--device``, default cuda).

    python -m apr_torch.tools.validate_predator_convergence [--steps 400]
        [--device cuda]
"""

import argparse
import sys
import time

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.eval import PredatorTester
from apr_torch.training.predator import PredatorTrainer

EVAL_SEED_BASE = 1000
TRAIN_SCENE = dict(n_points=12000, apc_points=24000, extent=30.0)
EVAL_SCENE = dict(n_points=12000, apc_points=4, extent=30.0)


def make_config(compute=None, **fields) -> APRConfig:
    """The tool's recipe: KPFCNN first / gnn 64, final 32,
    GenerativeMLP_54 ratio 2, KP caps 8192/2048/1024/512, limits 24, SGD
    0.05 / 0.98, exp_gamma 0.99, 32768 RANSAC hypotheses."""
    kw = dict(
        trainer="PredatorTrainer", final_feats_dim=32, first_feats_dim=64,
        gnn_feats_dim=64, generator_model="GenerativeMLP_54",
        point_generation_ratio=2, first_subsampling_dl=0.5, conv_radius=2.5,
        point_capacity=16384, apc_capacity=16384,
        kp_capacities=(8192, 2048, 1024, 512),
        neighborhood_limits=(24, 24, 24, 24),
        pos_radius=0.6, safe_radius=1.5, overlap_radius=0.6,
        matchability_radius=0.6, max_points=256,
        optimizer="SGD", lr=0.05, sgd_momentum=0.98, exp_gamma=0.99,
        test_subsample=2500, test_num_ransac_hypotheses=32768,
        test_ransac_dist_thresh=0.6)
    if compute:
        kw["compute_dtype"] = compute
    kw.update(fields)
    return APRConfig(**kw)


def raw_pair(pair, cfg: APRConfig):
    """The nine padded arrays of one pair dict."""
    return (*pad_points(pair["points0"], cfg.point_capacity),
            *pad_points(pair["points1"], cfg.point_capacity),
            *pad_points(pair["apc0"], cfg.apc_capacity),
            *pad_points(pair["apc1"], cfg.apc_capacity),
            np.asarray(pair["t_gt"], np.float32))


def train(trainer, batches, steps: int, generator):
    """The tool's loop: pair ``step % len(batches)``, the saliency weight
    1 after half the steps, a line every 50 steps and at the last; every
    logged loss must be finite.  Returns each step's metrics (floats)."""
    t0 = time.time()
    out = []
    for step in range(steps):
        w_sal = 1.0 if step > steps // 2 else 0.0
        m = trainer.train_step(batches[step % len(batches)], generator,
                               w_sal)
        out.append({k: float(v) for k, v in m.items()})
        if step % 50 == 0 or step == steps - 1:
            loss = out[-1]["loss"]
            print(f"# step {step:4d} loss {loss:.4f} circle "
                  f"{out[-1]['circle_loss']:.4f} recall "
                  f"{out[-1]['recall']:.3f}", flush=True)
            assert np.isfinite(loss)
    print(f"# trained {steps} steps in {time.time() - t0:.0f}s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--distance", type=float, default=8.0)
    ap.add_argument("--train_pairs", type=int, default=8)
    ap.add_argument("--eval_pairs", type=int, default=8)
    ap.add_argument("--compute", default=None,
                    help="override compute_dtype (float32 | bfloat16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_config(args.compute)
    trainer = PredatorTrainer(cfg, device=dev, seed=0)
    print(f"# building {args.train_pairs} train batches...", flush=True)
    batches = [trainer.build_batch(raw_pair(synthetic_pair(
        seed=i, distance=args.distance, **TRAIN_SCENE), cfg))
        for i in range(args.train_pairs)]
    train(trainer, batches, args.steps,
          torch.Generator(dev).manual_seed(1))

    tester = PredatorTester(cfg, trainer, device=dev)
    gen = torch.Generator(dev).manual_seed(7)
    succ, rtes, rres = [], [], []
    for i in range(args.eval_pairs):
        pair = synthetic_pair(seed=EVAL_SEED_BASE + i,
                              distance=args.distance, **EVAL_SCENE)
        _, rte, rre, _ = tester.step(tester._pair_to_batch(pair), gen)
        rte, rre = float(rte), float(rre)
        succ.append(rte < 2.0 and rre < 5.0)
        rtes.append(rte)
        rres.append(rre)
        print(f"# eval pair {i}: RTE {rte:.3f} m RRE {rre:.2f} deg "
              f"{'OK' if succ[-1] else 'FAIL'}", flush=True)
    recall = float(np.mean(succ))
    print(f"RESULT recall {recall:.3f} median_rte {np.median(rtes):.3f} "
          f"median_rre {np.median(rres):.3f} on {args.eval_pairs} held-out "
          f"pairs at {args.distance} m")
    return dict(recall=recall, rte=rtes, rre=rres)


if __name__ == "__main__":
    main(sys.argv[1:])
