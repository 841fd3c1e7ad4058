"""End-to-end training-quality validation on synthetic scenes (the
counterpart of the root ``tools/validate_convergence.py``).

Trains the full APR recipe (hardest contrastive + the NPR generative
branch) from scratch on synthetic LiDAR-like pairs and evaluates
registration recall on HELD-OUT scenes (seeds 1000+) with the reference
eval protocol (feature-NN matching + RANSAC).  The learning rate decays
by ``exp_gamma`` every 25 steps: at a constant rate the protocol
overfits its 8 training pairs past ~400 steps.  Runs on the card
(``--device``, default cuda); ``--device cpu`` runs the plain kernels.

    python -m apr_torch.tools.validate_convergence [--steps 400]
        [--distance 8] [--chamfer pallas] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.eval import FeatureTester
from apr_torch.training import get_trainer

STEPS_PER_EPOCH = 25      # the exp_gamma decay cadence
EVAL_SEED_BASE = 1000     # held-out scene seeds; training seeds stay below
SCENE = dict(n_points=7000, extent=30.0)   # every cloud's points and radius
APC_POINTS = 7000                          # the training pairs' APC targets


def make_config(chamfer=None, compute=None, **fields) -> APRConfig:
    """The tool's recipe: ResUNetBN2-32, conv1 5^3, GenerativeMLP_54 ratio
    2, B = 2, caps 8192/4096/2048/1024, SGD lr 0.1; ``chamfer`` /
    ``compute`` override the config's Chamfer mode and compute dtype."""
    kw = dict(
        trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=32,
        conv1_kernel_size=5, generator_model="GenerativeMLP_54",
        point_generation_ratio=2, batch_size=2, num_pos_per_batch=512,
        num_hn_samples_per_batch=128, voxel_size=0.5, point_capacity=8192,
        capacities=(8192, 4096, 2048, 1024), apc_capacity=8192,
        optimizer="SGD", lr=0.1, test_num_ransac_hypotheses=16384,
        test_subsample=4000)
    if chamfer:
        kw["chamfer_mode"] = chamfer
    if compute:
        kw["compute_dtype"] = compute
    kw.update(fields)
    return APRConfig(**kw)


def raw_batch(pairs, cfg: APRConfig):
    """The nine padded arrays of a batch of synthetic pair dicts."""
    cols = [[] for _ in range(9)]
    for d in pairs:
        vals = [*pad_points(d["points0"], cfg.point_capacity),
                *pad_points(d["points1"], cfg.point_capacity),
                *pad_points(d["apc0"], cfg.apc_capacity),
                *pad_points(d["apc1"], cfg.apc_capacity), d["t_gt"]]
        for c, v in zip(cols, vals):
            c.append(v)
    return tuple(np.stack(c) for c in cols)


def train(trainer, batches, steps: int, generator_of, label: str = ""):
    """The tool's loop: ``set_lr`` every STEPS_PER_EPOCH steps, batch
    ``step % len(batches)``, the step's contrastive draws from
    ``generator_of(step)``; a line every 100 steps.  Returns each step's
    metrics (floats)."""
    t0 = time.time()
    out = []
    for step in range(steps):
        if step % STEPS_PER_EPOCH == 0:
            trainer.set_lr(step // STEPS_PER_EPOCH)
        metrics = trainer.train_step(batches[step % len(batches)],
                                     generator_of(step))
        out.append({k: float(v) for k, v in metrics.items()})
        if (step + 1) % 100 == 0:
            print(f"{label}step {step + 1}: loss={out[-1]['loss']:.4f} "
                  f"chamfer={out[-1].get('chamfer_loss', 0.0):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--distance", type=float, default=8.0)
    ap.add_argument("--eval_pairs", type=int, default=8)
    ap.add_argument("--chamfer", default=None,
                    help="override chamfer_mode (default: config default)")
    ap.add_argument("--compute", default=None,
                    help="override compute_dtype (float32 | bfloat16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_config(args.chamfer, args.compute)
    print(f"# chamfer={cfg.chamfer_mode} compute={cfg.compute_dtype} "
          f"steps={args.steps} dist={args.distance}", flush=True)
    trainer = get_trainer(cfg, device=dev, seed=0)

    def scene(s, apc_points):
        return synthetic_pair(s, distance=args.distance,
                              apc_points=apc_points, **SCENE)

    batches = [trainer.build_batch(raw_batch(
        [scene(2 * i, APC_POINTS), scene(2 * i + 1, APC_POINTS)], cfg))
        for i in range(4)]
    train(trainer, batches, args.steps,
          lambda step: torch.Generator(dev).manual_seed(step))

    tester = FeatureTester(cfg, trainer, device=dev)
    pairs = [scene(EVAL_SEED_BASE + s, 4)
             for s in range(args.eval_pairs)]
    s = tester.test(pairs, pipelined=False).summary()
    print(f"RESULT recall={s['recall']:.3f} "
          f"rte_mean={s.get('rte_mean', float('nan')):.3f} "
          f"rre_mean={s.get('rre_mean', float('nan')):.3f} "
          f"n={s['n_pairs']}")
    return s


if __name__ == "__main__":
    main(sys.argv[1:])
