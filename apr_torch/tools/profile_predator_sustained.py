"""Predator sustained train cost, the batch build + the train step at
flagship KITTI shape (the counterpart of the root
``tools/profile_predator_sustained.py``; the KP-side companion of
``profile_train_step --only sustained``).

Two stages: the step on a prebuilt batch, and the build + step, each K
chained iterations (the weights carry from step to step; the sustained
stage jitters the raw points from seed and the previous output), timed by
wall and busy ms (``apr_torch/utils/profiling.py::time_stage``): the KP
build reads its overflow flags and the step its finite gate on the host.
The path launches no K1; with ``chamfer_mode="pallas"`` each step makes 4
launches of K2.

    python -m apr_torch.tools.profile_predator_sustained [--k 8]
        [--points 30000] [--apc 131072] [--symmetric]
        [--radius_select k3|topk|tournament|itermin] [--device cuda]

``--radius_select`` other than ``k3`` (the program's own selection:
kernel K3 on a card) keeps the build's searches on the plain chain with
that k-smallest selector for the time of the run
(``apr_torch/tools/probe_radius_select.py::selector``).
"""

import argparse
import contextlib
import sys

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.tools.probe_radius_select import SELECTORS, selector
from apr_torch.training.predator import PredatorTrainer
from apr_torch.utils.profiling import checksum, device_line, jitter, \
    time_stage

# the reference's fixed sizes (module constants a caller may override;
# apc_points None: half the APC capacity, as the reference draws them)
CONFIG = dict(trainer="PredatorTrainer", point_capacity=32768,
              kp_capacities=(16384, 4096, 2048, 1024),
              neighborhood_limits=(40, 40, 40, 40))
PAIR = dict(seed=0, distance=15.0, extent=60.0, apc_points=None)
W_SALIENCY = 0.0


def raw_arrays(cfg: APRConfig, points: int, device):
    """One pair's nine arrays on ``device``."""
    apc_points = PAIR["apc_points"] or cfg.apc_capacity // 2
    d = synthetic_pair(PAIR["seed"], n_points=points, apc_points=apc_points,
                       distance=PAIR["distance"], extent=PAIR["extent"])
    vals = [*pad_points(d["points0"], cfg.point_capacity),
            *pad_points(d["points1"], cfg.point_capacity),
            *pad_points(d["apc0"], cfg.apc_capacity),
            *pad_points(d["apc1"], cfg.apc_capacity),
            d["t_gt"].astype(np.float32)]
    return tuple(torch.from_numpy(v).to(device) for v in vals)


def stages(trainer: PredatorTrainer, raw, batch, generator):
    """(label, fn, x0, rekey) of both stages; each fn returns the step's
    metrics."""
    def step_again(base, out, i):
        # the same batch; the step reads the previous metrics, so the
        # steps run in order
        dep = checksum(out) * 0
        return base._replace(t_gt=base.t_gt + dep)

    def raw_again(base, out, i):
        p0, m0, p1 = base[:3]
        return (jitter(p0, out, i), m0, jitter(p1, out, i + 10**6),
                *base[3:])

    return [
        ("train step (batch prebuilt)",
         lambda b: trainer.train_step(b, generator, W_SALIENCY), batch,
         step_again),
        ("sustained (build + step)",
         lambda r: trainer.train_step(trainer.build_batch(r), generator,
                                      W_SALIENCY), raw, raw_again),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--apc", type=int, default=131072,
                    help="APC capacity (configs/train/kitti.yaml:75)")
    ap.add_argument("--symmetric", action="store_true",
                    help="KPFCNNDecoder symmetric generator at flagship "
                         "shape (the config the reference declares "
                         "unsupported for memory reasons)")
    ap.add_argument("--radius_select", default="k3",
                    choices=["k3", *sorted(SELECTORS)],
                    help="the radius tables' selection: k3, the program's "
                         "own, or the plain chain with this k-smallest "
                         "selector")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = APRConfig(**{**CONFIG, "apc_capacity": args.apc,
                       "symmetric": args.symmetric})
    if args.symmetric:
        print("# symmetric KPFCNNDecoder generator at flagship shape",
              flush=True)
    print(f"# profile_predator_sustained caps {cfg.kp_capacities} points "
          f"{args.points} APC {cfg.apc_capacity} chamfer "
          f"{cfg.chamfer_mode} selector {args.radius_select} k {args.k}; "
          f"{device_line(dev)}", flush=True)
    trainer = PredatorTrainer(cfg, device=dev, seed=0)
    raw = raw_arrays(cfg, args.points, dev)
    generator = torch.Generator(dev).manual_seed(3)
    rows = []
    with (contextlib.nullcontext() if args.radius_select == "k3"
          else selector(args.radius_select)):
        batch = trainer.build_batch(raw)
        for label, fn, x0, rekey in stages(trainer, raw, batch, generator):
            row, _ = time_stage(label, fn, x0, rekey, args.k, dev,
                                syncs=True, inference=False, unit="step")
            rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
