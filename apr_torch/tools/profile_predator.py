"""Stage split of the Predator eval pipeline on the card (the counterpart
of the root ``tools/profile_predator.py``).

Stages, each cumulative:
  encoder   the KPConv encoder over both clouds (with its skips)
  fwd       the KPFCNN forward (encoder + GCN + decoder + heads)
  match     + overlap*saliency Gumbel sampling + feature-NN correspondences
  full      + the 32k-hypothesis RANSAC + RTE/RRE (the tester's step)

Each stage runs K chained iterations, each on the pair's pyramids with
every level's points jittered (1e-4) from seed and the previous output,
read three ways (``apr_torch/utils/profiling.py::time_stage``).  Every
stage returns all of its outputs.  The tester's step reads RANSAC's
escalation on the host, so ``full`` is timed by wall and busy ms only.
The path launches neither K1 nor K2.

    python -m apr_torch.tools.profile_predator [--iters 8]
        [--caps 16384,4096,2048,1024] [--points 30000] [--device cuda]
"""

import argparse
import sys

import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.eval.predator_tester import PredatorTester, weighted_sample
from apr_torch.models.kpfcnn import stack_pair
from apr_torch.registration.matching import feature_nn_correspondences
from apr_torch.training.predator import PredatorTrainer
from apr_torch.utils.profiling import checksum, device_line, difference, \
    time_stage

# the reference's fixed sizes besides its flags
CONFIG = dict(trainer="PredatorTrainer", point_capacity=32768,
              neighborhood_limits=(40, 40, 40, 40),
              test_num_ransac_hypotheses=32768)


def jitter_pyramids(batch, out, i: int):
    """``batch`` with every level's points of both pyramids moved by 1e-4
    noise from seed ``i`` plus 1e-30 of the previous output's checksum."""
    dep = checksum(out) * 1e-30
    g = torch.Generator(batch.pyr0.levels[0].points.device).manual_seed(i)

    def moved(pyr):
        return pyr._replace(levels=tuple(
            lv._replace(points=lv.points + dep + 1e-4 * torch.randn(
                lv.points.shape, generator=g, device=lv.points.device))
            for lv in pyr.levels))

    return batch._replace(pyr0=moved(batch.pyr0), pyr1=moved(batch.pyr1))


def stages(tester: PredatorTester, generator):
    """The stages by the reference's labels; each a function of the batch
    that returns all it computed."""
    model, c = tester.trainer.model, tester.config

    def encoder(b):
        return model.encoder(stack_pair(b.pyr0, b.pyr1))

    def match(b):
        out = model(b.pyr0, b.pyr1)
        m0, m1 = b.pyr0.levels[0].mask, b.pyr1.levels[0].mask
        u0, u1 = (torch.clamp(torch.rand(m.shape, generator=generator,
                                         device=m.device), min=1e-12)
                  for m in (m0, m1))
        s0 = weighted_sample(out.overlap0 * out.saliency0, m0,
                             c.test_subsample, u0)
        s1 = weighted_sample(out.overlap1 * out.saliency1, m1,
                             c.test_subsample, u1)
        return feature_nn_correspondences(out.feats0, out.feats1, s0, s1)

    return {
        "encoder only (incl skips)": (encoder, False),
        "KPFCNN forward": (lambda b: model(b.pyr0, b.pyr1), False),
        "+ sampling + feature match": (match, False),
        "full tester step": (lambda b: tester.step(b, generator), True),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--caps", default="16384,4096,2048,1024")
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    caps = tuple(int(x) for x in args.caps.split(","))
    cfg = APRConfig(**CONFIG, kp_capacities=caps)
    trainer = PredatorTrainer(cfg, device=dev, seed=0)
    tester = PredatorTester(cfg, trainer, device=dev)
    pair = synthetic_pair(seed=0, n_points=args.points, apc_points=4,
                          extent=60.0, distance=15.0)
    batch = tester._pair_to_batch(pair)
    print(f"# profile_predator caps {caps} points {args.points} iters "
          f"{args.iters} KPFCNN-{cfg.first_feats_dim} {cfg.compute_dtype}; "
          f"{device_line(dev)}", flush=True)
    generator = torch.Generator(dev).manual_seed(1)
    rows = {}
    for label, (fn, syncs) in stages(tester, generator).items():
        rows[label], _ = time_stage(label, fn, batch, jitter_pyramids,
                                    args.iters, dev, syncs=syncs,
                                    unit="pair")

    for label, a, b in (
            ("GCN+decoder+heads alone", "KPFCNN forward",
             "encoder only (incl skips)"),
            ("sample+match alone", "+ sampling + feature match",
             "KPFCNN forward"),
            ("RANSAC+errors alone", "full tester step",
             "+ sampling + feature match")):
        print(difference(label, rows[a], rows[b], "pair"), flush=True)
    return list(rows.values())


if __name__ == "__main__":
    main(sys.argv[1:])
