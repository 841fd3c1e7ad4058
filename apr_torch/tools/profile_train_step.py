"""Per-stage timing of the FCGF train step at full KITTI scale (the
counterpart of the root ``tools/profile_train_step.py``): the full
``train_step`` and its ablations (the contrastive-only step, the encoder
forward folded and unfolded, the Chamfer forward + backward alone), so the
stage numbers reconcile with the total.

Each stage runs K chained iterations (the trainer's weights carry from
one step to the next; the forward stages feed a multiple of the previous
output back into the features; the Chamfer stage carries its offsets),
read three ways: ``apr_torch/utils/profiling.py::time_stage``.  A train
step reads its finite gate on the host, so the step stages are timed by
wall and busy ms only.  With ``--chamfer pallas`` a step makes 4 launches
of kernel K2, the sustained stage 1 of K1 as well.

    python -m apr_torch.tools.profile_train_step
        [--chamfer exact|pallas|window] [--batch 4] [--ratio 4] [--k 8]
        [--only step,sustained,fused,nogen,fwd,fwd2x,chamfer]
        [--device cuda]
"""

import argparse
import sys

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.losses.generative import npr_reconstruction
from apr_torch.training import get_trainer
from apr_torch.utils.profiling import checksum, device_line, jitter, \
    time_stage

# the reference's fixed sizes
CONFIG = dict(trainer="GenerativePairTrainer", model="ResUNetFatBN",
              model_n_out=128, conv1_kernel_size=5,
              generator_model="GenerativeMLP_98", voxel_size=0.3,
              point_capacity=32768, capacities=(16384, 8192, 4096, 2048),
              apc_capacity=65536)
PAIR = dict(n_points=30000, apc_points=60000, distance=15.0, extent=60.0)
DEFAULT_STAGES = ("step", "nogen", "fwd", "fwd2x", "chamfer")


def make_config(chamfer: str, batch: int, ratio: int) -> APRConfig:
    return APRConfig(**CONFIG, chamfer_mode=chamfer, batch_size=batch,
                     point_generation_ratio=ratio)


def raw_arrays(cfg: APRConfig, device):
    """The nine padded arrays of ``cfg.batch_size`` synthetic pairs."""
    cols = [[] for _ in range(9)]
    for s in range(cfg.batch_size):
        d = synthetic_pair(s, **PAIR)
        vals = [*pad_points(d["points0"], cfg.point_capacity),
                *pad_points(d["points1"], cfg.point_capacity),
                *pad_points(d["apc0"], cfg.apc_capacity),
                *pad_points(d["apc1"], cfg.apc_capacity), d["t_gt"]]
        for c, v in zip(cols, vals):
            c.append(v)
    return tuple(torch.from_numpy(np.stack(c)).to(device) for c in cols)


def _feed(base, out, i):
    """The same batch, its features moved by 1e-9 of the previous output's
    checksum: iteration i reads all of iteration i - 1."""
    c = checksum(out) * 1e-9
    return base._replace(feats0=base.feats0 + c, feats1=base.feats1 + c)


def _carry(base, out, i):
    return out


def stages(cfg: APRConfig, trainer, raw, batch, generator, only):
    """(label, fn, x0, rekey, inference) of each selected stage, in the
    reference's order; every fn returns what it computed."""
    out = []
    if "step" in only:
        out.append(("full train_step",
                    lambda b: trainer.train_step(b, generator), batch,
                    _feed, False))
    if "sustained" in only:
        out.append(("sustained (batch build + step)",
                    lambda p: trainer.train_step(
                        trainer.build_batch((p, *raw[1:])), generator),
                    raw[0], jitter, False))
    if "fused" in only:
        def fused(x):
            b, p = x
            return trainer.train_step_fused(b, (p, *raw[1:]), generator)

        out.append(("fused (step i + build i+1, one program)", fused,
                    (batch, raw[0]),
                    lambda base, o, i: (o[1], jitter(base[1], o[0], i)),
                    False))
    if "nogen" in only:
        tr_c = get_trainer(cfg.replace(trainer="HardestContrastiveLossTrainer"),
                           device=trainer.device, seed=0)
        out.append(("step w/o generative",
                    lambda b: tr_c.train_step(b, generator), batch, _feed,
                    False))
    if "fwd" in only:
        out.append(("encoder fwd (pair-folded)",
                    lambda b: trainer._encode_pair(b, train=False), batch,
                    _feed, True))
    if "fwd2x" in only:
        out.append(("encoder fwd x2 (unfolded)",
                    lambda b: trainer._encode_pair(b, train=False,
                                                   fold=False), batch,
                    _feed, True))
    if "chamfer" in only:
        out.append(chamfer_stage(cfg, batch))
    return out


def chamfer_stage(cfg: APRConfig, batch):
    """The NPR Chamfer's forward and backward over the B x 2 clouds of
    ``batch``'s APC targets from random anchors and offsets (the 2B clouds
    as one batch); the stage carries the offsets moved by 1e-9 of their
    gradient."""
    b, n0, ratio = batch.apc0.shape[0], cfg.capacities[0], \
        cfg.point_generation_ratio
    dev = batch.apc0.device
    g = torch.Generator(dev).manual_seed(1)
    anc = torch.rand((2 * b, n0, 3), generator=g, device=dev) * 60.0
    msk = torch.ones((2 * b, n0), dtype=torch.bool, device=dev)
    apc = torch.cat([batch.apc0, batch.apc1], 0)
    apm = torch.cat([batch.apc0_mask, batch.apc1_mask], 0)
    mo0 = torch.randn((2 * b, n0, 3 * ratio), generator=g, device=dev) * 0.3

    def fwd_bwd(mo):
        mo = mo.detach().requires_grad_(True)
        loss = npr_reconstruction(
            mo, anc, apc, msk, apm, voxel_size=cfg.voxel_size,
            chamfer_mode=cfg.chamfer_mode,
            chamfer_cell_size=cfg.chamfer_cell_multiplier * cfg.voxel_size
        )[0].sum()
        grad, = torch.autograd.grad(loss, mo)
        return (mo + 1e-9 * grad).detach()

    return (f"chamfer fwd+bwd {2 * b}x [{cfg.chamfer_mode}]", fwd_bwd, mo0,
            _carry, False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chamfer", default="window")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ratio", type=int, default=4)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--only", default="",
                    help="comma list: step,nogen,fwd,fwd2x,chamfer,"
                         "sustained,fused.  Default runs all EXCEPT "
                         "sustained and fused (opt-in, as the reference "
                         "has them)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    only = set(args.only.split(",")) if args.only else set(DEFAULT_STAGES)
    cfg = make_config(args.chamfer, args.batch, args.ratio)
    print(f"# chamfer_mode={cfg.chamfer_mode} batch={args.batch} "
          f"recon/cloud={cfg.capacities[0] * args.ratio} "
          f"apc={cfg.apc_capacity} k={args.k}; {device_line(dev)}",
          flush=True)
    trainer = get_trainer(cfg, device=dev, seed=0)
    raw = raw_arrays(cfg, dev)
    batch = trainer.build_batch(raw)
    generator = torch.Generator(dev).manual_seed(3)
    rows = []
    for label, fn, x0, rekey, inference in stages(cfg, trainer, raw, batch,
                                                  generator, only):
        row, _ = time_stage(label, fn, x0, rekey, args.k, dev,
                            inference=inference, unit="step")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
