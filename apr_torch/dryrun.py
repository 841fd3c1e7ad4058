"""Multi-device dry run: the data-parallel paths on N ranks at a tiny size
(the counterpart of ``__graft_entry__.py dryrun``).

    python -m apr_torch.dryrun N                # NCCL, one rank per card
    python -m apr_torch.dryrun N --device cpu   # gloo, N CPU processes

It spawns N ranks and runs, data parallel over all of them, one FCGF train
step (a ResUNetFatBN-16 GenerativePairTrainer, one pair per rank), the
builder / trainer pipeline for two steps (N >= 2: N // 2 builders), and
one grouped Predator train step (one pair per rank); rank 0 prints a line
``dryrun_multichip(N): ... ok`` for each.  With ``--device cuda`` (the
default) it needs N cards and raises with fewer: it never stands CPU
processes in for missing cards.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from apr_torch.config import APRConfig


def tiny_config(batch_size: int) -> APRConfig:
    return APRConfig(
        trainer="GenerativePairTrainer", model="ResUNetFatBN",
        model_n_out=16, conv1_kernel_size=3,
        generator_model="GenerativeMLP_4", point_generation_ratio=2,
        batch_size=batch_size, num_pos_per_batch=32,
        num_hn_samples_per_batch=16, voxel_size=1.5, point_capacity=768,
        capacities=(512, 256, 128, 64), apc_capacity=768)


def tiny_predator_config(n_devices: int) -> APRConfig:
    return APRConfig(
        trainer="PredatorTrainer", final_feats_dim=8, first_feats_dim=16,
        gnn_feats_dim=16, dgcnn_k=4, num_head=2, num_kernel_points=15,
        first_subsampling_dl=1.5, generator_model="GenerativeMLP_4",
        point_generation_ratio=2, point_capacity=768, apc_capacity=768,
        kp_capacities=(384, 128, 48, 16),
        neighborhood_limits=(16, 16, 16, 16), max_points=128,
        num_devices=n_devices)


def sample_raw(cfg: APRConfig, seeds):
    """The nine padded numpy arrays of a batch of synthetic pairs."""
    from apr_torch.data.synthetic import pad_points, synthetic_pair

    cols = [[] for _ in range(9)]
    for s in seeds:
        d = synthetic_pair(s, n_points=600, apc_points=600, distance=6.0,
                           extent=25.0)
        p0, m0 = pad_points(d["points0"], cfg.point_capacity)
        p1, m1 = pad_points(d["points1"], cfg.point_capacity)
        a0, am0 = pad_points(d["apc0"], cfg.apc_capacity)
        a1, am1 = pad_points(d["apc1"], cfg.apc_capacity)
        for col, v in zip(cols, (p0, m0, p1, m1, a0, am0, a1, am1,
                                 d["t_gt"].astype(np.float32))):
            col.append(v)
    return tuple(np.stack(c) for c in cols)


def run_rank(mesh, n: int):
    """This rank's share of the dry run; returns rank 0's lines."""
    from apr_torch.parallel import BuilderTrainerPipeline, shard_batch
    from apr_torch.training.predator import PredatorTrainer, \
        make_kp_pair_batch
    from apr_torch.training.predator_loop import stack_trees
    from apr_torch.training.trainer import get_trainer

    dev = mesh.device
    lines = []

    cfg = tiny_config(batch_size=n)
    trainer = get_trainer(cfg, device=dev, seed=0)
    trainer.use_mesh(mesh)
    batch = trainer.build_batch(shard_batch(sample_raw(cfg, range(n)),
                                            mesh))
    metrics = trainer.train_step(batch,
                                 torch.Generator(dev).manual_seed(1))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"FCGF data-parallel loss {loss}")
    lines.append(f"dryrun_multichip({n}): FCGF loss={loss:.4f} ok")

    if n >= 2:
        # builder / trainer split: half the ranks build batch i+1 while
        # the other half steps on batch i
        n_build = n // 2
        pcfg = tiny_config(batch_size=n - n_build)
        ptr = get_trainer(pcfg, device=dev, seed=3)
        raws = [sample_raw(pcfg, [16 + 4 * i + j
                                  for j in range(pcfg.batch_size)])
                for i in range(2)]
        pipe = BuilderTrainerPipeline(ptr, n_build, mesh)
        losses = []
        pipe.run(raws, torch.Generator(dev).manual_seed(4),
                 on_metrics=lambda m: losses.append(float(m["loss"])))
        if not pipe.is_builder and not (
                len(losses) == 2 and all(np.isfinite(losses))):
            raise RuntimeError(f"pipeline losses {losses}")
        if mesh.rank == 0:
            lines.append(f"dryrun_multichip({n}): mesh-pipeline "
                         f"({n - n_build}t+{n_build}b) "
                         f"loss={losses[-1]:.4f} ok")

    # the grouped Predator step: one pair per rank, gradients summed
    kcfg = tiny_predator_config(n)
    ktrainer = PredatorTrainer(kcfg, device=dev, seed=0)
    ktrainer.use_mesh(mesh)
    raw = sample_raw(kcfg, [mesh.rank])
    one = make_kp_pair_batch(
        *(x[0] for x in raw), first_subsampling_dl=kcfg.first_subsampling_dl,
        conv_radius=kcfg.conv_radius, capacities=kcfg.kp_capacities,
        neighbor_limits=kcfg.neighborhood_limits, overlap_radius=3.0,
        device=dev)
    metrics = ktrainer.train_step_batched(
        stack_trees([one]), torch.Generator(dev).manual_seed(2), 0.0)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"Predator data-parallel loss {loss}")
    lines.append(f"dryrun_multichip({n}): Predator loss={loss:.4f} ok")
    return lines


def dryrun_multichip(n: int, device: str = "cuda",
                     deadline: float = 900.0):
    """Spawn ``n`` ranks on ``device`` ("cuda": NCCL, one card each;
    "cpu": gloo) and run :func:`run_rank`; returns rank 0's lines.  Raises
    with fewer than ``n`` cards."""
    from apr_torch.parallel.launch import spawn

    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"dryrun_multichip({n}) needs {n} CUDA "
                               f"devices and has {have}; pass --device cpu "
                               f"for {n} CPU processes")
        devices = [f"cuda:{i}" for i in range(n)]
    elif device == "cpu":
        devices = "cpu"
    else:
        raise ValueError(f"device {device!r}: cpu or cuda")
    return spawn(run_rank, n, args=(n,), devices=devices,
                 deadline=deadline, threads=None if device == "cuda" else 1
                 )[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8,
                    help="ranks (devices) to run on (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for line in dryrun_multichip(args.n, args.device):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
