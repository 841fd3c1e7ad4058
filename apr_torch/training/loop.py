"""The FCGF training loop: epochs, validation, checkpoints, logging (port of
``apr_tpu/training/loop.py``).

Per epoch: set the learning rate, train over the loader, log every
``stat_freq`` steps and the epoch's means, validate every
``val_epoch_freq`` epochs (tracking ``best_val_metric`` and saving the
``best`` checkpoint), then save the numbered checkpoint.  Scalars go to
``metrics.jsonl`` as ``{"phase", "step", **scalars, "t"}`` records.

Metrics are read one step late: turning a device scalar into a float
waits for its step, so step k-1's metrics are read after step k has been
enqueued.  With ``fused_build`` the loader yields raw arrays and each
iteration steps on the carried batch and then builds the next one
(:meth:`FCGFTrainer.train_step_fused`); the epoch's first batch is built
before its first step, and the last carried batch is stepped after the
loader ends, with no build.

Several devices (``num_devices`` > 1, or a process group that the launcher
made: ``torchrun --nproc_per_node N -m apr_torch.train --num_devices N``)
run one process per device.  ``num_devices`` takes the first ranks, and
the data-parallel mesh is the largest count of them that divides
``batch_size``; a rank outside it does no step and writes nothing.
``mesh_n_builders`` > 0 splits them into trainers and builders
(:class:`apr_torch.parallel.BuilderTrainerPipeline`), or, when the split
does not divide the batch, logs a warning and falls back to serial data
parallelism, as the reference does.  Every rank loads the global batch
and keeps its slice (:class:`apr_torch.data.pipeline.PairLoader`);
validation shards when ``val_batch_size`` divides the mesh, and otherwise
every rank runs the whole batch.  The state is equal on every rank; rank 0
alone writes ``config.json``, ``metrics.jsonl`` and the checkpoints, each
followed by a barrier, and a resume or ``weights`` restore is broadcast
from rank 0.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import torch

from apr_torch.config import APRConfig
from apr_torch.data.datasets import make_dataset
from apr_torch.data.pipeline import PairLoader
from apr_torch.device import resolve_device
from apr_torch.parallel.mesh import replicate
from apr_torch.training.checkpoints import CheckpointManager
from apr_torch.training.trainer import get_trainer
from apr_torch.utils.timer import AverageMeter, Timer

log = logging.getLogger(__name__)

_BIGGER_IS_BETTER = {"feat_match_ratio", "hit_ratio", "success"}


class MetricsLogger:
    """JSONL scalar log, appended to ``out_dir/metrics.jsonl``."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")

    def write(self, phase: str, step: int, scalars: Dict[str, float]):
        rec = {"phase": phase, "step": step, **scalars, "t": time.time()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class Meters:
    """Running means of named scalars, fed one step late (see the module
    docstring): :meth:`defer` takes step k's metrics and reads step
    k-1's."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}
        self.pending = None

    def defer(self, metrics) -> None:
        if self.pending is not None:
            self.update(self.pending)
        self.pending = metrics

    def update(self, metrics) -> None:
        for name, v in metrics.items():
            self.meters.setdefault(name, AverageMeter()).update(float(v))

    def means(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}


def world_mesh(config: APRConfig, device: torch.device):
    """The mesh over every rank of a multi-device run: the process group
    this process belongs to, or the launcher's (``torchrun`` sets
    ``WORLD_SIZE``).  None in a process of its own, which is one device:
    there ``num_devices`` and ``mesh_n_builders`` ask for more devices
    than there are, and the run takes the one, as the reference's mesh
    takes the devices present."""
    import torch.distributed as dist

    from apr_torch.parallel.mesh import make_mesh

    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return make_mesh(device)
    if config.mesh_n_builders:
        log.warning("mesh_n_builders=%d incompatible with 1 devices / "
                    "batch_size=%d; falling back to serial DP",
                    config.mesh_n_builders, config.batch_size)
    elif config.num_devices and config.num_devices > 1:
        log.info("num_devices=%d: one process, one device",
                 config.num_devices)
    return None


class RankZero:
    """Rank 0's file writes, each followed by a barrier of ``mesh`` (no
    mesh: one device, no barrier)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.writes = mesh is None or mesh.ranks[mesh.rank] == 0

    def done(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()


class StepProfiler:
    """``torch.profiler`` over the loop's steps [profile_start,
    profile_start + profile_steps] into ``profile_dir`` (a Chrome trace)
    when the config names a directory; otherwise nothing."""

    def __init__(self, config: APRConfig, device: torch.device):
        self.config = config
        self.device = device
        self.prof = None

    def before(self, step: int) -> None:
        c = self.config
        if c.profile_dir and step == c.profile_start and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, step: int) -> None:
        c = self.config
        if self.prof is not None and step == c.profile_start + c.profile_steps:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
        self.prof = None


def fcgf_mesh(config: APRConfig, world, trainer):
    """(the data-parallel mesh, the pipeline or None) of a multi-device
    run; every rank of ``world`` calls it.  The trainer ranks' trainer is
    put on the mesh (its state replicated from the mesh's first member)."""
    ranks = world.ranks[:min(config.num_devices or world.size, world.size)]
    bs = config.batch_size
    if config.mesh_n_builders:
        n_build = config.mesh_n_builders
        n_train = len(ranks) - n_build
        if n_train >= 1 and bs % n_build == 0 and bs % n_train == 0:
            from apr_torch.parallel import BuilderTrainerPipeline

            sub = world if len(ranks) == world.size else world.split(ranks)
            if not sub.member:
                return sub, None
            pipe = BuilderTrainerPipeline(trainer, n_build, sub)
            log.info("mesh pipeline: %d trainers + %d builders", n_train,
                     n_build)
            return pipe.train_mesh, pipe
        log.warning("mesh_n_builders=%d incompatible with %d devices / "
                    "batch_size=%d; falling back to serial DP", n_build,
                    len(ranks), bs)
    n_dev = len(ranks)
    while bs % n_dev:
        n_dev -= 1
    mesh = world if n_dev == world.size else world.split(ranks[:n_dev])
    if n_dev != world.size:
        log.info("mesh uses %d/%d devices (batch_size=%d)", n_dev,
                 world.size, bs)
    if mesh.member:
        trainer.use_mesh(mesh)
    return mesh, None


def run_training(config: APRConfig, max_epochs: Optional[int] = None,
                 device="cuda") -> Dict:
    """Train per ``config`` on ``device`` (on several devices, this rank's
    share); returns the summary: the last epoch's train and val means, its
    data and step timer averages, its training wall seconds and steps, the
    best val metric and its epoch, and the step count."""
    dev = resolve_device(device)
    world = world_mesh(config, dev)
    if world is not None:
        dev = world.device
    out = RankZero(world)
    if out.writes:
        os.makedirs(config.out_dir, exist_ok=True)
        config.save_json(os.path.join(config.out_dir, "config.json"))
    out.done()

    trainer = get_trainer(config, device=dev, seed=config.seed)
    mesh = pipe = None
    if world is not None:
        mesh, pipe = fcgf_mesh(config, world, trainer)
        builder = pipe is not None and pipe.is_builder
        if not mesh.member and not builder:
            log.info("rank %d is outside the %d-device mesh: no step",
                     world.rank, mesh.size)
            return {"steps": 0}
        out = RankZero(mesh if mesh.member else None)
        out.writes = world.rank == 0
    builder = pipe is not None and pipe.is_builder
    train_ds = make_dataset(config, "train")
    val_ds = make_dataset(config, "val")
    fused = bool(config.fused_build) and pipe is None
    train_loader = PairLoader(train_ds, config, shuffle=True,
                              seed=config.seed, raw=fused or pipe is not None,
                              device=dev,
                              mesh=mesh if pipe is None else None)
    vbs = config.val_batch_size
    val_mesh = mesh if mesh is not None and vbs % mesh.size == 0 else None
    val_loader = PairLoader(val_ds, config, batch_size=vbs, shuffle=False,
                            drop_last=False, device=dev, mesh=val_mesh)

    mngr = CheckpointManager(config.out_dir) if out.writes else None
    metrics_log = MetricsLogger(config.out_dir) if out.writes else None

    start_epoch = 0
    best_val = None
    if config.resume is not None and os.path.isdir(config.resume):
        rm = CheckpointManager(config.resume)
        if rm.latest_epoch() is not None:
            _, meta = rm.restore(trainer)
            start_epoch = int(meta["epoch"])
            best_val = meta.get("best_val")
            log.info("resumed from %s at epoch %d", config.resume,
                     start_epoch)
    elif config.weights is not None:
        CheckpointManager(config.weights).restore_weights_only(trainer)
        log.info("finetune_restart from %s", config.weights)
    if mesh is not None and mesh.member and (config.resume or
                                             config.weights):
        replicate(trainer, mesh)      # rank 0's restore on every rank

    # the step draws restart from the seed, as the reference's key does
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    epochs = max_epochs or config.max_epoch
    step = trainer.step
    bigger = config.best_val_metric in _BIGGER_IS_BETTER
    summary: Dict = {}
    profiler = StepProfiler(config, dev)

    def build(raw):     # the batch the next step takes
        if pipe is not None:
            return pipe.to_trainers(pipe.build(raw))
        return trainer.build_batch(raw)

    try:
        for epoch in range(start_epoch, epochs):
            trainer.set_lr(epoch)
            train_loader.set_epoch(epoch)
            meters = Meters()
            data_timer, step_timer = Timer(), Timer()
            t_train, step_0 = time.perf_counter(), step
            t_iter = iter(train_loader)
            built, carried = None, False
            while True:
                data_timer.tic()
                try:
                    batch = next(t_iter)
                except StopIteration:
                    break
                data_timer.toc()
                if (fused or pipe is not None) and not carried:
                    # counted as data time, so the two timers cover every
                    # build
                    data_timer.tic()
                    built, carried = build(batch), True
                    data_timer.toc()
                    continue
                profiler.before(step)
                step_timer.tic()
                if pipe is not None:
                    # builders start batch i+1, trainers step on batch i,
                    # then the hand-off
                    nxt = pipe.build(batch)
                    if not builder:
                        meters.defer(trainer.train_step(built, gen))
                    built = pipe.to_trainers(nxt)
                elif fused:
                    m, built = trainer.train_step_fused(built, batch, gen)
                    meters.defer(m)
                else:
                    meters.defer(trainer.train_step(batch, gen))
                step_timer.toc()
                profiler.after(step)
                step += 1
                if step % config.stat_freq == 0 and meters.meters:
                    scalars = meters.means()
                    scalars.update(lr=trainer.lr, data_time=data_timer.avg,
                                   step_time=step_timer.avg)
                    if out.writes:
                        metrics_log.write("train", step, scalars)
                    log.info("epoch %d step %d loss %.4f (data %.3fs step "
                             "%.3fs)", epoch, step, scalars["loss"],
                             data_timer.avg, step_timer.avg)
            if carried:
                # the last carried batch: its step, and no next build
                step_timer.tic()
                if not builder:
                    meters.defer(trainer.train_step(built, gen))
                step_timer.toc()
                step += 1
            built = None
            meters.defer(None)    # waits for the last step
            summary.update(data_time=data_timer.avg,
                           step_time=step_timer.avg,
                           train_seconds=time.perf_counter() - t_train,
                           train_steps=step - step_0)
            if builder:
                continue

            epoch_scalars = meters.means()
            if out.writes:
                metrics_log.write("train_epoch", epoch, epoch_scalars)

            if (epoch + 1) % config.val_epoch_freq == 0:
                vmeters = Meters()
                for i, batch in enumerate(val_loader):
                    # a ragged last batch that does not divide the mesh
                    # runs whole on every rank
                    n_i = min(vbs, len(val_ds) - i * vbs)
                    sharded = (val_mesh is not None
                               and n_i == batch.t_gt.shape[0] * mesh.size)
                    vmeters.update(trainer.valid_step(batch, gen,
                                                      sharded=sharded))
                vscalars = vmeters.means()
                if out.writes:
                    metrics_log.write("val", epoch, vscalars)
                log.info("val epoch %d: %s", epoch,
                         {k: round(v, 4) for k, v in vscalars.items()})
                cur = vscalars.get(config.best_val_metric)
                if cur is not None and (best_val is None or (
                        cur > best_val if bigger else cur < best_val)):
                    best_val = cur
                    if out.writes:
                        mngr.save(epoch + 1, trainer,
                                  extra={"best_val": best_val}, tag="best")
                    summary["best_val"] = best_val
                    summary["best_epoch"] = epoch
                summary["last_val"] = vscalars

            if out.writes:
                mngr.save(epoch + 1, trainer, extra={"best_val": best_val})
            out.done()
            summary["last_train"] = epoch_scalars
    finally:
        profiler.close()

    summary["steps"] = step
    return summary
