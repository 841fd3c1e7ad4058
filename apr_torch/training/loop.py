"""The FCGF training loop: epochs, validation, checkpoints, logging (port of
``apr_tpu/training/loop.py`` on one device).

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


def check_one_device(config: APRConfig) -> None:
    """The loops run on one device; the mesh paths are ROADMAP D3."""
    if config.mesh_n_builders:
        raise NotImplementedError(
            "mesh_n_builders > 0 (the builder / trainer device split) is "
            "ROADMAP item D3")
    if config.num_devices is not None and config.num_devices > 1:
        raise NotImplementedError(
            "num_devices > 1 (data parallel over a mesh) is ROADMAP item D3")


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


def run_training(config: APRConfig, max_epochs: Optional[int] = None,
                 device="cuda") -> Dict:
    """Train per ``config`` on ``device``; returns the summary: the last
    epoch's train and val means, its data and step timer averages, its
    training wall seconds and steps, the best val metric and its epoch,
    and the step count."""
    dev = resolve_device(device)
    check_one_device(config)
    os.makedirs(config.out_dir, exist_ok=True)
    config.save_json(os.path.join(config.out_dir, "config.json"))

    trainer = get_trainer(config, device=dev, seed=config.seed)
    train_ds = make_dataset(config, "train")
    val_ds = make_dataset(config, "val")
    fused = bool(config.fused_build)
    train_loader = PairLoader(train_ds, config, shuffle=True,
                              seed=config.seed, raw=fused, device=dev)
    val_loader = PairLoader(val_ds, config,
                            batch_size=config.val_batch_size, shuffle=False,
                            drop_last=False, device=dev)

    mngr = CheckpointManager(config.out_dir)
    metrics_log = MetricsLogger(config.out_dir)

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

    # the step draws restart from the seed, as the reference's key does
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    epochs = max_epochs or config.max_epoch
    step = trainer.step
    bigger = config.best_val_metric in _BIGGER_IS_BETTER
    summary: Dict = {}
    profiler = StepProfiler(config, dev)
    try:
        for epoch in range(start_epoch, epochs):
            trainer.set_lr(epoch)
            train_loader.set_epoch(epoch)
            meters = Meters()
            data_timer, step_timer = Timer(), Timer()
            t_train, step_0 = time.perf_counter(), step
            t_iter = iter(train_loader)
            built = None
            while True:
                data_timer.tic()
                try:
                    batch = next(t_iter)
                except StopIteration:
                    break
                data_timer.toc()
                if fused and built is None:
                    # counted as data time, so the two timers cover every
                    # build
                    data_timer.tic()
                    built = trainer.build_batch(batch)
                    data_timer.toc()
                    continue
                profiler.before(step)
                step_timer.tic()
                if fused:
                    m, built = trainer.train_step_fused(built, batch, gen)
                else:
                    m = trainer.train_step(batch, gen)
                meters.defer(m)
                step_timer.toc()
                profiler.after(step)
                step += 1
                if step % config.stat_freq == 0 and meters.meters:
                    scalars = meters.means()
                    scalars.update(lr=trainer.lr, data_time=data_timer.avg,
                                   step_time=step_timer.avg)
                    metrics_log.write("train", step, scalars)
                    log.info("epoch %d step %d loss %.4f (data %.3fs step "
                             "%.3fs)", epoch, step, scalars["loss"],
                             data_timer.avg, step_timer.avg)
            if built is not None:
                # the last carried batch: its step, and no next build
                step_timer.tic()
                meters.defer(trainer.train_step(built, gen))
                step_timer.toc()
                step += 1
            built = None
            meters.defer(None)    # waits for the last step

            epoch_scalars = meters.means()
            metrics_log.write("train_epoch", epoch, epoch_scalars)
            summary.update(data_time=data_timer.avg,
                           step_time=step_timer.avg,
                           train_seconds=time.perf_counter() - t_train,
                           train_steps=step - step_0)

            if (epoch + 1) % config.val_epoch_freq == 0:
                vmeters = Meters()
                for batch in val_loader:
                    vmeters.update(trainer.valid_step(batch, gen))
                vscalars = vmeters.means()
                metrics_log.write("val", epoch, vscalars)
                log.info("val epoch %d: %s", epoch,
                         {k: round(v, 4) for k, v in vscalars.items()})
                cur = vscalars.get(config.best_val_metric)
                if cur is not None and (best_val is None or (
                        cur > best_val if bigger else cur < best_val)):
                    best_val = cur
                    mngr.save(epoch + 1, trainer,
                              extra={"best_val": best_val}, tag="best")
                    summary["best_val"] = best_val
                    summary["best_epoch"] = epoch
                summary["last_val"] = vscalars

            mngr.save(epoch + 1, trainer, extra={"best_val": best_val})
            summary["last_train"] = epoch_scalars
    finally:
        profiler.close()

    summary["steps"] = step
    return summary
