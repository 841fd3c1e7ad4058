"""The Predator training loop (port of ``apr_tpu/training/predator_loop.py``).

Per epoch: iterate the pairs in an order drawn from
``np.random.default_rng(seed)``, train, validate with the circle-loss and
recall metrics, save the ``best_loss`` / ``best_recall`` snapshots and the
numbered checkpoint, then the saliency latch: once validation recall
exceeds 0.3, ``w_saliency`` goes from 0 to 1 and stays there (the
reference's trainer.py:370-374).  The latch is applied after the epoch's
checkpoints, so their meta holds the weight the epoch trained with, as the
reference's do.

The reference stacks one pair per mesh device into a group; here a group
is one pair per rank of the data-parallel mesh (``num_devices`` > 1, or the
launcher's process group), and one pair on one device.  Every rank's
``_group_iter`` reads every pair of each group, in order (the datasets'
draws advance per read), and keeps its own; a ragged tail is padded by
repeating its last pair, and the loop weights the padding pairs 0.
Validation runs the full groups sharded and the ragged tail pair by pair
on every rank.  Rank 0 alone writes files, each followed by a barrier.
With ``fused_build`` each iteration steps on the carried group and then
builds the next one; the last carried group is stepped after the loader
ends, with no build.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.datasets import make_dataset
from apr_torch.data.pipeline import prefetched
from apr_torch.data.synthetic import pad_points
from apr_torch.device import resolve_device
from apr_torch.training.checkpoints import CheckpointManager
from apr_torch.parallel.mesh import replicate
from apr_torch.training.loop import Meters, MetricsLogger, RankZero, \
    world_mesh
from apr_torch.training.predator import KPPairBatch, PredatorTrainer, \
    make_kp_pair_batch
from apr_torch.utils.timer import Timer

log = logging.getLogger(__name__)


def pair_to_raw(pair, config: APRConfig):
    """One pair dict -> the nine padded numpy arrays of its build."""
    p0, m0 = pad_points(pair["points0"], config.point_capacity)
    p1, m1 = pad_points(pair["points1"], config.point_capacity)
    a0, am0 = pad_points(pair["apc0"], config.apc_capacity)
    a1, am1 = pad_points(pair["apc1"], config.apc_capacity)
    return (p0, m0, p1, m1, a0, am0, a1, am1,
            pair["t_gt"].astype(np.float32))


def pair_to_kp_batch(pair, config: APRConfig, device="cuda") -> KPPairBatch:
    """One pair's :class:`KPPairBatch` (an overflowed windowed search
    reruns exactly)."""
    return make_kp_pair_batch(
        *pair_to_raw(pair, config),
        first_subsampling_dl=config.first_subsampling_dl,
        conv_radius=config.conv_radius,
        capacities=tuple(config.kp_capacities),
        neighbor_limits=tuple(config.neighborhood_limits),
        overlap_radius=config.overlap_radius, device=device)


def stack_trees(trees):
    """Trees of tensors (nested tuples / NamedTuples) of one structure ->
    one tree with a new leading dim."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    items = [stack_trees(xs) for xs in zip(*trees)]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def pair_weights(n_real: int, group: int, device) -> torch.Tensor:
    """Each pair's weight in a group: 1 / n_real for the real pairs, 0 for
    the repetition padding."""
    w = torch.zeros(group, dtype=torch.float32)
    w[:n_real] = 1.0 / n_real
    return w.to(device)


def _group_iter(dataset, indices, config: APRConfig, group: int,
                prefetch: int = 2, pad_tail: bool = True, raw: bool = False,
                device="cuda", mesh=None):
    """``group``-pair batches built by a background thread ahead of the
    consumer: (a group :class:`KPPairBatch`, n_real), or with ``raw`` the
    nine stacked [group, ...] arrays on the device for the fused build.  A
    ragged tail group repeats its last pair (or, without ``pad_tail``, is
    dropped).  With a ``mesh`` every rank reads every pair of a group and
    keeps its own slice of it."""
    indices = list(indices)
    groups = [indices[i:i + group] for i in range(0, len(indices), group)]
    if groups and not pad_tail and len(groups[-1]) < group:
        groups.pop()

    def build(idxs):
        n_real = len(idxs)
        idxs = list(idxs) + [idxs[-1]] * (group - len(idxs))
        pairs = [dataset.get_pair(int(i)) for i in idxs]
        if mesh is not None:
            k = group // mesh.size
            pairs = pairs[mesh.rank * k:(mesh.rank + 1) * k]
        if raw:
            per_raw = [pair_to_raw(p, config) for p in pairs]
            return tuple(torch.as_tensor(np.stack(col), device=device)
                         for col in zip(*per_raw)), n_real
        return stack_trees([pair_to_kp_batch(p, config, device)
                            for p in pairs]), n_real

    yield from prefetched(groups, build, prefetch, device)


def run_predator_training(config: APRConfig,
                          max_epochs: Optional[int] = None,
                          device="cuda") -> Dict:
    """Train per ``config`` on ``device`` (on several devices, this rank's
    share); returns the summary: the last val means, the last epoch's step
    timer average, training wall seconds and steps, the best circle loss
    and recall, the saliency weight and the step count."""
    dev = resolve_device(device)
    world = world_mesh(config, dev)
    if world is not None:
        dev = world.device
    out = RankZero(world)
    if out.writes:
        os.makedirs(config.out_dir, exist_ok=True)

    # neighbourhood calibration (reference Predator_APR/main.py:94-111):
    # when the config does not pin the limits, histogram the train set and
    # cap each layer at the 80th-percentile neighbour count
    train_ds = make_dataset(config, "train")
    if not config.neighborhood_limits_pinned:
        from apr_torch.eval.predator_tester import calibrate_neighbors

        limits = calibrate_neighbors(train_ds, config, device=dev)
        log.info("calibrated neighborhood_limits: %s", limits)
        config.neighborhood_limits = limits
    if out.writes:
        config.save_json(os.path.join(config.out_dir, "config.json"))
    out.done()

    trainer = PredatorTrainer(config, device=dev, seed=config.seed)
    val_ds = make_dataset(config, "val")
    group, mesh = 1, None
    if world is not None:
        n = min(config.num_devices or world.size, world.size)
        mesh = world if n == world.size else world.split(world.ranks[:n])
        if not mesh.member:
            log.info("rank %d is outside the %d-device mesh: no step",
                     world.rank, n)
            return {"steps": 0}
        trainer.use_mesh(mesh)
        group = mesh.size
        out = RankZero(mesh)

    mngr = CheckpointManager(config.out_dir) if out.writes else None
    metrics_log = MetricsLogger(config.out_dir) if out.writes else None

    start_epoch = 0
    w_saliency = float(config.w_saliency_loss)
    best_loss, best_recall = 1e5, -1e5
    if config.resume is not None and os.path.isdir(config.resume):
        rm = CheckpointManager(config.resume)
        if rm.latest_epoch() is not None:
            _, meta = rm.restore(trainer)
            start_epoch = int(meta["epoch"])
            w_saliency = float(meta.get("w_saliency", w_saliency))
            best_loss = float(meta.get("best_loss", best_loss))
            best_recall = float(meta.get("best_recall", best_recall))
    if mesh is not None and config.resume:
        replicate(trainer, mesh)      # rank 0's restore on every rank

    gen = torch.Generator(device=dev).manual_seed(config.seed)
    epochs = max_epochs or config.max_epoch
    rng = np.random.default_rng(config.seed)
    step = trainer.step
    fused = bool(config.fused_build)
    summary: Dict = {}

    for epoch in range(start_epoch, epochs):
        trainer.set_lr(epoch)
        order = rng.permutation(len(train_ds))
        meters = Meters()
        timer = Timer()
        t_train, step_0 = time.perf_counter(), step
        built = built_pw = None
        for batch, n_real in _group_iter(train_ds, order, config, group,
                                         raw=fused,
                                         pad_tail=len(train_ds) <= group,
                                         device=dev, mesh=mesh):
            pw = pair_weights(n_real, group, dev)
            if fused and built is None:
                built, built_pw = trainer.build_batch_group(batch), pw
                continue
            timer.tic()
            if fused:
                m, built = trainer.train_step_batched_fused(
                    built, gen, w_saliency, batch, built_pw)
                built_pw = pw
            else:
                m = trainer.train_step_batched(batch, gen, w_saliency, pw)
            meters.defer(m)
            timer.toc()
            step += 1
            if step % config.stat_freq == 0 and meters.meters:
                scalars = meters.means()
                scalars["step_time"] = timer.avg
                if out.writes:
                    metrics_log.write("train", step, scalars)
                log.info("epoch %d step %d loss %.4f (%.2fs/it)", epoch,
                         step, scalars["loss"], timer.avg)
        if built is not None:
            # the last carried group: its step, and no next build
            timer.tic()
            meters.defer(trainer.train_step_batched(built, gen, w_saliency,
                                                    built_pw))
            timer.toc()
            step += 1
        meters.defer(None)    # waits for the last step
        if meters.meters and out.writes:
            metrics_log.write("train_epoch", epoch, meters.means())
        summary.update(step_time=timer.avg,
                       train_seconds=time.perf_counter() - t_train,
                       train_steps=step - step_0)

        # validation: full groups, then the ragged tail pair by pair
        # (repetition padding would bias the means)
        vmeters = Meters()
        n_full = (len(val_ds) // group) * group
        for batch, _ in _group_iter(val_ds, range(n_full), config, group,
                                    device=dev, mesh=mesh):
            vmeters.update(trainer.valid_step_batched(batch, gen,
                                                      w_saliency))
        for i in range(n_full, len(val_ds)):
            vmeters.update(trainer.valid_step(
                pair_to_kp_batch(val_ds.get_pair(i), config, dev), gen,
                w_saliency))
        vs = vmeters.means()
        if out.writes:
            metrics_log.write("val", epoch, vs)
        log.info("val epoch %d: %s", epoch,
                 {k: round(v, 4) for k, v in vs.items()})

        # snapshots: best circle loss / best recall (trainer.py:359-368)
        extra = dict(w_saliency=w_saliency, best_loss=best_loss,
                     best_recall=best_recall)
        if vs.get("circle_loss", 1e9) < best_loss:
            best_loss = vs["circle_loss"]
            extra["best_loss"] = best_loss
            if out.writes:
                mngr.save(epoch + 1, trainer, extra=extra, tag="best_loss")
        if vs.get("recall", -1e9) > best_recall:
            best_recall = vs["recall"]
            extra["best_recall"] = best_recall
            if out.writes:
                mngr.save(epoch + 1, trainer, extra=extra,
                          tag="best_recall")
        if out.writes:
            mngr.save(epoch + 1, trainer, extra=extra)
        out.done()

        # the saliency latch: one way, and a configured nonzero weight is
        # never lowered
        if vs.get("recall", 0.0) > 0.3:
            w_saliency = max(w_saliency, 1.0)
        summary["last_val"] = vs

    summary["steps"] = step
    summary["best_loss"] = best_loss
    summary["best_recall"] = best_recall
    summary["w_saliency"] = w_saliency
    return summary
