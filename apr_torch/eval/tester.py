"""Registration eval harness (port of ``apr_tpu/eval/tester.py``).

Reference protocol (FCGF_APR/scripts/test_apr.py): per test pair, encoder
forward on both clouds; a random 5000-point subsample of cloud 0;
feature-space NN correspondences; feature-matching RANSAC with threshold =
voxel size; RTE/RRE against the ground truth; success = RTE < 2 m and
RRE < 5 deg.  Everything after the host-side padding runs on the device.
A pair's spans (:func:`apr_torch.utils.profiling.span`): the build's
three, ``encode``, ``match`` (the subsample and the feature NN) and
``ransac``.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points
from apr_torch.device import resolve_device
from apr_torch.registration.matching import feature_nn_correspondences
from apr_torch.registration.metrics import registration_errors
from apr_torch.registration.ransac import ransac_from_draws, ransac_pose
from apr_torch.training.batching import make_pair_batch
from apr_torch.utils.profiling import span
from apr_torch.utils.timer import Timer

log = logging.getLogger(__name__)


@dataclass
class TestStats:
    rte: List[float] = field(default_factory=list)
    rre: List[float] = field(default_factory=list)
    success: List[bool] = field(default_factory=list)
    fitness: List[float] = field(default_factory=list)
    sec_per_pair: List[float] = field(default_factory=list)
    pair_dist: List[float] = field(default_factory=list)  # GT frame distance

    def summary(self) -> Dict[str, float]:
        rte = np.asarray(self.rte)
        rre = np.asarray(self.rre)
        succ = np.asarray(self.success, dtype=bool)
        out = dict(
            recall=float(succ.mean()) if len(succ) else 0.0,
            n_pairs=len(succ),
            pairs_per_sec=(
                1.0 / float(np.mean(self.sec_per_pair))
                if self.sec_per_pair else 0.0
            ),
        )
        if succ.any():
            out.update(
                rte_mean=float(rte[succ].mean()),
                rte_std=float(rte[succ].std()),
                rre_mean=float(rre[succ].mean()),
                rre_std=float(rre[succ].std()),
            )
        return out

    def save(self, out_dir: str) -> None:
        """The eval's files (the reference's tester.py:67-83):
        ``results.npz`` with the per-pair arrays, and ``success_dists.npy``
        / ``fail_dists.npy``, the GT pair distances of the registrations
        that succeeded / failed."""
        os.makedirs(out_dir, exist_ok=True)
        succ = np.asarray(self.success, dtype=bool)
        dists = np.asarray(self.pair_dist, dtype=np.float32)
        np.savez(os.path.join(out_dir, "results.npz"),
                 rte=np.asarray(self.rte, np.float32),
                 rre=np.asarray(self.rre, np.float32), success=succ,
                 fitness=np.asarray(self.fitness, np.float32),
                 pair_dist=dists)
        if len(dists) == len(succ):
            np.save(os.path.join(out_dir, "success_dists.npy"), dists[succ])
            np.save(os.path.join(out_dir, "fail_dists.npy"), dists[~succ])


class FeatureTester:
    """Evaluate an encoder on an iterable of pair dicts (points0, points1
    as np [N, 3], t_gt as np [4, 4]).  ``trainer`` holds the encoder."""

    def __init__(self, config: APRConfig, trainer, device="cuda"):
        self.config = config
        self.trainer = trainer
        self.device = resolve_device(device)

    def eval_one(self, f0, f1, xyz0, xyz1, m0, m1, t_gt,
                 generator: Optional[torch.Generator] = None,
                 scores: Optional[torch.Tensor] = None,
                 stage_draws: Optional[List[torch.Tensor]] = None):
        """Subsample, match and register one pair of encoded clouds;
        returns (transform, rte, rre, fitness).

        ``scores`` [C0] (the subsample's random keys, -1 on padding) and
        ``stage_draws`` (RANSAC's index tuples) replace the draws from
        ``generator``, so a test can feed the reference's random numbers.
        """
        c = self.config
        thresh = c.test_ransac_dist_thresh or c.voxel_size
        n_sub = min(c.test_subsample, m0.shape[0])
        with span("match"):
            if scores is None:
                scores = torch.where(
                    m0, torch.rand(m0.shape, generator=generator,
                                   device=m0.device), -1.0)
            # the n_sub largest scores in descending order, ties to the
            # lower index as the reference's top-k orders them (a stable
            # sort; topk leaves the order of ties open): RANSAC's draws
            # index this order
            top, sel = torch.sort(scores, descending=True, stable=True)
            top, sel = top[:n_sub], sel[:n_sub]
            corr = feature_nn_correspondences(f0[sel], f1, top >= 0.0, m1)
            tgt_pts = xyz1[corr.tgt_idx.clamp(0, xyz1.shape[0] - 1).long()]
        kw = dict(distance_threshold=thresh, ransac_n=4,
                  escalation_min_inliers=c.test_ransac_escalation_min_inliers,
                  escalation_confidence=c.test_ransac_escalation_confidence)
        if stage_draws is None:
            res = ransac_pose(
                generator, xyz0[sel], tgt_pts, corr.mask,
                num_hypotheses=c.test_num_ransac_hypotheses,
                escalation_factor=c.test_ransac_escalation_factor or 0,
                escalation_rungs=c.test_ransac_escalation_rungs, **kw)
        else:
            res = ransac_from_draws(xyz0[sel], tgt_pts, corr.mask,
                                    stage_draws, **kw)
        rte, rre = registration_errors(res.transform, t_gt)
        return res.transform, rte, rre, res.fitness

    @torch.inference_mode()
    def step(self, batch, generator=None, scores=None, stage_draws=None):
        """Encode the first pair of ``batch`` and register it."""
        f0, f1 = self.trainer._encode_pair(batch, train=False)
        return self.eval_one(
            f0[0], f1[0], batch.xyz0[0], batch.xyz1[0],
            batch.pyramid0.levels[0].mask[0],
            batch.pyramid1.levels[0].mask[0], batch.t_gt[0],
            generator, scores, stage_draws)

    def _pair_to_batch(self, pair, point_capacity=None, capacities=None):
        """The device batch of one pair; ``point_capacity`` / ``capacities``
        override the config's worst-case buffers (eval/bucketing.py)."""
        c = self.config
        pc = point_capacity or c.point_capacity
        caps = capacities or c.capacities
        p0, m0 = pad_points(pair["points0"], pc)
        p1, m1 = pad_points(pair["points1"], pc)
        zeros = np.zeros((1, 1, 3), np.float32)
        zmask = np.zeros((1, 1), bool)
        return make_pair_batch(
            p0[None], m0[None], p1[None], m1[None],
            zeros, zmask, zeros, zmask,
            np.asarray(pair["t_gt"], np.float32)[None],
            voxel_size=c.voxel_size,
            capacities=tuple(caps),
            conv1_kernel_size=c.conv1_kernel_size,
            with_correspondences=False,
            device=self.device,
        )

    def _bucketed_batch(self, pair):
        """Batch at the smallest capacity tier holding the pair
        (config.test_capacity_buckets > 0); worst-case buffers otherwise."""
        c = self.config
        if not c.test_capacity_buckets:
            return self._pair_to_batch(pair)
        from apr_torch.eval.bucketing import bucket_for_pair

        pc, caps = bucket_for_pair(
            pair, c.voxel_size, c.capacities, c.point_capacity,
            max_tiers=c.test_capacity_buckets)
        return self._pair_to_batch(pair, point_capacity=pc, capacities=caps)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record(self, stats: TestStats, rte, rre, fitness) -> None:
        c = self.config
        rte = float(rte)
        rre = float(rre) if np.isfinite(float(rre)) else 180.0
        stats.rte.append(rte)
        stats.rre.append(rre)
        stats.success.append(rte < c.rte_thresh and rre < c.rre_thresh)
        stats.fitness.append(float(fitness))

    def _sharded_groups(self, pairs, d: int):
        """Tier-aware grouping (config.test_capacity_buckets): runs of
        consecutive same-tier pairs form groups of at most ``d``, in input
        order, so every group builds at its own capacities (at worst extra
        padded tail groups at tier boundaries); (batch keywords, pairs)
        per group."""
        c = self.config
        groups = []
        for pair in pairs:
            if c.test_capacity_buckets:
                from apr_torch.eval.bucketing import bucket_for_pair

                tier = bucket_for_pair(pair, c.voxel_size, c.capacities,
                                       c.point_capacity,
                                       max_tiers=c.test_capacity_buckets)
            else:
                tier = (c.point_capacity, tuple(c.capacities))
            if groups and groups[-1][0] == tier and len(groups[-1][1]) < d:
                groups[-1][1].append(pair)
            else:
                groups.append((tier, [pair]))
        return [(dict(point_capacity=pc, capacities=caps), group)
                for (pc, caps), group in groups]

    def test_sharded(self, pairs, mesh=None, seed: int = 0) -> TestStats:
        """Multi-device eval fan-out: groups of ``mesh.size`` pairs, each
        rank evaluating its pair of every group (rank r the r-th), the
        results gathered to every rank (the same stats on each).  A tail
        group is padded by repeating its last pair and only its real pairs
        are kept.  Each group takes one draw from the ``seed``'s generator
        and gives pair i its own generator
        (:func:`apr_torch.parallel.mesh.pair_generators`).
        ``sec_per_pair`` leaves out the first group (kernel builds and
        warm-up).  Without a mesh, the launcher's group (or a world of
        one) on the tester's device."""
        from apr_torch.parallel.collectives import all_gather_cat
        from apr_torch.parallel.mesh import make_mesh, pair_generators

        c = self.config
        mesh = mesh or make_mesh(self.device)
        d = mesh.size
        stats = TestStats()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0, n_timed = None, 0
        for kw, group in self._sharded_groups(list(pairs), d):
            n_real = len(group)
            group = group + [group[-1]] * (d - n_real)
            gens = pair_generators(gen, d)
            _, rte, rre, fitness = self.step(
                self._pair_to_batch(group[mesh.rank], **kw),
                gens[mesh.rank])
            res = all_gather_cat(torch.stack(
                [rte, rre, fitness]).float()[None].clone(), mesh).cpu()
            if t0 is None:
                t0 = time.time()    # the first group pays the warm-up
            else:
                n_timed += n_real
            for i in range(n_real):
                self._record(stats, *res[i].tolist())
                stats.pair_dist.append(
                    float(np.linalg.norm(group[i]["t_gt"][:3, 3])))
        if t0 is not None and n_timed:
            stats.sec_per_pair.extend([(time.time() - t0) / n_timed]
                                      * n_timed)
        return stats

    def test(self, pairs: Iterable[dict], seed: int = 0,
             log_freq: int = 10, pipelined: bool = True) -> TestStats:
        """Evaluate all pairs.

        ``pipelined=True`` queues every pair's device work and synchronizes
        once at the end; ``pipelined=False`` syncs per pair and reports
        per-pair wall times.  The first pair pays the kernel build and
        warm-up and is left out of the timing.
        """
        stats = TestStats()
        gen = torch.Generator(device=self.device).manual_seed(seed)

        if pipelined:
            results = []
            t_start = None
            for i, pair in enumerate(pairs):
                results.append(self.step(self._bucketed_batch(pair), gen))
                stats.pair_dist.append(
                    float(np.linalg.norm(pair["t_gt"][:3, 3])))
                if i == 0:
                    self._sync()
                    t_start = time.time()
            self._sync()
            total = (time.time() - t_start) if t_start is not None else 0.0
            n_done = max(len(results) - 1, 1)
            for i, (_, rte, rre, fitness) in enumerate(results):
                self._record(stats, rte, rre, fitness)
                if i > 0:
                    stats.sec_per_pair.append(total / n_done)
            return stats

        timer = Timer()
        for i, pair in enumerate(pairs):
            timer.tic()
            _, rte, rre, fitness = self.step(self._bucketed_batch(pair), gen)
            stats.pair_dist.append(float(np.linalg.norm(pair["t_gt"][:3, 3])))
            self._record(stats, rte, rre, fitness)
            dt = timer.toc(average=False)
            if i > 0:
                stats.sec_per_pair.append(dt)
            if (i + 1) % log_freq == 0:
                s = stats.summary()
                log.info(
                    "pair %d: recall=%.3f rte=%.3f rre=%.3f %.2f pairs/s",
                    i + 1, s["recall"], stats.rte[-1], stats.rre[-1],
                    s.get("pairs_per_sec", 0.0),
                )
        return stats
