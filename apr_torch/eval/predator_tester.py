"""Predator-path tester (port of ``apr_tpu/eval/predator_tester.py``).

Per pair: the KP batch build; the KPFCNN forward; in each cloud a sample
of ``test_subsample`` points drawn without replacement with probability
proportional to overlap * saliency (a Gumbel top-k); feature-NN
correspondences from the sampled points of cloud 0 to those of cloud 1;
RANSAC (threshold 0.3 m, 4-point tuples); RTE / RRE against the ground
truth.  ``test`` (pipelined or not) is :class:`FeatureTester`'s, and so
are the spans: ``encode`` is the KPFCNN call, ``match`` the two samples
and the feature NN.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points
from apr_torch.eval.tester import FeatureTester
from apr_torch.models.kpfcnn import KPFCNNOutputs
from apr_torch.registration.matching import feature_nn_correspondences
from apr_torch.registration.metrics import registration_errors
from apr_torch.registration.ransac import ransac_from_draws, ransac_pose
from apr_torch.training.predator import KPPairBatch, make_kp_pair_batch
from apr_torch.utils.profiling import span


def weighted_sample(scores: torch.Tensor, mask: torch.Tensor, n: int,
                    uniform: torch.Tensor) -> torch.Tensor:
    """Mask of ``n`` points drawn without replacement with probability
    proportional to ``scores`` (a Gumbel top-k over ``log(max(w, 1e-12)) +
    g``, -inf on padding), from uniforms in [1e-12, 1).  The top-k is a
    stable descending sort: ties go to the lower index, as ``lax.top_k``'s
    do."""
    w = torch.where(mask, scores, 0.0)
    logw = torch.log(torch.clamp(w, min=1e-12))
    g = -torch.log(-torch.log(uniform))
    keys = torch.where(mask, logw + g, float("-inf"))
    sel = torch.sort(keys, descending=True, stable=True).indices[:n]
    picked = torch.zeros_like(mask).index_fill_(0, sel, True)
    return picked & mask


class PredatorTester(FeatureTester):
    """Evaluate a :class:`apr_torch.training.predator.PredatorTrainer`'s
    KPFCNN on an iterable of pair dicts (points0, points1 as np [N, 3],
    t_gt as np [4, 4]); ``PredatorTester(config, trainer, device="cuda")``
    as :class:`FeatureTester`."""

    @torch.inference_mode()
    def forward(self, batch: KPPairBatch) -> KPFCNNOutputs:
        with span("encode"):
            return self.trainer.model(batch.pyr0, batch.pyr1)

    @torch.inference_mode()
    def eval_one(self, out: KPFCNNOutputs, batch: KPPairBatch,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 stage_draws: Optional[List[torch.Tensor]] = None):
        """Sample, match and register one pair from the model's outputs;
        returns (transform, rte, rre, fitness).

        ``uniforms`` (the two clouds' sampling uniforms, [N0] and [N1]) and
        ``stage_draws`` (RANSAC's index tuples) replace the draws from
        ``generator``, so a test can feed the reference's random numbers.
        """
        c = self.config
        m0 = batch.pyr0.levels[0].mask
        m1 = batch.pyr1.levels[0].mask
        xyz0 = batch.pyr0.levels[0].points
        xyz1 = batch.pyr1.levels[0].points
        with span("match"):
            if uniforms is None:
                uniforms = tuple(torch.clamp(torch.rand(
                    m.shape, generator=generator, device=m.device),
                    min=1e-12) for m in (m0, m1))
            s0 = weighted_sample(out.overlap0 * out.saliency0, m0,
                                 c.test_subsample, uniforms[0])
            s1 = weighted_sample(out.overlap1 * out.saliency1, m1,
                                 c.test_subsample, uniforms[1])
            corr = feature_nn_correspondences(out.feats0, out.feats1, s0, s1)
            tgt_pts = xyz1[corr.tgt_idx.clamp(0, xyz1.shape[0] - 1).long()]
        kw = dict(distance_threshold=0.3, ransac_n=4,
                  escalation_min_inliers=c.test_ransac_escalation_min_inliers,
                  escalation_confidence=c.test_ransac_escalation_confidence)
        if stage_draws is None:
            res = ransac_pose(
                generator, xyz0, tgt_pts, corr.mask,
                num_hypotheses=c.test_num_ransac_hypotheses,
                escalation_factor=c.test_ransac_escalation_factor or 0,
                escalation_rungs=c.test_ransac_escalation_rungs, **kw)
        else:
            res = ransac_from_draws(xyz0, tgt_pts, corr.mask, stage_draws,
                                    **kw)
        rte, rre = registration_errors(res.transform, batch.t_gt)
        return res.transform, rte, rre, res.fitness

    def step(self, batch: KPPairBatch, generator=None, uniforms=None,
             stage_draws=None):
        """Forward and register one pair."""
        return self.eval_one(self.forward(batch), batch, generator, uniforms,
                             stage_draws)

    def _pair_to_batch(self, pair, point_capacity=None, capacities=None):
        c = self.config
        pc = point_capacity or c.point_capacity
        caps = capacities or c.kp_capacities
        p0, m0 = pad_points(pair["points0"], pc)
        p1, m1 = pad_points(pair["points1"], pc)
        zeros = np.zeros((1, 3), np.float32)
        zmask = np.zeros((1,), bool)
        return make_kp_pair_batch(
            p0, m0, p1, m1, zeros, zmask, zeros, zmask,
            np.asarray(pair["t_gt"], np.float32),
            first_subsampling_dl=c.first_subsampling_dl,
            conv_radius=c.conv_radius, capacities=tuple(caps),
            neighbor_limits=tuple(c.neighborhood_limits),
            overlap_radius=c.overlap_radius, device=self.device)

    def _sharded_groups(self, pairs, d: int):
        """Consecutive groups of ``d`` pairs at the config's capacities
        (the reference's Predator fan-out takes no tiers)."""
        return [({}, pairs[g:g + d]) for g in range(0, len(pairs), d)]

    def _bucketed_batch(self, pair):
        """KP-flavour occupancy bucketing: the level-0 grid is
        ``first_subsampling_dl`` and the tiers halve ``kp_capacities``."""
        c = self.config
        if not c.test_capacity_buckets:
            return self._pair_to_batch(pair)
        from apr_torch.eval.bucketing import bucket_for_pair

        pc, caps = bucket_for_pair(
            pair, c.first_subsampling_dl, c.kp_capacities, c.point_capacity,
            max_tiers=c.test_capacity_buckets)
        return self._pair_to_batch(pair, point_capacity=pc, capacities=caps)


def calibrate_neighbors(dataset, config: APRConfig, keep_ratio: float = 0.8,
                        samples_threshold: int = 2000,
                        max_items: Optional[int] = None,
                        device="cuda") -> Tuple[int, ...]:
    """Per-layer neighbour caps from a dataset (the reference's
    calibrate_neighbors): histogram the radius-neighbour counts of every
    level over both clouds of each pair until every layer holds more than
    ``samples_threshold`` samples; each cap is the ``keep_ratio``
    percentile."""
    from apr_torch.device import resolve_device
    from apr_torch.ops.neighbors import radius_neighbors
    from apr_torch.ops.voxelize import voxelize

    dev = resolve_device(device)
    num_levels = len(config.kp_capacities)
    hist_n = int(np.ceil(4 / 3 * np.pi * (config.conv_radius + 1) ** 3))
    counts = np.zeros((num_levels, hist_n), np.int64)
    n_items = (len(dataset) if max_items is None
               else min(len(dataset), max_items))
    for i in range(n_items):
        pair = dataset.get_pair(i)
        for cloud in ("points0", "points1"):
            p_np, m_np = pad_points(pair[cloud], config.point_capacity)
            pts = torch.from_numpy(p_np)[None].to(dev)
            mask = torch.from_numpy(m_np)[None].to(dev)
            dl = config.first_subsampling_dl
            r = dl * config.conv_radius
            for lvl in range(num_levels):
                grid = voxelize(pts, dl, config.kp_capacities[lvl], mask)
                nb = radius_neighbors(grid.barycenter, grid.barycenter, r,
                                      hist_n - 1, q_mask=grid.mask,
                                      s_mask=grid.mask)
                n_nb = (nb[0] < nb.shape[1]).sum(1)[grid.mask[0]]
                counts[lvl] += np.bincount(n_nb.cpu().numpy(),
                                           minlength=hist_n)
                dl *= 2
                r *= 2
        if counts.sum(axis=1).min() > samples_threshold:
            break
    cum = np.cumsum(counts.T, axis=0)
    limits = np.sum(cum < (keep_ratio * cum[hist_n - 1, :]), axis=0)
    return tuple(int(x) for x in limits)
