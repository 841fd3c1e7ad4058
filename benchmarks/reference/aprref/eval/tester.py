# Frozen copy of apr_torch/eval/tester.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref, trimmed to what the cells run;
# see reference/aprref/__init__.py.
"""Registration eval harness (port of ``apr_tpu/eval/tester.py``).

Reference protocol (FCGF_APR/scripts/test_apr.py): per test pair, encoder
forward on both clouds; a random 5000-point subsample of cloud 0;
feature-space NN correspondences; feature-matching RANSAC with threshold =
voxel size; RTE/RRE against the ground truth; success = RTE < 2 m and
RRE < 5 deg.  Everything after the host-side padding runs on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from reference.aprref.config import APRConfig
from reference.aprref.data.synthetic import pad_points
from reference.aprref.device import resolve_device
from reference.aprref.registration.matching import feature_nn_correspondences
from reference.aprref.registration.metrics import registration_errors
from reference.aprref.registration.ransac import ransac_from_draws, ransac_pose
from reference.aprref.training.batching import make_pair_batch


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
        if scores is None:
            scores = torch.where(
                m0, torch.rand(m0.shape, generator=generator,
                               device=m0.device), -1.0)
        # the n_sub largest scores in descending order, ties to the lower
        # index as the reference's top-k orders them (a stable sort; topk
        # leaves the order of ties open): RANSAC's draws index this order
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
        """The worst-case buffers: the reference holds no capacity
        buckets."""
        if self.config.test_capacity_buckets:
            raise NotImplementedError("the reference holds no capacity "
                                      "buckets")
        return self._pair_to_batch(pair)
