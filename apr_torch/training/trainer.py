"""FCGF-path trainer (port of ``apr_tpu/training/trainer.py``): the encoder,
the generator of the GenerativePairTrainer (a per-point MLP, or with
``symmetric`` a second ResUNet over the same pyramid), the contrastive,
triplet and NPR losses, SGD / Adam with coupled weight decay, gradient
accumulation, the train step with its non-finite gate (fused with the next
batch's build or not), and the validation step.

The train state is the modules plus the optimizer, updated in place
(:class:`apr_torch.training.train_state.TrainerState`); the step runs
eagerly (no jit).  Both clouds of every pair are encoded in one 2B-cloud
forward; in train mode the norms take per-side statistics
(``stats_groups=2``), as the reference's two sequential forwards do.

Data parallel (:meth:`FCGFTrainer.use_mesh`).  Under the reference's mesh
an R-device step is the one-device step on the whole batch, and the batch
couples its pairs in three places: the batch norms' moments, the
contrastive loss's draws over the concatenated clouds, and the finite
gate.  Here rank r holds b = B / R pairs and its own slice of every batch
array, and:

- the batch norms take global moments (``MaskedBatchNorm.mesh``);
- f0, f1, the masks and the correspondences are gathered into the global
  batch, and every rank computes the same contrastive term C over it,
  from the same generator state, so the draws are the global draws;
- the generative branch runs on the rank's own clouds: G_r, the sum of
  its clouds' (chamfer + reg) * loss_ratio.

The global loss is L = C + sum_r G_r.  Rank r back-propagates its local
loss L_r = C + G_r.  The gather's backward keeps rank r's slice of dC/dF,
so L_r's backward gives dC/dtheta through rank r's features only, plus
dG_r/dtheta; the norms' all-reduce backward sums the moments' gradients
over the ranks, so each rank's share is exact for the global moments.
Summing over r: sum_r dL_r/dtheta = dC/dtheta + sum_r dG_r/dtheta =
dL/dtheta.  So the parameter gradients are all-reduced with SUM (in the
train state's gated update), and the finite gate judges the global loss
and the summed gradients, the same on every rank.  The logged loss terms
are those of the global batch: the per-cloud terms and per-pair metrics
are gathered and reduced as on one device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from apr_torch.config import APRConfig
from apr_torch.device import resolve_device
from apr_torch.geometry.robust import est_rigid_robust
from apr_torch.losses.contrastive import contrastive_loss_random_negatives, \
    hardest_contrastive_loss, triplet_loss
from apr_torch.losses.generative import npr_reconstruction
from apr_torch.models import load_model
from apr_torch.models.layers import MaskedBatchNorm
from apr_torch.models.mlp import make_generative_mlp
from apr_torch.parallel.collectives import all_gather_cat, gather_batch
from apr_torch.registration.matching import feature_nn_correspondences
from apr_torch.registration.metrics import hit_ratio, registration_errors
from apr_torch.training.batching import PairBatch, make_pair_batch
from apr_torch.training.train_state import TrainerState
from apr_torch.utils.profiling import span


def _zip_tree(fn, a, c):
    """Apply ``fn`` leafwise to two trees of tensors of the same structure."""
    if isinstance(a, torch.Tensor):
        return fn(a, c)
    items = [_zip_tree(fn, x, y) for x, y in zip(a, c)]
    return type(a)(*items) if hasattr(a, "_fields") else tuple(items)


def _flatten_pairs(pos_src, pos_tgt, pos_mask, n):
    """Offset per-pair voxel indices into the concatenated [B*N] rows."""
    b = pos_src.shape[0]
    offs = (torch.arange(b, dtype=torch.int32, device=pos_src.device)
            * n)[:, None]
    return ((pos_src + offs).reshape(-1), (pos_tgt + offs).reshape(-1),
            pos_mask.reshape(-1))


class FCGFTrainer(TrainerState):
    """One trainer class, loss selected by name (reference get_trainer)."""

    LOSS_MODES = (
        "ContrastiveLossTrainer",
        "HardestContrastiveLossTrainer",
        "TripletLossTrainer",
        "HardestTripletLossTrainer",
        "GenerativePairTrainer",
    )

    def __init__(self, config: APRConfig, device="cuda", seed: int = 0):
        if config.trainer not in self.LOSS_MODES:
            raise ValueError(f"unknown trainer {config.trainer!r}")
        self.config = config
        self.device = resolve_device(device)
        self.generative = config.trainer == "GenerativePairTrainer"
        self.symmetric = bool(config.symmetric) and self.generative
        self.mesh = None
        self.init_state(seed)

    # --- construction / state -------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        """Fresh random weights from ``seed``, zero optimizer state, step 0
        and the config's learning rate."""
        c = self.config
        cd = None if c.compute_dtype in (None, "float32") else c.compute_dtype
        # batching feeds masked ones as input features (the FCGF
        # convention), so conv1 runs as a validity matmul with no gather
        self.encoder = load_model(c.model)(
            in_channels=1, ones_input=True, out_channels=c.model_n_out,
            normalize_feature=c.normalize_feature,
            conv1_kernel_size=c.conv1_kernel_size,
            bn_momentum=c.bn_momentum, compute_dtype=cd, device=self.device,
            seed=seed)
        if self.symmetric:
            # the symmetric NPR decoder: a second ResUNet over the same
            # pyramid, fed the encoder's features (so its conv1 gathers),
            # emitting point_generation_ratio * 3 offsets per voxel
            self.generator = load_model(c.generator_model)(
                in_channels=c.model_n_out,
                out_channels=c.point_generation_ratio * 3,
                normalize_feature=False,
                conv1_kernel_size=c.conv1_kernel_size,
                bn_momentum=c.bn_momentum, compute_dtype=cd,
                device=self.device, seed=seed + 1)
        elif self.generative:
            self.generator = make_generative_mlp(
                c.generator_model, out_points=c.point_generation_ratio,
                in_channels=c.model_n_out, bn_momentum=c.bn_momentum,
                device=self.device, seed=seed + 1)
        else:
            self.generator = None
        self.step = 0
        self.reset_optimizer(keep_lr=False)

    def modules(self) -> List[torch.nn.Module]:
        return [m for m in (self.encoder, self.generator) if m is not None]

    def use_mesh(self, mesh) -> None:
        """Train data parallel over ``mesh`` (see the module docstring):
        the batch norms take global moments, the state is replicated from
        the mesh's first member, and the steps expect this rank's slice of
        each batch.  Every member must call it."""
        super().use_mesh(mesh)
        for m in self.modules():
            for sub in m.modules():
                if isinstance(sub, MaskedBatchNorm):
                    sub.mesh = mesh

    def _make_optimizer(self) -> torch.optim.Optimizer:
        """SGD with momentum or Adam, both with coupled weight decay on
        every parameter (optax.add_decayed_weights before the inner
        optimizer, as the reference chains them)."""
        c = self.config
        if c.optimizer == "SGD":
            return torch.optim.SGD(self.parameters(), lr=c.lr,
                                   momentum=c.sgd_momentum,
                                   weight_decay=c.weight_decay)
        if c.optimizer == "Adam":
            return torch.optim.Adam(self.parameters(), lr=c.lr,
                                    weight_decay=c.weight_decay)
        raise NotImplementedError(c.optimizer)

    # --- forward helpers ------------------------------------------------

    def _encode(self, feats, pyramid, train: bool = False,
                stats_groups: int = 1) -> torch.Tensor:
        """The encoder over ``feats`` [B, C0, 1] and a batched pyramid;
        train mode uses batch statistics (per interleaved group of
        ``stats_groups`` clouds) and updates the running stats in place."""
        self.encoder.train(train)
        try:
            with torch.set_grad_enabled(train and torch.is_grad_enabled()):
                return self.encoder(feats, pyramid, stats_groups=stats_groups)
        finally:
            self.encoder.train(False)

    def _encode_pair(self, batch: PairBatch, train: bool = False,
                     fold: bool = True):
        """Encode both clouds of a PairBatch; returns (f0, f1), each
        [B, C0, model_n_out].  Train mode updates the encoder's running
        stats in place.

        ``fold=True`` runs one 2B-cloud forward with the sides interleaved
        (pair i's clouds adjacent), where train-mode norms take per-side
        moments and apply the momentum updates side 0 then side 1;
        ``fold=False`` runs the two forwards one after the other.
        """
        with span("encode"):
            if not fold:
                return (self._encode(batch.feats0, batch.pyramid0, train),
                        self._encode(batch.feats1, batch.pyramid1, train))
            b = batch.feats0.shape[0]

            def weave(a, c):
                return torch.stack([a, c], 1).reshape((2 * b,) + a.shape[1:])

            f = self._encode(weave(batch.feats0, batch.feats1),
                             _zip_tree(weave, batch.pyramid0, batch.pyramid1),
                             train, stats_groups=2 if train else 1)
            f = f.reshape((b, 2) + f.shape[1:])
            return f[:, 0], f[:, 1]

    def _contrastive(self, generator, f0_flat, f1_flat, src, tgt, pmask, m0,
                     m1):
        """(pos_loss, neg_loss) of the config's trainer; the triplet
        trainers' single loss is the positive term."""
        c = self.config
        num_pos = c.num_pos_per_batch * c.batch_size
        num_hn = c.num_hn_samples_per_batch * c.batch_size
        if c.trainer in ("HardestContrastiveLossTrainer",
                         "GenerativePairTrainer"):
            return hardest_contrastive_loss(
                generator, f0_flat, f1_flat, src, tgt, pmask, m0, m1,
                num_pos=num_pos, num_hn_samples=num_hn,
                pos_thresh=c.pos_thresh, neg_thresh=c.neg_thresh)
        if c.trainer == "ContrastiveLossTrainer":
            return contrastive_loss_random_negatives(
                generator, f0_flat, f1_flat, src, tgt, pmask, m1,
                num_pos=num_pos, num_neg=num_pos, pos_thresh=c.pos_thresh,
                neg_thresh=c.neg_thresh)
        loss = triplet_loss(
            generator, f0_flat, f1_flat, src, tgt, pmask, m1,
            num_pos=num_pos, num_hn_samples=num_hn,
            hardest=c.trainer == "HardestTripletLossTrainer")
        return loss, torch.zeros((), device=loss.device)

    def _generative_branch(self, feats, pyramid, apc, apc_mask, train):
        """Per cloud of the batch: (chamfer + reg * strength), chamfer, reg
        and the clamp fraction, each [B]; every cloud in one batched call.
        The generator is the MLP over (feats, mask) or, symmetric, the
        ResUNet over (feats, pyramid); train mode updates its running stats
        in place."""
        c = self.config
        mask = pyramid.levels[0].mask                  # [B, C0]
        self.generator.train(train)
        try:
            # [B, C0, ratio * 3] raw offsets
            mlp_out = self.generator(feats, pyramid if self.symmetric
                                     else mask)
        finally:
            self.generator.train(False)
        anchors = pyramid.levels[0].coords.float() * c.voxel_size
        totals, cds, regs, clamps = npr_reconstruction(
            mlp_out, anchors, apc, mask, apc_mask,
            voxel_size=c.voxel_size, reg_type=c.regularization_type,
            reg_strength=c.regularization_strength, alpha=c.alpha,
            chamfer_mode=c.chamfer_mode,
            chamfer_cell_size=c.chamfer_cell_multiplier * c.voxel_size)
        return totals, cds, regs, clamps

    # --- the train step -------------------------------------------------

    def loss_fn(self, batch: PairBatch,
                generator: Optional[torch.Generator] = None,
                train: bool = True, return_feats: bool = False,
                sharded: bool = True):
        """(loss, metrics) or (loss, metrics, (f0, f1)); train mode
        updates the running stats of every norm in place.

        Under a mesh (and ``sharded``: the batch is this rank's slice) the
        returned loss is this rank's share L_r = C + G_r, whose gradients
        sum over the ranks to the global loss's, and the metrics are the
        global batch's (the module docstring)."""
        c = self.config
        mesh = self.mesh if sharded else None

        def whole(t):    # the global batch of a per-pair [b, ...] array
            return t if mesh is None else gather_batch(t, mesh)

        f0, f1 = self._encode_pair(batch, train)
        g0, g1 = whole(f0), whole(f1)
        b, n, ch = g0.shape
        m0 = whole(batch.pyramid0.levels[0].mask).reshape(-1)
        m1 = whole(batch.pyramid1.levels[0].mask).reshape(-1)
        src, tgt, pmask = _flatten_pairs(whole(batch.pos_src),
                                         whole(batch.pos_tgt),
                                         whole(batch.pos_mask), n)
        pos_loss, neg_loss = self._contrastive(
            generator, g0.reshape(b * n, ch), g1.reshape(b * n, ch), src,
            tgt, pmask, m0, m1)
        loss = pos_loss + c.neg_weight * neg_loss
        metrics = {"pos_loss": pos_loss, "neg_loss": neg_loss}
        if self.generative:
            side0 = self._generative_branch(
                f0, batch.pyramid0, batch.apc0, batch.apc0_mask, train)
            side1 = self._generative_branch(
                f1, batch.pyramid1, batch.apc1, batch.apc1_mask, train)
            # the global batch's terms (the reported ones) from the
            # gathered per-cloud values; the local ones carry the gradient
            (t0, cd0, reg0, cl0), (t1, cd1, reg1, cl1) = (
                [v if mesh is None else all_gather_cat(v.detach(), mesh)
                 for v in side] for side in (side0, side1))
            metrics.update(chamfer_loss=cd0.sum() + cd1.sum(),
                           regularization_loss=reg0.sum() + reg1.sum(),
                           chamfer_clamp_frac=0.5 * (cl0.mean()
                                                     + cl1.mean()))
            total = (loss + t0.sum() * c.loss_ratio
                     + t1.sum() * c.loss_ratio)
            if mesh is not None:
                metrics["loss"] = total
                total = (loss + side0[0].sum() * c.loss_ratio
                         + side1[0].sum() * c.loss_ratio)
            loss = total
        metrics.setdefault("loss", loss)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if return_feats:
            return loss, metrics, (f0, f1)
        return loss, metrics

    def train_step(self, batch: PairBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimization step on ``batch``; ``generator`` draws the
        contrastive samples.  Returns the metrics, with
        ``skipped_nonfinite`` 1.0 when the loss or a gradient was not
        finite: then parameters, optimizer state, accumulation and running
        stats all stay as they were (the reference's validate_gradient
        gate).  With ``iter_size`` k the optimizer steps on every k-th
        accepted call (:mod:`apr_torch.training.train_state`).  Spans:
        ``train.forward`` (the running stats' snapshot, ``zero_grad`` and
        the loss), ``train.backward``, then ``train.update``."""
        with span("train.forward"):
            saved = [b.clone() for b in self.buffers()]
            self.optimizer.zero_grad(set_to_none=False)
            loss, metrics = self.loss_fn(batch, generator, train=True)
        with span("train.backward"):
            loss.backward()
        return self._gated_update(metrics["loss"], saved, metrics)

    def train_step_fused(self, batch: PairBatch, raw_next: Tuple,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[Dict[str, torch.Tensor], PairBatch]:
        """:meth:`train_step` on ``batch``, then the build of the next
        batch from ``raw_next``'s nine arrays: (metrics, next_batch).  The
        two share no data; the loop carries ``next_batch`` to the next
        call."""
        metrics = self.train_step(batch, generator)
        return metrics, self.build_batch(raw_next)

    def build_batch(self, raw: Tuple) -> PairBatch:
        """Device batch from the nine padded arrays (points0, mask0,
        points1, mask1, apc0, apc0_mask, apc1, apc1_mask, t_gt)."""
        c = self.config
        return make_pair_batch(
            *raw, voxel_size=c.voxel_size, capacities=tuple(c.capacities),
            conv1_kernel_size=c.conv1_kernel_size,
            corr_cap=c.corr_capacity_per_point,
            search_multiplier=c.positive_pair_search_voxel_size_multiplier,
            device=self.device)

    # --- validation -----------------------------------------------------

    @torch.no_grad()
    def valid_step(self, batch: PairBatch,
                   generator: Optional[torch.Generator] = None,
                   sharded: bool = True) -> Dict[str, torch.Tensor]:
        """Loss plus matching and registration metrics: feature NN, robust
        IRLS pose, RTE / RRE, hit ratio and feature-match ratio (running
        stats, no update).  Under a mesh, ``sharded`` says the batch is
        this rank's slice (the metrics are then the global batch's);
        otherwise every rank runs the whole batch alone."""
        c = self.config
        mesh = self.mesh if sharded else None
        _, metrics, (f0, f1) = self.loss_fn(batch, generator, train=False,
                                            return_feats=True,
                                            sharded=sharded)
        m0 = batch.pyramid0.levels[0].mask
        m1 = batch.pyramid1.levels[0].mask
        hrs, rtes, rres = [], [], []
        for i in range(f0.shape[0]):
            corr = feature_nn_correspondences(f0[i], f1[i], m0[i], m1[i])
            xyz1 = batch.xyz1[i]
            tgt_pts = xyz1[corr.tgt_idx.clamp(0, xyz1.shape[0] - 1).long()]
            hrs.append(hit_ratio(batch.xyz0[i], tgt_pts, batch.t_gt[i],
                                 c.hit_ratio_thresh, corr.mask))
            t_est = est_rigid_robust(batch.xyz0[i], tgt_pts,
                                     corr.mask.float())
            rte, rre = registration_errors(t_est, batch.t_gt[i])
            rtes.append(rte)
            rres.append(rre)
        hrs, rtes, rres = (torch.stack(v) if mesh is None
                           else all_gather_cat(torch.stack(v), mesh)
                           for v in (hrs, rtes, rres))
        metrics.update(
            hit_ratio=hrs.mean(),
            feat_match_ratio=(hrs > 0.05).float().mean(),
            rte=rtes.mean(),
            # a non-finite RRE (degenerate pose fit) counts as the worst
            # rotation, not a perfect one
            rre=torch.where(torch.isfinite(rres), rres, 180.0).mean(),
            success=((rtes < c.rte_thresh) & (rres < c.rre_thresh))
            .float().mean())
        return metrics


def get_trainer(config: APRConfig, device="cuda", seed: int = 0
                ) -> FCGFTrainer:
    """The trainer of ``config.trainer`` (reference train.py get_trainer):
    one class, the loss selected by name."""
    return FCGFTrainer(config, device=device, seed=seed)
