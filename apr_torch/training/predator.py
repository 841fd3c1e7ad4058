"""The Predator-APR trainer (port of ``apr_tpu/training/predator.py``):
``make_kp_pair_batch`` builds one pair's two KP pyramids, its ground-truth
correspondences and its APC targets; ``PredatorTrainer`` holds the KPFCNN
and the generator, the optimizer, and the train and valid steps, for one
pair and for a group of pairs.

Per pair the loss is

    circle * w_circle + overlap_bce * w_overlap + saliency_bce * w_saliency
    + sum over both clouds of (chamfer + reg * reg_strength) * loss_ratio

with the generator's offsets anchored on the metric level-0 points (no
voxel scale), an L2 regularizer and a Chamfer cell of
``chamfer_cell_multiplier * first_subsampling_dl``.  The generator is the
Predator MLP (ending Linear-ReLU-BatchNorm; its running stats thread from
cloud 0's call into cloud 1's) or, with ``symmetric``, the
:class:`KPFCNNDecoder`.  As in :class:`FCGFTrainer`, the train state is the
modules plus the optimizer, updated in place, with the same gradient
accumulation (:mod:`apr_torch.training.train_state`), and a step whose loss
or a gradient is not finite changes nothing.

The grouped steps run data parallel under a mesh
(:meth:`PredatorTrainer.use_mesh`), as the reference's vmapped group
sharded over its mesh: each rank holds its pairs of the group (one in the
loop) with their per-pair draws, and the weighted sums of the losses, the
running stats, the metrics and the gradients are summed over the mesh.
The per-pair loss couples no pairs (the reference vmaps it), so the
norms keep their per-pair moments.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from apr_torch.config import APRConfig
from apr_torch.device import resolve_device
from apr_torch.losses.circle import metric_loss
from apr_torch.losses.generative import npr_reconstruction
from apr_torch.models.kpconv import KPPyramid, kp_pyramid_tables, \
    reset_kp_parameters_, select_cloud
from apr_torch.models.kpfcnn import KPFCNN, KPFCNNDecoder
from apr_torch.models.mlp import make_generative_mlp
from apr_torch.ops.voxelize import dedup_points, voxelize_pyramid
from apr_torch.parallel.collectives import all_reduce_
from apr_torch.parallel.mesh import pair_generators
from apr_torch.registration.matching import gt_correspondences
from apr_torch.training.train_state import TrainerState
from apr_torch.utils.profiling import span


class KPPairBatch(NamedTuple):
    """One pair: both pyramids (levels without a batch dim), the GT
    correspondences on the level-0 points, the APC targets and t_gt.  A
    group of B pairs (:meth:`PredatorTrainer.build_batch_group`) gives
    every field a leading dim B."""

    pyr0: KPPyramid
    pyr1: KPPyramid
    corr_src: torch.Tensor     # int32 [N0 * corr_cap]
    corr_tgt: torch.Tensor
    corr_mask: torch.Tensor
    apc0: torch.Tensor         # [M, 3]
    apc0_mask: torch.Tensor
    apc1: torch.Tensor
    apc1_mask: torch.Tensor
    t_gt: torch.Tensor         # [4, 4]


def select_pair(batch: KPPairBatch, i: int) -> KPPairBatch:
    """Pair ``i`` of a group."""
    return KPPairBatch(select_cloud(batch.pyr0, i),
                       select_cloud(batch.pyr1, i), *(t[i] for t in batch[2:]))


def make_kp_pairs(
    points0, mask0, points1, mask1,    # [B, N, 3], [B, N]
    apc0, apc0_mask, apc1, apc1_mask,  # [B, M, 3], [B, M]
    t_gt,                              # [B, 4, 4]
    first_subsampling_dl: float = 0.3,
    conv_radius: float = 4.25,
    capacities=(16384, 4096, 2048, 1024),
    neighbor_limits=(40, 40, 40, 40),
    corr_cap: int = 2,
    overlap_radius: float = 0.45,
    overflow_fallback: bool = True,
    device="cuda",
) -> KPPairBatch:
    """B pairs -> a group :class:`KPPairBatch`: the 2B clouds' pyramids in
    one batched build, the GT matches within ``overlap_radius`` on the
    level-0 points (``corr_cap`` per source point) and the
    voxel-deduplicated APC targets (skipped for placeholders of 8 rows or
    fewer).  ``overflow_fallback`` as in :func:`build_kp_pyramid`.  Inputs
    may be numpy arrays or tensors; they move to ``device``.  Spans as in
    :func:`apr_torch.training.batching.make_pair_batch`: ``build.voxelize``
    (the copies in and the voxel pyramid), ``build.maps`` (the radius
    searches, pool and upsample tables) and ``build.corr``."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    b = len(t_gt)
    with span("build.voxelize"):
        pts = torch.cat([put(points0, torch.float32),
                         put(points1, torch.float32)])
        msk = torch.cat([put(mask0, torch.bool), put(mask1, torch.bool)])
        t_gt = put(t_gt, torch.float32)
        grids = voxelize_pyramid(pts, first_subsampling_dl,
                                 tuple(capacities), msk)
    with span("build.maps"):
        pyr = kp_pyramid_tables(grids, first_subsampling_dl * conv_radius,
                                len(capacities), tuple(neighbor_limits),
                                overflow_fallback)
    with span("build.corr"):
        lv0 = pyr.levels[0]
        corr = gt_correspondences(
            lv0.points[:b], lv0.points[b:], t_gt, radius=overlap_radius,
            cap_per_point=corr_cap, mask0=lv0.mask[:b], mask1=lv0.mask[b:])

        apc = torch.cat([put(apc0, torch.float32), put(apc1, torch.float32)])
        apc_mask = torch.cat([put(apc0_mask, torch.bool),
                              put(apc1_mask, torch.bool)])
        if apc.shape[1] > 8:
            apc, apc_mask = dedup_points(apc, first_subsampling_dl, apc_mask)

    def side(pyramid, s):
        return KPPyramid(levels=tuple(
            type(lv)(*(t[s] for t in lv)) for lv in pyramid.levels))

    return KPPairBatch(
        pyr0=side(pyr, slice(0, b)), pyr1=side(pyr, slice(b, 2 * b)),
        corr_src=corr.src_idx, corr_tgt=corr.tgt_idx, corr_mask=corr.mask,
        apc0=apc[:b], apc0_mask=apc_mask[:b], apc1=apc[b:],
        apc1_mask=apc_mask[b:], t_gt=t_gt)


def make_kp_pair_batch(
    points0, mask0, points1, mask1,    # [N, 3], [N]
    apc0, apc0_mask, apc1, apc1_mask,  # [M, 3], [M]
    t_gt,                              # [4, 4]
    first_subsampling_dl: float = 0.3,
    conv_radius: float = 4.25,
    capacities=(16384, 4096, 2048, 1024),
    neighbor_limits=(40, 40, 40, 40),
    corr_cap: int = 2,
    overlap_radius: float = 0.45,
    device="cuda",
) -> KPPairBatch:
    """One pair -> its :class:`KPPairBatch` (:func:`make_kp_pairs` of a
    group of one, which moves the arrays to ``device``; an overflowed
    windowed search reruns exactly)."""
    group = make_kp_pairs(
        *(torch.as_tensor(x)[None] for x in (
            points0, mask0, points1, mask1, apc0, apc0_mask, apc1,
            apc1_mask, t_gt)),
        first_subsampling_dl=first_subsampling_dl, conv_radius=conv_radius,
        capacities=capacities, neighbor_limits=neighbor_limits,
        corr_cap=corr_cap, overlap_radius=overlap_radius, device=device)
    return select_pair(group, 0)


class PredatorTrainer(TrainerState):
    """KPFCNN (``model``) and generator with random weights from ``seed``
    on ``device``, an SGD (coupled decay) or AdamW optimizer (accumulated
    over ``iter_size`` mini-steps), and the train and valid steps."""

    def __init__(self, config: APRConfig, device="cuda", seed: int = 0):
        self.config = config
        self.device = resolve_device(device)
        self.symmetric = bool(config.symmetric)
        self.init_state(seed)

    # --- construction / state -------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        """Fresh random weights from ``seed``, zero optimizer state, step 0
        and the config's learning rate."""
        c = self.config
        cd = None if c.compute_dtype in (None, "float32") else c.compute_dtype
        kp = dict(first_subsampling_dl=c.first_subsampling_dl,
                  conv_radius=c.conv_radius, kp_extent=c.KP_extent,
                  num_kernel_points=c.num_kernel_points,
                  deformable=c.deformable, modulated=c.modulated,
                  compute_dtype=cd)
        self.model = KPFCNN(
            final_feats_dim=c.final_feats_dim,
            first_feats_dim=c.first_feats_dim,
            gnn_feats_dim=c.gnn_feats_dim, dgcnn_k=c.dgcnn_k,
            num_head=c.num_head, nets=tuple(c.nets),
            condition_feature=c.condition_feature,
            add_cross_score=c.add_cross_score, **kp)
        reset_kp_parameters_(self.model, torch.Generator().manual_seed(seed))
        self.model = self.model.to(self.device).eval()
        if self.symmetric:
            # the symmetric NPR decoder: a second KPConv U-Net over the
            # same pyramids, fed the KPFCNN's features
            self.generator = KPFCNNDecoder(
                c.final_feats_dim, c.point_generation_ratio,
                c.first_feats_dim, **kp)
            reset_kp_parameters_(self.generator,
                                 torch.Generator().manual_seed(seed + 1))
            self.generator = self.generator.to(self.device).eval()
        else:
            self.generator = make_generative_mlp(
                c.generator_model, out_points=c.point_generation_ratio,
                in_channels=c.final_feats_dim, final_bn=True,
                device=self.device, seed=seed + 1)
        self.step = 0
        self.reset_optimizer(keep_lr=False)

    def modules(self) -> List[torch.nn.Module]:
        return [self.model, self.generator]

    def _make_optimizer(self) -> torch.optim.Optimizer:
        """SGD with momentum and coupled weight decay (the reference's
        add_decayed_weights before sgd), or AdamW with decoupled decay (the
        reference's optax.adamw)."""
        c = self.config
        if c.optimizer == "SGD":
            return torch.optim.SGD(self.parameters(), lr=c.lr,
                                   momentum=c.sgd_momentum,
                                   weight_decay=c.weight_decay)
        if c.optimizer == "Adam":
            return torch.optim.AdamW(self.parameters(), lr=c.lr,
                                     weight_decay=c.weight_decay)
        raise NotImplementedError(c.optimizer)

    # --- batches --------------------------------------------------------

    def _build_kw(self):
        c = self.config
        return dict(first_subsampling_dl=c.first_subsampling_dl,
                    conv_radius=c.conv_radius,
                    capacities=tuple(c.kp_capacities),
                    neighbor_limits=tuple(c.neighborhood_limits),
                    overlap_radius=c.overlap_radius, device=self.device)

    def build_batch(self, raw: Sequence) -> KPPairBatch:
        """One pair's batch from its nine arrays (points0, mask0, points1,
        mask1, apc0, apc0_mask, apc1, apc1_mask, t_gt); an overflowed
        windowed search reruns exactly."""
        return make_kp_pair_batch(*raw, **self._build_kw())

    def build_batch_group(self, raw: Sequence) -> KPPairBatch:
        """A group's batch from the nine stacked [B, ...] arrays.  As the
        reference's grouped build, an overflowed windowed table stays as
        it is (no exact rerun, no host sync)."""
        return make_kp_pairs(*raw, overflow_fallback=False,
                             **self._build_kw())

    # --- the loss -------------------------------------------------------

    def _reconstruction(self, offsets, anchors, mask, apc, apc_mask):
        """One cloud's (chamfer + reg * strength, chamfer, reg, clamp)."""
        c = self.config
        out = npr_reconstruction(
            offsets[None], anchors[None], apc[None], mask[None],
            apc_mask[None], voxel_size=1.0, reg_type="L2",
            reg_strength=c.regularization_strength,
            chamfer_mode=c.chamfer_mode,
            chamfer_cell_size=c.chamfer_cell_multiplier
            * c.first_subsampling_dl)
        return [v[0] for v in out]

    def _offsets(self, out, batch: KPPairBatch, train: bool):
        """Both clouds' generator outputs.  The MLP runs cloud 0, then
        cloud 1: in train mode the running stats thread through both
        calls."""
        if self.symmetric:
            return self.generator(out.feats0, out.feats1, batch.pyr0,
                                  batch.pyr1)
        self.generator.train(train)
        try:
            return (self.generator(out.feats0, batch.pyr0.levels[0].mask),
                    self.generator(out.feats1, batch.pyr1.levels[0].mask))
        finally:
            self.generator.train(False)

    def loss_fn(self, batch: KPPairBatch,
                generator: Optional[torch.Generator] = None,
                w_saliency: float = 0.0, train: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of one pair; ``generator`` draws the circle
        loss's correspondences.  Train mode updates the generator's running
        stats in place."""
        c = self.config
        with span("encode"):
            out = self.model(batch.pyr0, batch.pyr1)
        lv0, lv1 = batch.pyr0.levels[0], batch.pyr1.levels[0]
        stats = metric_loss(
            generator, lv0.points, lv1.points, lv0.mask, lv1.mask,
            out.feats0, out.feats1, batch.corr_src, batch.corr_tgt,
            batch.corr_mask, batch.t_gt, out.overlap0, out.overlap1,
            out.saliency0, out.saliency1, pos_radius=c.pos_radius,
            safe_radius=c.safe_radius,
            matchability_radius=c.matchability_radius,
            pos_margin=c.pos_margin, neg_margin=c.neg_margin,
            log_scale=c.log_scale, max_points=c.max_points)
        o0, o1 = self._offsets(out, batch, train)
        g0, cd0, reg0, clamp0 = self._reconstruction(
            o0, lv0.points, lv0.mask, batch.apc0, batch.apc0_mask)
        g1, cd1, reg1, clamp1 = self._reconstruction(
            o1, lv1.points, lv1.mask, batch.apc1, batch.apc1_mask)
        loss = (stats["circle_loss"] * c.w_circle_loss
                + stats["overlap_loss"] * c.w_overlap_loss
                + stats["saliency_loss"] * w_saliency
                + (g0 + g1) * c.loss_ratio)
        metrics = dict(stats, loss=loss, chamfer_loss=cd0 + cd1,
                       regularization_loss=reg0 + reg1,
                       chamfer_clamp_frac=0.5 * (clamp0 + clamp1))
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _batched_loss(self, batch: KPPairBatch,
                      generator: Optional[torch.Generator], w_saliency,
                      train: bool, pair_weights=None):
        """The group's loss: the ``pair_weights``-weighted sum (uniform by
        default; a zero weight drops a padding pair) of the pairs' losses,
        and the weighted means of their metrics.  Every pair starts from
        the same running stats and draws from its own generator
        (:func:`apr_torch.parallel.mesh.pair_generators`).  In train mode
        each pair's weighted loss is back-propagated as it is computed
        (gradients accumulate), and the running stats end at the weighted
        mean of the pairs' updates.

        Under a mesh, ``batch`` holds this rank's pairs of the group (one
        per rank in the loop), ``pair_weights`` the whole group's weights;
        the weighted sums of losses, running stats and metrics are summed
        over the mesh (the gated update sums the gradients)."""
        mesh = self.mesh
        b = batch.t_gt.shape[0]
        size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        w = (torch.full((b * size,), 1.0 / (b * size), device=self.device)
             if pair_weights is None else torch.as_tensor(
                 pair_weights, dtype=torch.float32, device=self.device))
        w = w[rank * b:(rank + 1) * b]
        gens = pair_generators(generator, b * size)[rank * b:(rank + 1) * b]
        start = [x.clone() for x in self.buffers()] if train else []
        ends, losses, metrics = [], [], []
        for i in range(b):
            with torch.no_grad():
                for x, old in zip(self.buffers(), start):
                    x.copy_(old)
            loss, m = self.loss_fn(select_pair(batch, i), gens[i],
                                   w_saliency, train)
            if train:
                (loss * w[i]).backward()
                ends.append([x.clone() for x in self.buffers()])
            losses.append(loss.detach())
            metrics.append(m)
        with torch.no_grad():
            for k, x in enumerate(self.buffers() if train else []):
                end = sum(w[i] * ends[i][k] for i in range(b))
                x.copy_(end if mesh is None else all_reduce_(end, mesh))
        loss = sum(w[i] * losses[i] for i in range(b))
        metrics = {k: sum(w[i] * m[k] for i, m in enumerate(metrics))
                   for k in metrics[0]}
        if mesh is not None:
            names = sorted(metrics)
            flat = all_reduce_(torch.stack([loss] + [metrics[k].float()
                                                     for k in names]), mesh)
            loss, metrics = flat[0], dict(zip(names, flat[1:]))
        return loss, metrics

    # --- the train steps ------------------------------------------------

    def train_step(self, batch: KPPairBatch,
                   generator: Optional[torch.Generator] = None,
                   w_saliency: float = 0.0) -> Dict[str, torch.Tensor]:
        """One optimization step on one pair; returns the metrics, with
        ``skipped_nonfinite`` 1.0 when the step was skipped.  Spans as in
        :meth:`FCGFTrainer.train_step`."""
        with span("train.forward"):
            saved = [b.clone() for b in self.buffers()]
            self.optimizer.zero_grad(set_to_none=False)
            loss, metrics = self.loss_fn(batch, generator, w_saliency, True)
        with span("train.backward"):
            loss.backward()
        return self._gated_update(loss, saved, metrics, sharded=False)

    def train_step_batched(self, batch: KPPairBatch,
                           generator: Optional[torch.Generator] = None,
                           w_saliency: float = 0.0, pair_weights=None
                           ) -> Dict[str, torch.Tensor]:
        """One optimization step on a group (:meth:`_batched_loss`)."""
        saved = [b.clone() for b in self.buffers()]
        self.optimizer.zero_grad(set_to_none=False)
        loss, metrics = self._batched_loss(batch, generator, w_saliency,
                                           True, pair_weights)
        return self._gated_update(loss, saved, metrics)

    def train_step_batched_fused(self, batch: KPPairBatch,
                                 generator: Optional[torch.Generator],
                                 w_saliency, raw_next: Sequence,
                                 pair_weights=None):
        """:meth:`train_step_batched` on ``batch``, then the next group's
        build from ``raw_next``: (metrics, next_batch)."""
        metrics = self.train_step_batched(batch, generator, w_saliency,
                                          pair_weights)
        return metrics, self.build_batch_group(raw_next)

    # --- validation -----------------------------------------------------

    @torch.no_grad()
    def valid_step(self, batch: KPPairBatch,
                   generator: Optional[torch.Generator] = None,
                   w_saliency: float = 0.0) -> Dict[str, torch.Tensor]:
        """The loss terms of one pair (running stats, no update)."""
        return self.loss_fn(batch, generator, w_saliency, train=False)[1]

    @torch.no_grad()
    def valid_step_batched(self, batch: KPPairBatch,
                           generator: Optional[torch.Generator] = None,
                           w_saliency: float = 0.0
                           ) -> Dict[str, torch.Tensor]:
        """The group's mean loss terms."""
        return self._batched_loss(batch, generator, w_saliency, False)[1]
