"""The Predator-APR batch and trainer construction (port of
``apr_tpu/training/predator.py``): ``make_kp_pair_batch`` builds one
pair's two KP pyramids, its ground-truth correspondences and its APC
targets; ``PredatorTrainer`` holds the KPFCNN and the generator.

The Predator loss and its train / valid steps arrive with the Predator
training slice; until then they raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apr_torch.config import APRConfig
from apr_torch.device import resolve_device
from apr_torch.models.kpconv import KPPyramid, build_kp_pyramid, \
    reset_kp_parameters_, select_cloud
from apr_torch.models.kpfcnn import KPFCNN
from apr_torch.models.mlp import make_generative_mlp
from apr_torch.ops.voxelize import dedup_points
from apr_torch.registration.matching import gt_correspondences

_TRAINING = "arrives with the Predator training slice"


class KPPairBatch(NamedTuple):
    """One pair: both pyramids (levels without a batch dim), the GT
    correspondences on the level-0 points, the APC targets and t_gt."""

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
    """One pair -> its pyramids (both clouds in one batched build), the GT
    matches within ``overlap_radius`` on the level-0 points (``corr_cap``
    per source point) and the voxel-deduplicated APC targets (skipped for
    placeholders of 8 rows or fewer).  Inputs may be numpy arrays or
    tensors; they move to ``device``."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    pts = torch.stack([put(points0, torch.float32),
                       put(points1, torch.float32)])
    msk = torch.stack([put(mask0, torch.bool), put(mask1, torch.bool)])
    t_gt = put(t_gt, torch.float32)
    pyr = build_kp_pyramid(pts, msk, first_subsampling_dl, conv_radius,
                           len(capacities), tuple(capacities),
                           tuple(neighbor_limits))
    lv0 = pyr.levels[0]
    corr = gt_correspondences(
        lv0.points[:1], lv0.points[1:], t_gt[None], radius=overlap_radius,
        cap_per_point=corr_cap, mask0=lv0.mask[:1], mask1=lv0.mask[1:])

    apc = torch.stack([put(apc0, torch.float32), put(apc1, torch.float32)])
    apc_mask = torch.stack([put(apc0_mask, torch.bool),
                            put(apc1_mask, torch.bool)])
    if apc.shape[1] > 8:
        apc, apc_mask = dedup_points(apc, first_subsampling_dl, apc_mask)
    return KPPairBatch(
        pyr0=select_cloud(pyr, 0), pyr1=select_cloud(pyr, 1),
        corr_src=corr.src_idx[0], corr_tgt=corr.tgt_idx[0],
        corr_mask=corr.mask[0], apc0=apc[0], apc0_mask=apc_mask[0],
        apc1=apc[1], apc1_mask=apc_mask[1], t_gt=t_gt)


class PredatorTrainer:
    """Holds the KPFCNN (``model``) and the Predator generator MLP
    (``generator``, ending Linear-ReLU-BatchNorm), with random weights from
    ``seed`` on ``device``, in eval mode."""

    def __init__(self, config: APRConfig, device="cuda", seed: int = 0):
        c = config
        self.config = config
        self.device = resolve_device(device)
        if c.symmetric:
            raise NotImplementedError(f"symmetric NPR (KPFCNNDecoder) "
                                      f"{_TRAINING}")
        cd = None if c.compute_dtype in (None, "float32") else c.compute_dtype
        self.model = KPFCNN(
            final_feats_dim=c.final_feats_dim,
            first_feats_dim=c.first_feats_dim,
            gnn_feats_dim=c.gnn_feats_dim, dgcnn_k=c.dgcnn_k,
            num_head=c.num_head, nets=tuple(c.nets),
            first_subsampling_dl=c.first_subsampling_dl,
            conv_radius=c.conv_radius, kp_extent=c.KP_extent,
            num_kernel_points=c.num_kernel_points,
            condition_feature=c.condition_feature,
            add_cross_score=c.add_cross_score, deformable=c.deformable,
            modulated=c.modulated, compute_dtype=cd)
        reset_kp_parameters_(self.model, torch.Generator().manual_seed(seed))
        self.model = self.model.to(self.device).eval()
        self.generator = make_generative_mlp(
            c.generator_model, out_points=c.point_generation_ratio,
            in_channels=c.final_feats_dim, final_bn=True, device=self.device,
            seed=seed + 1)

    def loss_fn(self, *args, **kwargs):
        raise NotImplementedError(f"the Predator loss {_TRAINING}")

    def train_step(self, *args, **kwargs):
        raise NotImplementedError(f"the Predator train step {_TRAINING}")

    def valid_step(self, *args, **kwargs):
        raise NotImplementedError(f"the Predator valid step {_TRAINING}")
