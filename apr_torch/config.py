"""Typed configuration: the port's own copy of ``apr_tpu.config.APRConfig``.

Field names and defaults are the reference's, so a ``config.json`` the
reference wrote loads with :meth:`APRConfig.from_dict` (fields the port
does not read yet are dropped).  It holds the fields the two registration
evals (FCGF and Predator) and the two training steps read; the later
slices add theirs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class APRConfig:
    # --- trainer / model (FCGF path) ---
    trainer: str = "GenerativePairTrainer"
    batch_size: int = 4
    iter_size: int = 1
    model: str = "ResUNetFatBN"
    model_n_out: int = 128
    conv1_kernel_size: int = 5
    normalize_feature: bool = True
    bn_momentum: float = 0.05
    # conv compute dtype: "bfloat16" rounds conv operands to bf16 and
    # accumulates in float32 (params stay float32 masters); "float32" or
    # None keeps everything in float32
    compute_dtype: str = "bfloat16"
    generator_model: str = "GenerativeMLP_98"
    point_generation_ratio: int = 4
    symmetric: bool = False

    # --- contrastive loss ---
    num_pos_per_batch: int = 1024
    num_hn_samples_per_batch: int = 256
    pos_thresh: float = 0.1
    neg_thresh: float = 1.4
    neg_weight: float = 1.0
    hit_ratio_thresh: float = 0.3

    # --- generative loss ---
    loss_ratio: float = 2e-3
    regularization_strength: float = 0.01
    regularization_type: str = "L2"
    alpha: float = 1.0
    # Chamfer backend: "window" (cell-sorted windowed NN, plain torch),
    # "exact" (plain brute force), "pallas" (brute force through kernel K2)
    chamfer_mode: str = "window"
    chamfer_cell_multiplier: float = 4.0   # cell = multiplier * voxel_size

    # --- KPConv / Predator path (the reference's YAML field names) ---
    first_feats_dim: int = 256
    final_feats_dim: int = 32
    first_subsampling_dl: float = 0.3
    conv_radius: float = 4.25
    deformable: bool = False      # deformable KPConv in resnet blocks
    modulated: bool = False       # sigmoid-gated kernel points (deformable)
    num_kernel_points: int = 15
    KP_extent: float = 2.0
    condition_feature: bool = True
    add_cross_score: bool = True
    gnn_feats_dim: int = 256
    dgcnn_k: int = 10
    num_head: int = 4
    nets: Tuple[str, ...] = ("self", "cross", "self")
    neighborhood_limits: Tuple[int, ...] = (40, 40, 40, 40)
    kp_capacities: Tuple[int, ...] = (16384, 4096, 2048, 1024)
    # GT match radius of the KP batch (make_kp_pair_batch)
    overlap_radius: float = 0.45

    # --- Predator MetricLoss (losses/circle.py) ---
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    log_scale: float = 48.0
    pos_radius: float = 0.21
    safe_radius: float = 0.75
    matchability_radius: float = 0.3
    max_points: int = 512
    w_circle_loss: float = 1.0
    w_overlap_loss: float = 1.0

    # --- optimizer ---
    optimizer: str = "SGD"
    lr: float = 1e-1
    sgd_momentum: float = 0.9
    weight_decay: float = 1e-4
    exp_gamma: float = 0.99

    # --- data ---
    voxel_size: float = 0.3
    positive_pair_search_voxel_size_multiplier: float = 1.5

    # --- static capacities (fixed buffer sizes) ---
    point_capacity: int = 131072          # raw points per cloud
    capacities: Tuple[int, ...] = (16384, 8192, 4096, 2048)
    apc_capacity: int = 65536             # aggregated point cloud target
    corr_capacity_per_point: int = 1      # GT matches kept per source point

    # --- eval ---
    test_num_ransac_hypotheses: int = 32768
    test_ransac_dist_thresh: Optional[float] = None  # default: voxel_size
    # confidence-style RANSAC escalation (registration/ransac.py): None or 0
    # is off; a factor f > 0 adds up to ``rungs`` stages of f x hypotheses
    test_ransac_escalation_factor: Optional[int] = None
    test_ransac_escalation_min_inliers: int = 30
    test_ransac_escalation_rungs: int = 1
    test_ransac_escalation_confidence: float = 0.0
    test_subsample: int = 5000
    # occupancy-driven capacity bucketing (eval/bucketing.py): number of
    # halving tiers below the worst-case capacities (None or 0 = off)
    test_capacity_buckets: Optional[int] = None
    rte_thresh: float = 2.0
    rre_thresh: float = 5.0

    @classmethod
    def from_dict(cls, d: dict) -> "APRConfig":
        """Config from a dict such as a reference ``config.json``; unknown
        keys are dropped and list values of tuple fields become tuples."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in fields}
        for name, v in known.items():
            if isinstance(fields[name].default, tuple):
                known[name] = tuple(v)
        return cls(**known)
