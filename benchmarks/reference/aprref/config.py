# Frozen copy of apr_torch/config.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Typed configuration: the port's own copy of ``apr_tpu.config.APRConfig``.

Field names and defaults are the reference's, so a ``config.json`` the
reference wrote loads with :meth:`APRConfig.from_dict` (fields the port
does not read are dropped).  It holds the fields the two registration
evals, the two trainers, their loops, the dataset loaders and the entry
points read; the later slices add theirs.  :func:`read_yaml` parses the
two-level YAML of ``configs/*/*.yaml`` with the standard library (the port
may not import ``yaml``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class APRConfig:
    # --- trainer / model (FCGF path) ---
    trainer: str = "GenerativePairTrainer"
    batch_size: int = 4
    val_batch_size: int = 1
    iter_size: int = 1
    max_epoch: int = 200
    stat_freq: int = 40
    val_epoch_freq: int = 1
    best_val_metric: str = "feat_match_ratio"
    seed: int = 0
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
    # False: calibrate the limits on the train set before training
    # (training/predator_loop.py); True: keep them as configured
    neighborhood_limits_pinned: bool = True
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
    w_saliency_loss: float = 0.0

    # --- optimizer ---
    optimizer: str = "SGD"
    lr: float = 1e-1
    sgd_momentum: float = 0.9
    weight_decay: float = 1e-4
    exp_gamma: float = 0.99

    # --- data / APG (data/datasets.py names the loaders) ---
    dataset: str = "PairComplementKittiDataset"
    kitti_root: str = "./data/kitti"
    kitti_max_time_diff: int = 3  # baseline KITTIPairDataset dt range
    voxel_size: float = 0.3
    pair_min_dist: float = 5.0
    pair_max_dist: float = 20.0
    complement_pair_dist: float = 10.0
    num_complement_one_side: int = 3
    use_old_pose: bool = False
    min_scale: float = 0.8
    max_scale: float = 1.2
    random_scale: bool = True
    random_rotation: bool = True
    mutate_neighbour_percentage: float = 0.0
    # the Predator flavour of the KITTI augmentation (data/kitti.py::
    # d3feat_augment) in place of the FCGF rotation and scale
    d3feat_augmentation: bool = False
    augment_noise: float = 0.01
    augment_shift_range: float = 2.0
    LoKITTI: bool = False
    LoNUSCENES: bool = False
    downsample_single: float = 1.0
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
    # the train loader's analog (data/pipeline.py): group each epoch's
    # pairs into capacity tiers (0 = off; ignored by the fused build)
    train_capacity_buckets: int = 0
    rte_thresh: float = 2.0
    rre_thresh: float = 5.0

    # --- io ---
    out_dir: str = "./outputs"
    resume: Optional[str] = None
    weights: Optional[str] = None
    # torch.profiler trace of steps [profile_start, profile_start +
    # profile_steps) into this directory
    profile_dir: Optional[str] = None
    profile_start: int = 5
    profile_steps: int = 3

    # --- parallel ---
    # data parallel over the first num_devices ranks of the process group
    # (one process per device; None: every rank of a launched group)
    num_devices: Optional[int] = None
    # build batch i+1 in the same loop iteration as batch i's step (the
    # loop's fused path; bitwise the same as the separate one)
    fused_build: bool = False
    # the last mesh_n_builders ranks build batches while the others train
    mesh_n_builders: int = 0

    def replace(self, **kw) -> "APRConfig":
        """A copy with ``kw`` applied; lists become tuples."""
        for f in dataclasses.fields(self):
            if f.name in kw and isinstance(kw[f.name], list):
                kw[f.name] = tuple(kw[f.name])
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load_json(cls, path: str) -> "APRConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_yaml(cls, path: str) -> "APRConfig":
        """A two-level YAML (Predator style) or a flat one, flattened."""
        return cls.from_dict(flatten(read_yaml(path)))

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


def flatten(raw: dict) -> dict:
    """One level of nesting folded away: the sections of a Predator-style
    YAML merge into one flat dict, in file order."""
    flat = {}
    for k, v in raw.items():
        if isinstance(v, dict):
            flat.update(v)
        else:
            flat[k] = v
    return flat


# the implicit scalar types of YAML 1.1, as yaml.safe_load resolves them
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_OTHER_INT = re.compile(r"[-+]?(?:0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                        r"|[1-9][0-9_]*(?::[0-5]?[0-9])+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF_NAN = {**dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf",
                             "+.INF"), float("inf")),
            **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
            **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan"))}


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if text in _INF_NAN:
        return _INF_NAN[text]
    if _OTHER_INT.fullmatch(text) or text[0] in "[]{}&*!|>%@`\"'-":
        raise ValueError(f"YAML scalar {text!r} is outside the subset "
                         f"read_yaml parses")
    return text


def _value(text: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]") or "[" in text[1:] or "{" in text:
            raise ValueError(f"YAML flow sequence {text!r} is outside the "
                             f"subset read_yaml parses")
        inner = text[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    return _scalar(text)


def _strip_comment(line: str) -> str:
    """The line without its comment: a # at the start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(path: str) -> dict:
    """The block mappings of a YAML file as nested dicts, with YAML 1.1's
    scalars (ints, floats such as ``0.000001``, booleans, nulls, quoted
    strings) and flow sequences of scalars (``[self, cross, self]``): what
    ``yaml.safe_load`` gives on ``configs/*/*.yaml``.  Other syntax
    raises ``ValueError``."""
    root: dict = {}
    stack = [(0, root)]            # (indent of its keys, mapping) open
    pending = None                 # (indent, mapping, key) of a bare "key:"
    with open(path) as f:
        lines = f.read().splitlines()
    for n, raw in enumerate(lines, 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        key, sep, rest = body.partition(":")
        if not sep or not key or (rest and not rest[0].isspace()):
            raise ValueError(f"{path}:{n}: not a 'key: value' line")
        if pending is not None and indent > pending[0]:
            child = pending[1][pending[2]] = {}
            stack.append((indent, child))
        pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{path}:{n}: inconsistent indentation")
        mapping, key = stack[-1][1], _scalar(key)
        mapping[key] = _value(rest) if rest.strip() else None
        if not rest.strip():
            pending = (indent, mapping, key)
    return root
