#!/usr/bin/env python3
"""Drive the apr_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card
    python3 chip_smoke.py --phases 16,22-25   # these phases (and 1, 2) only
    python3 chip_smoke.py --k1-baseline DIR   # phases 3b, 8 time DIR's K1 too

Phases (each prints its lines and raises on failure, so any failure exits
non-zero; with no card, or outside a checkout, it exits non-zero at once):

1. device: the card's name and power limit, the TF32 settings;
2. build: every kernel under apr_torch/csrc, from the checkout's sources;
3. kernel K1 (searchsorted_left, grouped: one launch per pyramid build)
   against its plain version, exact: (a) the contract cases, one by one and
   grouped, (b) the seven searches of a full-capacity pyramid build over 8
   clouds in one grouped launch, with grouped kernel / plain / 7x
   torch.searchsorted times and the memory bound (and, with --k1-baseline,
   the K1 of another checkout, exact and timed the same way);
4. pyramid: the fast kernel maps (through K1) and the transposed up maps
   equal the slow oracles;
5. encoder: ResUNetFatBN in float32 on the card against the CPU, and the
   bf16 deviation;
6. RANSAC on a ground-truth correspondence set with 50% outliers;
7. the eval slice: FeatureTester.test on 8 synthetic pairs at full width,
   with K1's launch count read around it (exactly one per batch build), and
   a per-stage time split;
8. K1 at the eval path's shapes (one build, B=2): grouped kernel / plain /
   7x torch.searchsorted (/ baseline) times and the bound;
9. kernel K2 (nn_min) against its plain version, exact in d2 and idx, on
   the contract cases, with and without a query mask;
10. the training slice: FCGFTrainer.train_step at full width (ResUNetFatBN
   128, bf16, B=4, APC 65536, chamfer_mode="pallas") for TRAIN_STEPS steps
   with the launch counts of K1 and K2 read around them (one K1 launch per
   batch build, four K2 launches per step), a per-stage time split, one
   step in chamfer_mode="window" and one valid_step;
11. K2 at the train step's shapes: its four launches of one step, with the
   query masks the loss hands it, against the plain version (exact) with
   wrapper / partition / kernel / plain / torch.cdist times, the bound and
   the share of it;
12. one float32 train step at a small size, card against CPU, from the same
   weights and the same contrastive samples, and the same step with a
   planted backward fault, which the check must catch;
13. the Predator KP pyramid of one full-capacity pair built on the card and
   on the CPU (rows that differ end to end, the exact fallbacks), then
   the windowed and brute-force radius searches, the 1-NN upsample and the
   GT correspondences with cap 2 from the same barycenters: kernel K3
   against the plain torch chain on the card and on the CPU, held exact,
   with both chains' device times; then one batch build at
   predator-apr.train's shapes: K3 launches, card searches left on the
   plain chain (none), windowed searches and fallbacks, the build by K3
   and by the plain chain equal in every field with both walls, and each
   search it made, recorded at its call site, K3 against the plain chain,
   exact and timed, with K3's operation bound from the pairs it scores;
14. the KPFCNN forward at full width from the same batch and weights,
   float32 card against CPU (gated) and bf16 against float32;
15. the Predator eval slice: PredatorTester.test on 8 synthetic pairs at
   full width (KPFCNN-256, bf16), pipelined pairs/s, peak memory, recall /
   RTE / RRE, no K1 or K2 launch (the path runs no hand-written kernel),
   and a per-stage time split (build, forward, eval);
16. the Predator training slice: PredatorTrainer.train_step at
   configs/train/kitti.yaml's full width (KPFCNN-256 bf16, GenerativeMLP_98
   ratio 4, SGD 0.01 / 0.98 / 1e-6, KP capacities 32768/8192/4096/2048,
   APC 131072, max_points 512, chamfer_mode="pallas") for TRAIN_STEPS
   single-pair steps (w_saliency 0, then 1) with the K1 / K2 launch counts
   read around them (0 K1, 4 K2 per step), steps/s, peak memory and a
   stage split; one "window" step, one valid_step and one
   train_step_batched_fused at B = 2 (8 K2 launches); the step run twice
   from fresh trainers (PT_PAIR seed 300), bit for bit in every loss
   term, running stat, parameter and gradient leaf (on a difference, the
   first module whose input gradient differs); then K2 at this step's
   shapes against its plain version (exact), timed against its bound;
17. one float32 Predator train step at a small size, card against CPU,
   from the same weights and correspondence draws, and the same step with
   a planted backward fault (the GCN's attention message detached), which
   the check must catch;
18. the FCGF training loop through its CLI (``apr_torch.train.main``) at
   phase 10's full width with the fused build, over 12 train and 4 val
   synthetic pairs for one epoch, then ``--resume_dir`` to a second: 3
   steps an epoch, finite metrics, no skipped step, one K1 launch per
   batch build and 4 K2 launches per train step and val batch, the
   artifacts, and the resumed trainer equal to the saved one bit for bit
   before its first step; loop steps/s, the data / step timers, peak
   memory; then two full-width iter_size=2 mini-steps (the weights move on
   the second only) and two symmetric steps (a ResUNetBN2B decoder);
19. the Predator training loop through the YAML entry
   (``apr_torch.main.main``) on a copy of configs/train/kitti.yaml (only
   dataset, chamfer_mode, max_epoch, out_dir and fused_build overridden)
   over 4 train and 2 val pairs: 0 K1 and 4 K2 launches per train step and
   val pair, finite metrics, the checkpoint tags; test mode on a copy of
   configs/test/kitti.yaml with that run's weights (results.npz); two
   full-width iter_size=2 Predator mini-steps;
20. the real-data path on a KITTI-format tree written into a temporary
   directory (frames of 120000 points): the FCGF training loop through the
   CLI on PairComplementKittiDataset at phase 10's width, then
   ``python -m apr_torch.scripts.test_apr`` (LoKITTI) and ``test_fcgf`` on
   that run (one K1 launch per batch build, 4 K2 per train step and val
   batch, results.npz); the Predator loop on a copy of
   configs/train/kitti.yaml (only kitti_root, out_dir, max_epoch,
   chamfer_mode and fused_build overridden; 0 K1, 4 K2 per step and val
   pair) and test mode on configs/test/kitti.yaml; a reference-layout
   ResUNetFatBN-128 .pth state_dict imported, its encoder card vs CPU;
21. the odometry-pose GT path on a KITTI-format sequence whose odometry
   poses carry a known error: ``apr_torch.tools.prepare_icp_cache`` on the
   card (one K2 launch per ICP iteration and per information matrix; every
   cache file the loaders read; ICP reduces each transform's error to the
   true pose), then ``python -m`` again (it keeps every file); one pair's
   ICP and one multiway side card vs CPU (within 1e-9, equal iterations);
   the pair's ICP with scipy's cKDTree on the host, and K2 at the ICP's
   shape exact against its plain version; an FCGF train step through the
   CLI on ``use_old_pose=True`` pairs (1 K1, 4 K2), the baseline loader's
   GT from the cache, ``extract_features`` on one frame (1 K1, card vs
   CPU) and ``cal_overlap`` on three frames (equal to cKDTree's ratios);
22. the multi-device paths (one card: NCCL refuses two ranks on one GPU):
   (a) the FCGF data-parallel step at phase 10's config and the grouped
   Predator step at kitti.yaml's width through ``make_mesh`` on NCCL at
   world size 1 against the meshless steps, bit for bit (loss terms,
   running stats, every parameter and gradient), the Predator step twice
   bit for bit, and ``python -m apr_torch.dryrun 1``; then two gloo ranks
   spawned on the card: (b) the
   same step at B = 2 + 2 against the one-process B = 4 step (loss terms
   and running stats within 1e-4, each gradient leaf by phase 12's rule, a
   planted fault caught, the ranks bit for bit, 1 K1 / 4 K2 a rank); (c)
   the grouped Predator step at kitti.yaml's width, one pair a rank, the
   second of weight 0, against the one-process group (phase 17's rule, 0
   K1 / 4 K2 a rank); (d) test_sharded of both testers on 8 pairs against
   the one-process steps with the same per-pair draws (exact); (e)
   chamfer_sp on two 65536-point clouds against chamfer_distance; (f) the
   builder / trainer pipeline (1 + 1) for 3 steps against serial steps;
23. ops: ``segment_mean_capped``, ``voxel_down_sample`` and
   ``grid_subsample`` on a 120000-point cloud at 0.3 m, twice on the card
   and on the CPU, all bit for bit; ``bitonic_sort`` / ``bitonic_argsort``
   on its voxel keys padded to 131072 as one row, and to [8, 32768],
   twice on the card, against the CPU (bit for bit) and against
   ``torch.sort``; the ``apr_torch.ops`` recipe (voxelize,
   radius_neighbors, chamfer_distance);
24. the synthetic-convergence tools at short settings through their
   mains: ``validate_convergence`` (8 steps, window and pallas Chamfer:
   one K1 launch a batch build, 4 K2 a pallas step),
   ``validate_predator_convergence`` (4 steps, no K1 / K2),
   ``validate_apr_gain`` (4 steps, both arms) with ``pool_apr_gain`` on
   its log, and ``sweep_ransac`` on 4 pairs at one ratio;
25. ``apr_torch.native``: the host library built with g++ at first use,
   against its numpy fallbacks on a 120000-point cloud;
26. the seven profilers (``apr_torch/tools/profile_*.py``,
   ``probe_radius_select``) through their mains at their defaults with 2
   iterations a stage, and ``profile_predator_sustained`` at phase 16's
   config: every stage line, K1 / K2 launches per iteration (1 K1 a
   FCGF build, 4 K2 a pallas train step, none on the Predator eval), and
   the tools' step times (card busy ms) within 20% of the stage splits of
   phases 10 and 16.
The timers (``cuda_ms``, ``host_ms``, ``profiled``, ``stage_split``) are
``apr_torch/utils/profiling.py``'s, the profilers' own.
``--phases`` runs a subset (phases 1 and 2 always run); timings of
phases not selected are null in the record.  The line before the last is
the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.isdir(os.path.join(HERE, "apr_torch")):   # else main() stops
    sys.path.insert(0, HERE)
    # the timers the profilers use too (apr_torch/utils/profiling.py)
    from apr_torch.utils.profiling import cuda_ms, device_line, host_ms, \
        profiled, stage_split
# the main path at full width (the sizes of bench.py's FCGF eval)
DEVICE = "cuda"
CAPS = (16384, 8192, 4096, 2048)
POINT_CAPACITY = 32768
N_POINTS = 30000
N_PAIRS = 8
SUBSAMPLE = 5000
HYPOTHESES = 32768
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
# H100 SXM float32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two operations, so 3.35e13 instructions a second; K2's
# subtractions, products and sums cannot fuse and count one each
FP32_OPS_PER_S = 3.35e13
K2_OPS_PER_PAIR = 8              # 3 subtractions, 3 products, 2 sums
K3_OPS_PER_PAIR = 8              # the same, K3's float32 pre-test
ENC_F32_TOL = 1e-4               # abs, on unit-norm float32 features
# phase 12: max |card - CPU| over max |CPU| within each gradient leaf, that
# maximum raised by GRAD_FLOOR of the largest gradient of all leaves
GRAD_TOL = 0.1
GRAD_FLOOR = 1e-5
# the training slice: apr_tpu/config.py's defaults, with the Chamfer that
# runs kernel K2
TRAIN_FIELDS = dict(chamfer_mode="pallas")
TRAIN_STEPS = 5
TRAIN_POINTS = 30000
TRAIN_APC_POINTS = 60000
# the Predator eval slice: bench.py's Predator eval config (KPFCNN-256 up
# to 2048 at the bottleneck, GCN self/cross/self, bf16) on 8 pairs
KP_FIELDS = dict(trainer="PredatorTrainer", first_feats_dim=256,
                 gnn_feats_dim=256, final_feats_dim=32, num_kernel_points=15,
                 nets=("self", "cross", "self"), dgcnn_k=10, num_head=4,
                 compute_dtype="bfloat16",
                 kp_capacities=(16384, 4096, 2048, 1024),
                 neighborhood_limits=(40, 40, 40, 40),
                 point_capacity=POINT_CAPACITY, test_subsample=SUBSAMPLE,
                 test_num_ransac_hypotheses=HYPOTHESES)
KP_PAIR = dict(n_points=N_POINTS, apc_points=4, extent=60.0, distance=15.0)
# phase 14: max abs difference of features, overlap and saliency, card vs
# CPU in float32 (ten times the FCGF encoder's: four levels deeper, and a
# softmax at temperature 0.037 before the decoder)
KP_F32_TOL = 1e-3
# the Predator training slice: configs/train/kitti.yaml's model, loss and
# optimizer at full width (KPFCNN-256, GCN self/cross/self, final 32,
# GenerativeMLP_98 ratio 4, SGD 0.01 / 0.98 / 1e-6, KP capacities
# 32768/8192/4096/2048, bf16 by default), with the Chamfer that runs kernel
# K2 (the yaml sets no Chamfer mode)
PT_FIELDS = dict(
    trainer="PredatorTrainer", first_feats_dim=256, final_feats_dim=32,
    first_subsampling_dl=0.3, conv_radius=4.25, num_kernel_points=15,
    KP_extent=2.0, gnn_feats_dim=256, dgcnn_k=10, num_head=4,
    nets=("self", "cross", "self"), generator_model="GenerativeMLP_98",
    point_generation_ratio=4, pos_margin=0.1, neg_margin=1.4, log_scale=48.0,
    pos_radius=0.21, safe_radius=0.75, overlap_radius=0.45,
    matchability_radius=0.3, max_points=512, w_circle_loss=1.0,
    w_overlap_loss=1.0, loss_ratio=0.001, regularization_strength=0.01,
    optimizer="SGD", lr=0.01, sgd_momentum=0.98, weight_decay=1e-6,
    exp_gamma=0.99, batch_size=1, point_capacity=131072,
    apc_capacity=131072, kp_capacities=(32768, 8192, 4096, 2048),
    neighborhood_limits=(40, 40, 40, 40), chamfer_mode="pallas")
# 75000 points fill about 92% of level 0's 32768 voxels; 120000 APC points
# keep about 42000 after the 0.3 m dedup
PT_PAIR = dict(n_points=75000, apc_points=120000, extent=60.0, distance=10.0)
# phase 17's GRAD_TOL: the Predator backward is worse conditioned than the
# FCGF one.  Near-ties in its max pools, EdgeConv maxima and ReLUs switch
# under a change of the last bit, and at phase 17's size a 1e-6 relative
# nudge of the weights moved a gradient leaf by up to 0.11 of its own
# largest entry (12 nudges on the CPU, 0.02-0.06 for most), where the
# planted fault moves most leaves by about 1
PT_GRAD_TOL = 0.3
K1 = dict(name="searchsorted_left", source="apr_torch/csrc/searchsorted.cu",
          replaces="apr_tpu/ops/pallas/searchsorted.py:116")
K2 = dict(name="nn_min", source="apr_torch/csrc/nn_min.cu",
          replaces="apr_tpu/ops/pallas/distance.py:86")
K3 = dict(name="radius_select", source="apr_torch/csrc/radius_select.cu",
          replaces=None)   # XLA's top_k in apr_tpu/ops/neighbors.py


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def tree_map(fn, *trees):
    """``fn`` leafwise over tensors in nested tuples / NamedTuples."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    items = [tree_map(fn, *xs) for xs in zip(*trees)]
    return (type(trees[0])(*items) if hasattr(trees[0], "_fields")
            else tuple(items))


def searches_of(lv, conv1_kernel_size):
    """The seven (name, support [B, S], queries [B, G, C]) searches that
    build_pyramid_from_level makes over the levels ``lv``."""
    from apr_torch.models.sparse import pyramid_searches

    return [(name, z.support, z.t0)
            for name, z in pyramid_searches(lv, conv1_kernel_size)]


def baseline_k1(root):
    """K1 as another checkout of this repo has it: that checkout's
    ``searchsorted_left`` wrapper over a library built from its
    ``csrc/searchsorted.cu``.  Returns a function that runs the wrapper
    once per search of a list, so that an earlier K1 is timed against this
    one on the same card, in the same run and with the same timer."""
    import ctypes
    import importlib.util
    from pathlib import Path

    from apr_torch.kernels import build

    root = Path(root).resolve()
    lib = ctypes.CDLL(str(build._build_one(
        build._nvcc(), root / "apr_torch" / "csrc" / "searchsorted.cu")))
    spec = importlib.util.spec_from_file_location(
        "baseline_searchsorted", root / "apr_torch" / "ops" / "searchsorted.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(pairs):
        # the wrapper loads its library by name at each call: hand it the
        # baseline's for the duration of the call
        real, build.load = build.load, lambda name: lib
        try:
            return [mod.searchsorted_left(sup, q) for sup, q in pairs]
        finally:
            build.load = real
    return run


def time_searches(searches, reps=20, baseline=None):
    """The grouped kernel over all ``searches`` (one launch), held to the
    plain version (exact) search by search; then grouped kernel / plain /
    per-search torch.searchsorted times, each summed over the searches,
    and the memory bound.  With ``baseline`` (from :func:`baseline_k1`),
    that K1 too, held to the plain version and timed beside this one.
    Returns the totals and the largest error."""
    from apr_torch.ops.searchsorted import searchsorted_left_many, \
        searchsorted_left_plain

    pairs = [(sup, q) for _, sup, q in searches]
    got = searchsorted_left_many(pairs)
    old = baseline(pairs) if baseline else [None] * len(pairs)
    err, bound_ms = 0, 0.0
    for (name, sup, q), out, out_old in zip(searches, got, old):
        b, s = sup.shape
        g, c = q.shape[1:]
        want = searchsorted_left_plain(sup, q)
        e = int((out - want).abs().max())
        if e != 0:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}: max abs err {e}")
        if out_old is not None and not torch.equal(out_old, want):
            raise AssertionError(f"the baseline K1 disagrees with the plain "
                                 f"version on {name}")
        err = max(err, e)
        bound = (2 * g * c + s) * 4 * b / HBM_BYTES_PER_S * 1e3
        bound_ms += bound
        print(f"  {name:6s} B={b} G={g:3d} C={c:5d} S={s:5d}  bound "
              f"{bound * 1e3:6.2f} us  exact", flush=True)
    flat = [(sup, q.reshape(q.shape[0], -1)) for sup, q in pairs]
    r = dict(
        max_abs_err=err, bound_ms=bound_ms,
        ms=cuda_ms(lambda: searchsorted_left_many(pairs), reps),
        plain_ms=cuda_ms(lambda: [searchsorted_left_plain(sup, q)
                                  for sup, q in pairs], 3),
        library_ms=cuda_ms(lambda: [torch.searchsorted(sup, q, out_int32=True)
                                    for sup, q in flat], reps),
        host_ms=host_ms(lambda: searchsorted_left_many(pairs)),
        library_host_ms=host_ms(lambda: [
            torch.searchsorted(sup, q, out_int32=True) for sup, q in flat]))
    print(f"  all {len(pairs)} searches, device time: grouped kernel (1 "
          f"launch) {r['ms'] * 1e3:8.1f} us  plain "
          f"{r['plain_ms'] * 1e3:9.1f} us  {len(pairs)}x torch.searchsorted "
          f"{r['library_ms'] * 1e3:8.1f} us  bound {bound_ms * 1e3:6.2f} us"
          f"; host time to enqueue: grouped kernel "
          f"{r['host_ms'] * 1e3:6.1f} us, {len(pairs)}x torch.searchsorted "
          f"{r['library_host_ms'] * 1e3:6.1f} us", flush=True)
    if baseline:
        r.update(baseline_ms=cuda_ms(lambda: baseline(pairs), reps),
                 baseline_host_ms=host_ms(lambda: baseline(pairs)))
        print(f"  baseline K1 ({len(pairs)} calls of its searchsorted_left): "
              f"device time {r['baseline_ms'] * 1e3:8.1f} us, host time to "
              f"enqueue {r['baseline_host_ms'] * 1e3:6.1f} us; exact",
              flush=True)
    return r


def contract_cases():
    """The four cases of tests/test_pallas_searchsorted.py (holes and
    padding, multi-slab spans, extremes and duplicates, empty support) and
    the window edges of the two-level search (duplicate runs across every
    32-key edge, S < 32, S % 32 != 0, S = 0) and supports whose coarse
    table is large (S = 60000) or needs a stride above 32 (S = 300000),
    as [S] and [G, C]."""
    from apr_torch.ops.hashing import INVALID_KEY

    rng = np.random.default_rng(0)
    sup = np.sort(rng.choice(100000, 700, replace=False)).astype(np.int32)
    sup = np.concatenate([sup, np.full(324, INVALID_KEY, np.int32)])
    rows = []
    for _ in range(5):
        q = np.sort(rng.choice(110000, 512, replace=False)).astype(np.int32)
        q[rng.random(512) < 0.1] = INVALID_KEY
        q[-40:] = INVALID_KEY
        rows.append(q)
    cases = [("holes and padding", sup, np.stack(rows))]
    q = np.arange(0, 128 * 512 * 2, 512, dtype=np.int32)[None, :128]
    cases.append(("multi-slab spans",
                  np.arange(0, 131072, 2, dtype=np.int32)[:8192],
                  np.broadcast_to(q, (2, 128)).copy()))
    dup = np.sort(rng.integers(100, 200, 512).astype(np.int32))
    cases += [
        ("duplicates", dup,
         np.sort(rng.integers(0, 300, 256).astype(np.int32))[None]),
        ("all below", dup, np.zeros((1, 128), np.int32)),
        ("all above", dup, np.full((1, 128), 250, np.int32)),
        ("empty support", np.full(128, INVALID_KEY, np.int32),
         np.arange(128, dtype=np.int32)[None]),
        ("S = 60000", np.arange(0, 200000, 3, dtype=np.int32)[:60000],
         np.sort(rng.integers(-5, 190000, (3, 1000)).astype(np.int32),
                 axis=1)),
    ]
    edge = np.repeat(np.arange(0, 40, dtype=np.int32) * 7, 24)[:900]
    q_edge = np.sort(rng.integers(-3, 290, (3, 300)).astype(np.int32), axis=1)
    q_edge[:, -20:] = INVALID_KEY
    cases += [
        ("duplicates across 32-key edges",
         np.concatenate([edge, np.full(124, INVALID_KEY, np.int32)]), q_edge),
        ("S < 32", np.array([3, 3, 9, 12, 40, 41, 41, 77, 100, 230], np.int32),
         np.arange(-2, 240, 2, dtype=np.int32)[None]),
        ("S % 32 != 0",
         np.sort(rng.choice(5000, 333, replace=False)).astype(np.int32),
         np.sort(rng.integers(-10, 5100, (2, 400)).astype(np.int32), axis=1)),
        ("S = 0", np.zeros(0, np.int32),
         np.array([[0, 5, INVALID_KEY]], np.int32)),
        ("S = 300000, coarse stride 64",
         np.sort(rng.choice(1 << 29, 300000, replace=False)).astype(np.int32),
         np.sort(rng.integers(-5, 1 << 29, (2, 3000)).astype(np.int32),
                 axis=1)),
    ]
    return cases


def k2_contract_cases():
    """(name, queries [B, Nq, 3], supports [B, Ns, 3], s_mask [B, Ns],
    q_mask [B, Nq] or None) as numpy: the cases of
    tests/test_pallas_distance.py and tests/test_torch_distance.py, and
    the partitioned paths' (scattered query masks, a cloud with no valid
    query or support, valid counts that are not multiples of the kernel's
    2048-query tile or 256-support stage)."""
    rng = np.random.default_rng(2)

    def grid(*shape):      # multiples of 1/8: exact products, many ties
        return (rng.integers(-32, 32, shape) / 8.0).astype(np.float32)

    def lidar(*shape):
        return rng.uniform(-80, 80, shape).astype(np.float32)

    def keep(shape, share):
        return rng.random(shape) < share

    some = np.zeros((1, 5000), bool)
    some[0, rng.choice(5000, 700, replace=False)] = True
    no_query = keep((3, 3000), 0.7)
    no_query[1] = False
    no_support = keep((3, 2600), 0.6)
    no_support[0] = False
    ragged_q = np.zeros((2, 4500), bool)
    ragged_q[0, rng.choice(4500, 2049, replace=False)] = True
    ragged_q[1, rng.choice(4500, 4097, replace=False)] = True
    ragged_s = np.zeros((2, 3000), bool)
    ragged_s[0, rng.choice(3000, 257, replace=False)] = True
    ragged_s[1, rng.choice(3000, 2561, replace=False)] = True
    return [
        ("grid values, ties", grid(1, 1000, 3), grid(1, 4500, 3),
         np.ones((1, 4500), bool), None),
        ("LiDAR-scale floats", lidar(1, 3000, 3), lidar(1, 5000, 3),
         np.ones((1, 5000), bool), None),
        ("masked supports", lidar(1, 2000, 3), lidar(1, 5000, 3), some, None),
        ("all supports masked", lidar(1, 700, 3), lidar(1, 3000, 3),
         np.zeros((1, 3000), bool), None),
        ("ragged 513 x 2049", grid(1, 513, 3), grid(1, 2049, 3),
         rng.random((1, 2049)) > 0.3, None),
        ("B=3, own masks", grid(3, 1500, 3), lidar(3, 2500, 3),
         rng.random((3, 2500)) > np.array([[0.0], [0.6], [1.0]]), None),
        ("one support, one query", lidar(2, 1, 3), lidar(2, 1, 3),
         np.array([[True], [False]]), None),
        ("scattered q_mask, grid ties", grid(3, 3000, 3), grid(3, 2600, 3),
         keep((3, 2600), 0.5), keep((3, 3000), 0.4)),
        ("a cloud with no valid query", lidar(3, 3000, 3), lidar(3, 2600, 3),
         keep((3, 2600), 0.5), no_query),
        ("a cloud with no valid support", grid(3, 3000, 3), grid(3, 2600, 3),
         no_support, keep((3, 3000), 0.8)),
        ("valid counts 2049/4097 x 257/2561", grid(2, 4500, 3),
         grid(2, 3000, 3), ragged_s, ragged_q),
    ]


def k2_check(q, s, m, qm, what):
    """K2 (through its partition) against its plain version on the card: d2
    bit for bit, idx exactly; a query that ``qm`` masks must get (inf, Ns).
    Returns the kernel's (d2, idx) and the largest absolute d2 difference
    (0 where both are inf)."""
    from apr_torch.ops.distance import nn_min, nn_min_plain

    d2, idx = nn_min(q, s, m, qm)
    want_d2, want_idx = nn_min_plain(q, s, m)
    if qm is not None:
        want_d2 = torch.where(qm, want_d2, float("inf"))
        want_idx = torch.where(qm, want_idx, s.shape[1])
    err = float((d2 - want_d2).abs().nan_to_num(0.0).max())
    same_d2 = torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))
    if not (same_d2 and torch.equal(idx, want_idx)):
        bad = int((idx != want_idx).sum())
        raise AssertionError(f"K2 disagrees with its plain version on "
                             f"{what}: {bad} indices differ, d2 max abs err "
                             f"{err:.3e}")
    return d2, idx, err


def k2_inputs(trainer, batch):
    """The four (name, queries, supports, s_mask, q_mask) that the "pallas"
    Chamfer
    of one train step on ``batch`` hands K2: per side, the reconstruction
    (generator offsets on the voxel anchors, as losses/generative.py forms
    it) against the APC targets, and back."""
    c = trainer.config
    out = []
    with torch.no_grad():
        feats = trainer._encode_pair(batch)
        sides = ((batch.pyramid0, batch.apc0, batch.apc0_mask),
                 (batch.pyramid1, batch.apc1, batch.apc1_mask))
        for side, f, (pyr, apc, apc_mask) in zip((0, 1), feats, sides):
            mask = pyr.levels[0].mask
            b, n = mask.shape
            offsets = trainer.generator(f, mask) * c.voxel_size
            r = offsets.shape[-1] // 3
            anchors = pyr.levels[0].coords.float() * c.voxel_size
            recon = (offsets.reshape(b, n, r, 3) + anchors[:, :, None]
                     ).reshape(b, n * r, 3).contiguous()
            recon_mask = mask.repeat_interleave(r, dim=1)
            apc, apc_mask = apc.contiguous(), apc_mask.contiguous()
            out += [(f"side {side} recon->APC", recon, apc, apc_mask,
                     recon_mask),
                    (f"side {side} APC->recon", apc, recon, recon_mask,
                     apc_mask)]
    return out


def library_nn(q, s, m, chunk=4096):
    """The yardstick: torch.cdist (direct differences, no matmul
    expansion) and a masked min, in row chunks that keep [B, chunk, Ns]
    within a few GB."""
    for i in range(0, q.shape[1], chunk):
        d = torch.cdist(q[:, i:i + chunk], s,
                        compute_mode="donot_use_mm_for_euclid_dist")
        torch.where(m[:, None, :], d, float("inf")).min(dim=2)


def partition_by_sort(mask):
    """``apr_torch.ops.distance.partition`` as a stable argsort of the
    mask and the inverse scatter: the plainer form that phase 11 times
    beside it."""
    from apr_torch.ops.distance import Partition

    order = torch.argsort(~mask, dim=1, stable=True)
    ar = torch.arange(mask.shape[1], device=mask.device)
    pos = torch.empty_like(order).scatter_(1, order,
                                           ar.expand(mask.shape[0], -1))
    return Partition(order, pos, mask.sum(1, dtype=torch.int32))


def time_k2(inputs):
    """Per launch: exactness against the plain version, then the times of
    the whole nn_min call (partitions, compaction, kernel, index map), of
    the partitions and compaction alone, of the kernel alone, of the plain
    version and of the library, and the operations bound over the valid
    pairs, the only pairs the kernel computes.  The library call computes
    every pair of its shape whatever the masks, so it is timed once per
    shape (21.5 s a launch at both train steps' shapes)."""
    from apr_torch.ops import distance
    from apr_torch.ops.distance import compact, nn_min, nn_min_plain, \
        partition

    def prepare(q, s, m, qm):
        sp, qp = partition(m), partition(qm)
        return compact(q, qp), compact(s, sp), qp.count, sp.count

    rows = []
    library = {}    # torch.cdist's time depends on the shape alone
    for name, q, s, m, qm in inputs:
        err = k2_check(q, s, m, qm, name)[2]
        shape = (q.shape[0], q.shape[1], s.shape[1])
        if shape not in library:
            library[shape] = cuda_ms(lambda: library_nn(q, s, m), 1,
                                     warmup=False)
        pairs = int((qm.sum(1).double() * m.sum(1).double()).sum())
        nbytes = (q.numel() + s.numel()) * 4 + m.numel() + qm.numel() + \
            q.shape[0] * q.shape[1] * 8
        bound_ms = max(pairs * K2_OPS_PER_PAIR / FP32_OPS_PER_S,
                       nbytes / HBM_BYTES_PER_S) * 1e3
        prepared = prepare(q, s, m, qm)
        for x in (m, qm):
            if not all(torch.equal(a, b) for a, b in
                       zip(partition(x), partition_by_sort(x))):
                raise AssertionError("partition_by_sort differs from "
                                     "partition")
        rows.append(dict(
            name=name, B=q.shape[0], Nq=q.shape[1], Ns=s.shape[1],
            valid_pairs=pairs, max_abs_err=err,
            ms=cuda_ms(lambda: nn_min(q, s, m, qm), 5),
            partition_ms=cuda_ms(lambda: prepare(q, s, m, qm), 5),
            kernel_ms=cuda_ms(lambda: distance._launch(*prepared), 5),
            scan_ms=cuda_ms(lambda: (partition(m), partition(qm)), 5),
            sort_ms=cuda_ms(lambda: (partition_by_sort(m),
                                     partition_by_sort(qm)), 5),
            plain_ms=cuda_ms(lambda: nn_min_plain(q, s, m), 1),
            library_ms=library[shape], bound_ms=bound_ms))
        r = rows[-1]
        print(f"  {name:20s} B={r['B']} Nq={r['Nq']} Ns={r['Ns']} valid "
              f"pairs {pairs:.3e}  nn_min {r['ms']:8.3f} ms (partition "
              f"{r['partition_ms']:6.3f}, kernel {r['kernel_ms']:8.3f})  "
              f"plain {r['plain_ms']:8.3f} ms  cdist+min "
              f"{r['library_ms']:8.3f} ms  bound {bound_ms:7.3f} ms "
              f"({bound_ms / r['ms']:.2f} of it)  exact", flush=True)
        print(f"  {'':20s} its two partitions alone: partition "
              f"{r['scan_ms'] * 1e3:7.1f} us, stable argsort "
              f"{r['sort_ms'] * 1e3:7.1f} us", flush=True)
    return rows


def train_pairs(n):
    from apr_torch.data.synthetic import synthetic_pair

    return [synthetic_pair(seed=100 + s, n_points=TRAIN_POINTS,
                           apc_points=TRAIN_APC_POINTS, distance=10.0)
            for s in range(n)]


def raw_batch(pairs, cfg):
    """The nine padded arrays of one batch (points, masks, APC, t_gt)."""
    from apr_torch.data.synthetic import pad_points

    def stack(key, cap):
        ps, ms = zip(*[pad_points(p[key], cap) for p in pairs])
        return np.stack(ps), np.stack(ms)

    p0, m0 = stack("points0", cfg.point_capacity)
    p1, m1 = stack("points1", cfg.point_capacity)
    a0, am0 = stack("apc0", cfg.apc_capacity)
    a1, am1 = stack("apc1", cfg.apc_capacity)
    return (p0, m0, p1, m1, a0, am0, a1, am1,
            np.stack([p["t_gt"] for p in pairs]))


def replay_samples(seed):
    """Patch the hardest-contrastive sampler so that the i-th of the three
    draws of every loss takes the i-th of three numpy score vectors (made
    at first use): the same samples on the card and on the CPU.  Returns
    the function that undoes the patch."""
    from apr_torch.losses import contrastive

    orig = contrastive._sample_without_replacement
    rng = np.random.default_rng(seed)
    scores, calls = [], [0]

    def sample(generator, mask, num):
        i = calls[0] % 3
        calls[0] += 1
        if i == len(scores):
            scores.append(rng.random(mask.shape[0]).astype(np.float32))
        return contrastive.top_valid(
            torch.from_numpy(scores[i]).to(mask.device), mask, num)

    contrastive._sample_without_replacement = sample
    return lambda: setattr(contrastive, "_sample_without_replacement", orig)


def step_grads(trainer, loss):
    """Loss terms, gradients of the trainable parameters (by module class
    and name) and running stats after one float32 forward and backward,
    ``loss()`` giving (loss, metrics), with the replayed samples.

    FCGF features of voxels with the same neighbourhood are equal, so two
    sampled candidates can tie exactly as an anchor's hardest negative,
    and the card and the CPU may break such a tie differently.  The
    samples' seed is one whose hardest negatives (of compare_train_step's
    batch and weights) all lead the runner-up by more than 1e-4
    relative."""
    undo = replay_samples(seed=9)
    try:
        trainer.optimizer.zero_grad(set_to_none=False)
        value, metrics = loss()
        value.backward()
    finally:
        undo()
    return dict(
        metrics={n: float(v) for n, v in metrics.items()},
        # a planted fault can leave a leaf with no gradient at all
        grads={f"{type(m).__name__}.{k}": (
            torch.zeros_like(p) if p.grad is None else p.grad).to(
                "cpu", copy=True)
            for m in trainer.modules() for k, p in m.named_parameters()
            if p.requires_grad},
        stats={f"{i}.{n}": b.to("cpu", copy=True)
               for i, m in enumerate(trainer.modules())
               for n, b in m.named_buffers()})


def planted_fault():
    """Patch the encoder's convs to drop the same-level backward's offset
    flip (reverse_k): a wrong transpose map, which the card-vs-CPU gradient
    check must catch.  Returns the function that undoes the patch."""
    from apr_torch.models import resunet

    orig = resunet.sparse_conv_adjoint

    def faulty(feats, table, table_t, weights, out_mask, in_mask, reverse_k,
               compute_dtype):
        return orig(feats, table, table_t, weights, out_mask, in_mask, False,
                    compute_dtype)

    resunet.sparse_conv_adjoint = faulty
    return lambda: setattr(resunet, "sparse_conv_adjoint", orig)


def train_step_readings(dev):
    """One float32 train step at a small size from the same weights, batch
    (built on the CPU) and contrastive samples: ``(cpu, card, card_again,
    nudged, faulted)``, each as step_grads returns it.  ``nudged`` is the
    CPU after a 1e-6 relative nudge of the weights; ``faulted`` the card
    with planted_fault."""
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import synthetic_pair
    from apr_torch.training.trainer import FCGFTrainer

    cfg = APRConfig(model_n_out=32, compute_dtype="float32", batch_size=2,
                    point_capacity=8192, capacities=(2048, 1024, 512, 256),
                    apc_capacity=4096, num_pos_per_batch=256,
                    num_hn_samples_per_batch=64, chamfer_mode="pallas")
    pairs = [synthetic_pair(seed=200 + s, n_points=6000, apc_points=4000,
                            distance=5.0, extent=20.0) for s in range(2)]
    cpu = FCGFTrainer(cfg, device="cpu", seed=1)
    batch = cpu.build_batch(raw_batch(pairs, cfg))

    def card_step(fault):
        card = FCGFTrainer(cfg, device=dev, seed=2)
        for a, b in zip(card.modules(), cpu.modules()):
            a.load_state_dict(b.state_dict())
        undo = planted_fault() if fault else (lambda: None)
        on_card = tree_map(lambda x: x.to(dev), batch)
        try:
            return step_grads(card, lambda: card.loss_fn(
                on_card, None, train=True))
        finally:
            undo()

    return nudged_readings(cpu, lambda: cpu.loss_fn(batch, None, train=True),
                           card_step)


def nudged_readings(cpu, loss, card_step):
    """(cpu, card, card again, nudged CPU, card with the planted fault),
    each as step_grads gives it: ``card_step(fault)`` runs the card's
    step, ``loss`` the CPU's; the nudged CPU's weights move by a 1e-6
    relative normal draw after the CPU's own step."""
    runs = [card_step(False), card_step(False), card_step(True)]
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in cpu.modules()]
    c = step_grads(cpu, loss)
    for m, state in zip(cpu.modules(), before):
        m.load_state_dict(state)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.mul_(1.0 + 1e-6 * torch.randn(p.shape, generator=gen))
    return c, runs[0], runs[1], step_grads(cpu, loss), runs[2]


def leaf_errors(c, *others):
    """Per tensor of ``c``'s grads and stats: (kind, name, share, errors),
    share being the tensor's largest entry over the largest of its kind and
    each error max |other - c| over that tensor's largest entry, plus, for
    gradients, GRAD_FLOOR of the largest gradient (the biases of convs
    followed by batch norm have an analytically zero gradient)."""
    out = []
    for kind, floor in (("grads", GRAD_FLOOR), ("stats", 0.0)):
        top = max(float(v.abs().max()) for v in c[kind].values())
        for n, want in c[kind].items():
            scale = max(float(want.abs().max()) + floor * top, 1e-30)
            out.append((kind, n, float(want.abs().max()) / top,
                        [float((o[kind][n] - want).abs().max()) / scale
                         for o in others]))
    return out


def compare_train_step(dev):
    """One float32 train step's loss terms, gradients and updated running
    stats on the card against the CPU (train_step_readings).

    Each tensor is held to max |card - CPU| <= tol * max |CPU| over that
    tensor alone (leaf_errors): loss terms and running stats (the forward)
    with tol 1e-4, each gradient leaf with GRAD_TOL.  The backward is
    ill-conditioned at float32 rounding: ReLUs at their kink, and Chamfer
    neighbours and hardest negatives that nearly tie, switch under a change
    of the last bit, and on a coarse level one switch moves a visible share
    of a leaf.  The phase prints, beside the card's difference, the CPU's
    own change under a 1e-6 relative nudge of the weights, a second card
    run's difference and the difference that a planted backward fault
    makes, and fails unless the gradient check catches that fault."""
    check_step(train_step_readings(dev), GRAD_TOL, "no reverse_k flip")


def check_step(readings, grad_tol, fault):
    """Hold a card train step's readings to the CPU's (see
    compare_train_step), printing the largest differences beside the
    nudged CPU's, a second card run's and the planted ``fault``'s."""
    c, card, again, nudged, faulted = readings
    print("  " + "  ".join(f"{n} cpu {c['metrics'][n]:.7g} card "
                           f"{card['metrics'][n]:.7g}"
                           for n in c["metrics"]))
    bad = [f"loss term {n}" for n, v in c["metrics"].items()
           if not abs(card["metrics"][n] - v) <= 1e-4 * abs(v) + 1e-6]
    errs = leaf_errors(c, card, nudged, again, faulted)
    for kind, tol in (("grads", grad_tol), ("stats", 1e-4)):
        rows = sorted(((e, n, share) for k, n, share, e in errs
                       if k == kind), reverse=True)
        bad += [f"{kind} {n}" for e, n, _ in rows if not e[0] <= tol]
        print(f"  {kind} (tolerance {tol:g} of each tensor's largest entry): "
              f"the largest card-CPU differences; beside them the CPU's own "
              f"change under a 1e-6 nudge of the weights, a second card "
              f"run's difference and the planted fault's:")
        for e, n, share in rows[:6]:
            print(f"    {n:48s} card {e[0]:.2e}  nudged CPU {e[1]:.2e}  card "
                  f"again {e[2]:.2e}  fault {e[3]:.2e}  (leaf {share:.1e} of "
                  f"the largest)")
        print(f"    largest over all {len(rows)}: " + "  ".join(
            f"{what} {max(e[i] for e, _, _ in rows):.2e}" for i, what in
            enumerate(("card", "nudged CPU", "card again", "fault"))))
    caught = sorted((e[3], n) for k, n, _, e in errs
                    if k == "grads" and e[3] > grad_tol)
    print(f"  planted fault ({fault}): {len(caught)} of "
          f"{len(c['grads'])} gradient leaves beyond tolerance; largest "
          + ", ".join(f"{n} {e:.2e}" for e, n in caught[::-1][:3]))
    if bad:
        raise AssertionError(f"card and CPU differ beyond tolerance: {bad}")
    if not caught:
        raise AssertionError("the gradient check does not catch the planted "
                             "fault")
    print(f"  {len(c['grads'])} gradients, {len(c['stats'])} running stats "
          f"and the loss terms agree")


def recorded_searches(fn):
    """``fn()`` with every search a Predator batch build makes recorded at
    its call site: the KP tables' ``windowed_radius_neighbors`` /
    ``radius_neighbors`` / ``knn`` (exact fallbacks included) and the GT
    correspondences' ``radius_neighbors``.  Returns (fn's result, [(name,
    call)]); ``call(device)`` repeats one search on its own inputs (the
    device is theirs)."""
    import apr_torch.models.kpconv as kpconv
    from apr_torch.ops import neighbors

    sites = [(kpconv, n, "KP") for n in ("windowed_radius_neighbors",
                                         "radius_neighbors", "knn")]
    sites.append((neighbors, "radius_neighbors", "GT"))
    saved = [getattr(m, n) for m, n, _ in sites]
    calls = []

    def recorder(search, what):
        def rec(*a, **kw):
            k = a[3] if len(a) > 3 else a[2]
            calls.append((f"{what} {search.__name__} {list(a[0].shape)} -> "
                          f"{list(a[1].shape[:2])} k {k}",
                          lambda d: search(*a, **kw)))
            return search(*a, **kw)
        return rec

    for (m, n, what), f in zip(sites, saved):
        setattr(m, n, recorder(f, what))
    try:
        out = fn()
    finally:
        for (m, n, _), f in zip(sites, saved):
            setattr(m, n, f)
    return out, calls


def k3_pairs(queries, supports, q_mask, s_mask, lo, hi, idx, d2, bound,
             yx, tile, window):
    """The candidate pairs that one K3 launch scores, from
    ``neighbors._launch``'s arguments: valid queries x valid supports in
    brute mode; in windowed mode, per tile its valid queries x the window's
    positions below hi."""
    b, nq, _ = queries.shape

    def valid(m, n):
        return (torch.full((b,), float(n), dtype=torch.float64)
                if m is None else m.sum(1, dtype=torch.float64).cpu())

    if lo is None:
        return float((valid(q_mask, nq)
                      * valid(s_mask, supports.shape[1])).sum())
    qv = (torch.ones((b, nq), dtype=torch.bool, device=queries.device)
          if q_mask is None else q_mask)
    qv = torch.nn.functional.pad(qv, (0, lo.shape[1] * tile - nq))
    per_tile = qv.reshape(b, -1, tile).sum(-1, dtype=torch.float64)
    return float((per_tile * (hi - lo).clamp(0, window).double()).sum())


def same_outputs(a, b):
    """Whether two search results (a tensor or a tuple of them) are equal
    entry for entry (+inf equals +inf)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool((a.cpu() == b.cpu()).all())
    return all(same_outputs(x, y) for x, y in zip(a, b))


def differing_fields(a, b, at="batch"):
    """The fields of two batches (NamedTuples, tuples, tensors) that differ
    in any entry."""
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [at]
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return [x for f in a._fields for x in differing_fields(
            getattr(a, f), getattr(b, f), f"{at}.{f}")]
    if isinstance(a, (tuple, list)):
        return [x for i, (u, v) in enumerate(zip(a, b))
                for x in differing_fields(u, v, f"{at}[{i}]")]
    return [] if a == b else [at]


def k3_against_plain(searches, dev, with_cpu):
    """Each search by kernel K3 on the card against the plain torch chain
    on the card (``probe_radius_select.selector("topk")`` keeps every
    search on it) and, with ``with_cpu``, on the CPU, entry for entry, with
    both chains' device times and K3's operation bound: 8 float32
    instructions for each candidate pair that its launch scores, at
    FP32_OPS_PER_S.  Returns the sums (K3 ms, plain ms, bound ms)."""
    from apr_torch.ops import neighbors
    from apr_torch.tools.probe_radius_select import selector

    launch = neighbors._launch
    sums = np.zeros(3)
    for name, fn in searches:
        pairs = []

        def counted_launch(*a):
            pairs.append(k3_pairs(*a))
            return launch(*a)

        neighbors._launch = counted_launch
        try:
            got = fn(dev)
            torch.cuda.synchronize()
        finally:
            neighbors._launch = launch
        if len(pairs) != 1:
            raise AssertionError(f"{name}: {len(pairs)} K3 launches, want 1")
        with selector("topk"):
            plain = fn(dev)
            plain_ms = cuda_ms(lambda: fn(dev), 3)
        ok = same_outputs(got, plain)
        if with_cpu:
            ok = ok and same_outputs(got, fn("cpu"))
        if not ok:
            raise AssertionError(f"{name}: K3's table differs from the plain "
                                 f"chain's from the same barycenters")
        k3_ms = cuda_ms(lambda: fn(dev), 3)
        bound_ms = pairs[0] * K3_OPS_PER_PAIR / FP32_OPS_PER_S * 1e3
        sums += (k3_ms, plain_ms, bound_ms)
        print(f"  {name:48s} exact (plain chain on the card"
              f"{', CPU' if with_cpu else ''}); K3 {k3_ms:8.3f} ms, plain "
              f"chain {plain_ms:9.3f} ms; {pairs[0]:.4g} candidate pairs, "
              f"bound {bound_ms:.4f} ms")
    return sums


def kp_neighbour_phase(dev, pair):
    """Phase 13: one pair's KP pyramid built twice on the card and once on
    the CPU from the raw points, every field held bit for bit (two card
    builds, card vs CPU), then the searches of the build that the phase
    lists and the GT correspondences with cap 2 from the SAME barycenters
    (the card's): kernel K3 against the plain torch chain on the card and
    on the CPU, held exact, with both chains' device times.  Then one
    batch build of predator-apr.train's shapes (PT_FIELDS, PT_PAIR): its K3
    launches, its card searches left on the plain chain (none), its
    windowed searches and exact fallbacks; that build by K3 and by the
    plain chain, every field held equal, with both walls; and each search
    that build made, recorded at its call site, K3 against the plain chain
    on the card, exact and timed.  Returns the latter's sums (K3 ms, plain
    ms, bound ms)."""
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import pad_points, synthetic_pair
    from apr_torch.models.kpconv import KPLevel, build_kp_pyramid
    from apr_torch.ops.neighbors import knn, radius_neighbors, \
        windowed_radius_neighbors
    from apr_torch.registration.matching import gt_correspondences
    from apr_torch.tools.probe_radius_select import selector
    from apr_torch.training.predator import make_kp_pair_batch

    c = APRConfig(**KP_FIELDS)
    pts, msk = zip(*(pad_points(pair[k], c.point_capacity)
                     for k in ("points0", "points1")))
    pts, msk = torch.from_numpy(np.stack(pts)), torch.from_numpy(np.stack(msk))
    kw = dict(first_subsampling_dl=c.first_subsampling_dl,
              conv_radius=c.conv_radius, num_levels=len(c.kp_capacities),
              capacities=c.kp_capacities,
              neighbor_limits=c.neighborhood_limits)
    win0, fb0 = build_kp_pyramid.windowed, build_kp_pyramid.fallbacks
    pyr_gpu = build_kp_pyramid(pts.to(dev), msk.to(dev), **kw)
    torch.cuda.synchronize()
    pyr_again = build_kp_pyramid(pts.to(dev), msk.to(dev), **kw)
    win, fb = (build_kp_pyramid.windowed - win0,
               build_kp_pyramid.fallbacks - fb0)
    t0 = time.perf_counter()
    pyr_cpu = build_kp_pyramid(pts, msk, **kw)
    cpu_s = time.perf_counter() - t0
    print(f"  card build: {win} windowed (search, cloud) pairs, {fb} fell "
          f"back to the exact search; CPU build {cpu_s:.1f} s")
    for lvl, (g, a, h) in enumerate(zip(pyr_gpu.levels, pyr_again.levels,
                                        pyr_cpu.levels)):
        for name in KPLevel._fields:
            if not torch.equal(getattr(g, name), getattr(a, name)):
                raise AssertionError(f"L{lvl} {name}: two card builds from "
                                     f"the same points differ")
        bary = float((g.points.cpu() - h.points).abs().max())
        rows = {name: int((getattr(g, name).cpu() != getattr(h, name))
                          .reshape(2, getattr(h, name).shape[1], -1)
                          .any(-1).sum())
                for name in KPLevel._fields}
        print(f"  end to end, L{lvl}: valid {g.mask.sum(1).tolist()} of "
              f"{g.mask.shape[1]}; barycenters max |card - CPU| {bary:.3e}; "
              f"rows that differ {rows}")
        if any(rows.values()):
            raise AssertionError(f"L{lvl}: the card's pyramid differs from "
                                 f"the CPU's: {rows}")
    print("  two card builds bit-identical; card equals CPU in every field")

    # the searches the phase lists, and the GT correspondences with cap 2,
    # from the card's barycenters on both sides
    lv = [(lvl.points, lvl.mask) for lvl in pyr_gpu.levels]
    r0 = c.first_subsampling_dl * c.conv_radius
    cap = c.neighborhood_limits[0]
    t_gt = torch.as_tensor(pair["t_gt"], dtype=torch.float32)[None]

    def windowed(q, s):
        return lambda d: windowed_radius_neighbors(
            lv[q][0].to(d), lv[s][0].to(d), r0, cap, lv[q][1].to(d),
            lv[s][1].to(d))

    def brute(q, s, r):
        return lambda d: radius_neighbors(
            lv[q][0].to(d), lv[s][0].to(d), r, cap, lv[q][1].to(d),
            lv[s][1].to(d))

    searches = [
        ("windowed L0 conv", windowed(0, 0)),
        ("windowed L0 pool", windowed(1, 0)),
        ("radius L1 conv", brute(1, 1, 2 * r0)),
        ("radius L1 pool", brute(2, 1, 2 * r0)),
        ("radius L3 conv", brute(3, 3, 8 * r0)),
        ("knn 1-NN L0 -> L1", lambda d: knn(
            lv[0][0].to(d), lv[1][0].to(d), 1, lv[0][1].to(d),
            lv[1][1].to(d))[0]),
        ("GT correspondences cap 2", lambda d: gt_correspondences(
            lv[0][0][:1].to(d), lv[0][0][1:].to(d), t_gt.to(d),
            c.overlap_radius, cap_per_point=2, mask0=lv[0][1][:1].to(d),
            mask1=lv[0][1][1:].to(d)).tgt_idx),
    ]
    k3_against_plain(searches, dev, with_cpu=True)
    build_ms = cuda_ms(lambda: build_kp_pyramid(pts.to(dev), msk.to(dev),
                                                **kw), 3)
    print(f"  whole pyramid build (two clouds, one host sync for the "
          f"overflow flags): {build_ms:.3f} ms a build")

    pt = APRConfig(**PT_FIELDS)
    raw = [x[0] for x in raw_batch([synthetic_pair(seed=300, **PT_PAIR)],
                                   pt)]
    build_kw = dict(first_subsampling_dl=pt.first_subsampling_dl,
                    conv_radius=pt.conv_radius,
                    capacities=tuple(pt.kp_capacities),
                    neighbor_limits=tuple(pt.neighborhood_limits),
                    overlap_radius=pt.overlap_radius, device=dev)
    k3_reset()
    win0, fb0 = build_kp_pyramid.windowed, build_kp_pyramid.fallbacks
    batch, calls = recorded_searches(
        lambda: make_kp_pair_batch(*raw, **build_kw))
    torch.cuda.synchronize()
    (n, plain_cuda), win, fb = (k3_counts(),
                                build_kp_pyramid.windowed - win0,
                                build_kp_pyramid.fallbacks - fb0)
    print(f"  one build at predator-apr.train's shapes (caps "
          f"{pt.kp_capacities}, {PT_PAIR['n_points']} points): "
          f"radius_select.launches {n}, radius_select.plain_cuda "
          f"{plain_cuda}, build_kp_pyramid.windowed {win}, "
          f"build_kp_pyramid.fallbacks {fb}; {len(calls)} searches")
    if n != len(calls) or plain_cuda != 0:
        raise AssertionError("the Predator train build must select in K3 "
                             "only, one launch a search")
    with selector("topk"):
        plain = make_kp_pair_batch(*raw, **build_kw)
        walls = [synced_ms(lambda: make_kp_pair_batch(*raw, **build_kw))]
    walls.insert(0, synced_ms(lambda: make_kp_pair_batch(*raw, **build_kw)))
    bad = differing_fields(batch, plain)
    print(f"  that build by K3 and by the plain chain: "
          f"{'equal in every field' if not bad else bad}; wall (median of "
          f"3, synced) K3 {walls[0]:.1f} ms, plain chain {walls[1]:.1f} ms")
    if bad:
        raise AssertionError(f"K3's build differs from the plain chain's in "
                             f"{bad}")
    print("  each search of that build, as it was called:")
    sums = k3_against_plain(calls, dev, with_cpu=False)
    print(f"  the build's searches in all: K3 {sums[0]:.3f} ms, plain chain "
          f"{sums[1]:.3f} ms, bound {sums[2]:.4f} ms")
    return dict(ms=float(sums[0]), plain_ms=float(sums[1]),
                bound_ms=float(sums[2]))


def kp_forward_phase(dev, pair):
    """Phase 14: the KPFCNN forward at full width from one pair's batch and
    the same weights, float32 on the card against the CPU (gated), and bf16
    against float32 on the card (printed)."""
    from dataclasses import replace

    from apr_torch.config import APRConfig
    from apr_torch.eval.predator_tester import PredatorTester
    from apr_torch.training.predator import PredatorTrainer

    c32 = replace(APRConfig(**KP_FIELDS), compute_dtype="float32")
    gpu = PredatorTester(c32, PredatorTrainer(c32, device=dev, seed=0),
                         device=dev)
    cpu = PredatorTester(c32, PredatorTrainer(c32, device="cpu", seed=0),
                         device="cpu")
    cpu.trainer.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.trainer.model.state_dict().items()})
    batch = gpu._pair_to_batch(pair)
    out_gpu = gpu.forward(batch)
    t0 = time.perf_counter()
    out_cpu = cpu.forward(tree_map(lambda x: x.cpu(), batch))
    cpu_s = time.perf_counter() - t0
    errs = {n: float((getattr(out_gpu, n).cpu() - getattr(out_cpu, n))
                     .abs().max()) for n in out_gpu._fields}
    c16 = APRConfig(**KP_FIELDS)
    bf16 = PredatorTester(c16, PredatorTrainer(c16, device=dev, seed=0),
                          device=dev)
    bf16.trainer.model.load_state_dict(gpu.trainer.model.state_dict())
    out_bf16 = bf16.forward(batch)
    dev16 = {n: float((getattr(out_bf16, n) - getattr(out_gpu, n))
                      .abs().max()) for n in out_gpu._fields}
    print(f"  float32 card vs CPU, max abs err (tolerance {KP_F32_TOL:g}; "
          f"CPU forward {cpu_s:.1f} s): "
          + "  ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    print("  bf16 vs float32 on the card, max abs deviation: "
          + "  ".join(f"{n} {e:.3e}" for n, e in dev16.items()))
    print(f"  overlap0 on the card: mean {float(out_gpu.overlap0.mean()):.4f}"
          f" std {float(out_gpu.overlap0.std()):.4f} over "
          f"{int(batch.pyr0.levels[0].mask.sum())} valid points")
    if not max(errs.values()) <= KP_F32_TOL:
        raise AssertionError("float32 KPFCNN differs between card and CPU")
    if not all(bool(torch.isfinite(v).all()) for v in out_bf16):
        raise AssertionError("bf16 KPFCNN output is not finite")


def predator_slice_phase(dev, pairs):
    """Phase 15: PredatorTester.test on the pairs at full width (pipelined
    pairs/s, peak memory, recall / RTE / RRE), then one pair by stage."""
    from apr_torch.config import APRConfig
    from apr_torch.eval.predator_tester import PredatorTester
    from apr_torch.models.kpconv import build_kp_pyramid
    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.searchsorted import searchsorted_left
    from apr_torch.training.predator import PredatorTrainer

    c = APRConfig(**KP_FIELDS)
    print(f"  KPFCNN first {c.first_feats_dim} gnn {c.gnn_feats_dim} final "
          f"{c.final_feats_dim} K={c.num_kernel_points} nets {c.nets} "
          f"k={c.dgcnn_k} heads {c.num_head} {c.compute_dtype} caps "
          f"{c.kp_capacities} limits {c.neighborhood_limits} points "
          f"{c.point_capacity} subsample {c.test_subsample} hypotheses "
          f"{c.test_num_ransac_hypotheses}")
    trainer = PredatorTrainer(c, device=dev, seed=0)
    tester = PredatorTester(c, trainer, device=dev)
    searchsorted_left.launches = 0
    nn_min.launches = 0
    k3_reset()
    fb0 = build_kp_pyramid.fallbacks
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = tester.test(pairs, seed=0)
    main_s = time.perf_counter() - t0
    k3_take("predator_eval")
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ = stats.summary()
    print(f"  pairs/s {summ['pairs_per_sec']:.3f} (pairs 2-{len(pairs)}, "
          f"pipelined; {main_s:.2f} s for all {len(pairs)} with the first "
          f"pair's warm-up)  peak device memory {peak:.2f} GiB")
    print(f"  recall {summ['recall']:.3f} (random weights: not asserted)")
    print(f"  RTE {['%.2f' % x for x in stats.rte]}")
    print(f"  RRE {['%.2f' % x for x in stats.rre]}")
    print(f"  exact fallbacks of the windowed search: "
          f"{build_kp_pyramid.fallbacks - fb0}; K1 / K2 launches: "
          f"{searchsorted_left.launches} / {nn_min.launches} (the Predator "
          f"path runs no hand-written kernel)")
    if searchsorted_left.launches or nn_min.launches:
        raise AssertionError("the Predator path launched K1 or K2")
    if not (np.isfinite(stats.rte).all() and np.isfinite(stats.rre).all()
            and np.isfinite(stats.fitness).all()):
        raise AssertionError("non-finite RTE/RRE/fitness")

    gen = torch.Generator(device=dev).manual_seed(1)
    x, _ = stage_split(dict(
        build=lambda _: tester._pair_to_batch(pairs[0]),
        forward=lambda b: (b, tester.forward(b)),
        eval=lambda bo: tester.eval_one(bo[1], bo[0], gen)),
        inference=True, unit="pair")
    if not all(bool(torch.isfinite(v).all()) for v in x):
        raise AssertionError("non-finite raw outputs of one pair")
    return summ["pairs_per_sec"]


def predator_k2_inputs(trainer, batch):
    """The four (name, queries, supports, s_mask, q_mask) that the "pallas"
    Chamfer of one Predator train step on ``batch`` hands K2: per cloud,
    the reconstruction (the train-mode generator's offsets on the metric
    level-0 points, as losses/generative.py forms it with voxel size 1)
    against the APC targets, and back.  The running stats are restored."""
    saved = [b.clone() for b in trainer.buffers()]
    out = []
    with torch.no_grad():
        feats = trainer.model(batch.pyr0, batch.pyr1)
        offsets = trainer._offsets(feats, batch, train=True)
        for b, old in zip(trainer.buffers(), saved):
            b.copy_(old)
        sides = ((batch.pyr0, batch.apc0, batch.apc0_mask),
                 (batch.pyr1, batch.apc1, batch.apc1_mask))
        for side, offs, (pyr, apc, apc_mask) in zip((0, 1), offsets, sides):
            lv = pyr.levels[0]
            n, r = lv.mask.shape[0], offs.shape[-1] // 3
            recon = (offs.reshape(n, r, 3) + lv.points[:, None]).reshape(
                1, n * r, 3).contiguous()
            recon_mask = lv.mask.repeat_interleave(r)[None]
            apc, apc_mask = apc[None].contiguous(), apc_mask[None]
            out += [(f"cloud {side} recon->APC", recon, apc, apc_mask,
                     recon_mask),
                    (f"cloud {side} APC->recon", apc, recon, recon_mask,
                     apc_mask)]
    return out


def predator_train_phase(dev):
    """Phase 16: PredatorTrainer.train_step at configs/train/kitti.yaml's
    full width on synthetic pairs (TRAIN_STEPS single-pair steps, w_saliency
    0 then 1), with the K1 / K2 launch counts read around them (0 and 4 per
    step), steps/s, peak memory and a stage split; one step in
    chamfer_mode="window", one valid_step and one train_step_batched_fused
    at B = 2 (8 K2 launches: its pairs run one after another); then K2 at
    this step's shapes, exact against its plain version, timed against
    its bound.  Returns (K2 launches of the single-pair steps, K2's rows,
    the stage split's readings)."""
    from dataclasses import replace

    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import synthetic_pair
    from apr_torch.models.kpconv import build_kp_pyramid
    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.searchsorted import searchsorted_left
    from apr_torch.training.predator import PredatorTrainer

    c = APRConfig(**PT_FIELDS)
    print(f"  KPFCNN first {c.first_feats_dim} gnn {c.gnn_feats_dim} final "
          f"{c.final_feats_dim} K={c.num_kernel_points} nets {c.nets} "
          f"k={c.dgcnn_k} heads {c.num_head} {c.compute_dtype}; "
          f"{c.generator_model} ratio {c.point_generation_ratio} loss_ratio "
          f"{c.loss_ratio}; {c.optimizer} lr {c.lr} momentum "
          f"{c.sgd_momentum} wd {c.weight_decay}; max_points "
          f"{c.max_points}; caps {c.kp_capacities} limits "
          f"{c.neighborhood_limits} points {c.point_capacity} APC "
          f"{c.apc_capacity}; chamfer {c.chamfer_mode}")
    t0 = time.perf_counter()
    pairs = [synthetic_pair(seed=300 + s, **PT_PAIR) for s in range(4)]
    raws = [raw_batch([p], c) for p in pairs]
    singles = [tuple(x[0] for x in r) for r in raws]
    group = [raw_batch(pairs[:2], c), raw_batch(pairs[2:], c)]
    print(f"  {len(pairs)} synthetic pairs ({PT_PAIR['n_points']} points, "
          f"{PT_PAIR['apc_points']} APC points) made on the host in "
          f"{time.perf_counter() - t0:.1f} s (set-up, not timed below)")
    trainer = PredatorTrainer(c, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = trainer.build_batch(singles[0])
    lv0 = (batch.pyr0.levels[0], batch.pyr1.levels[0])
    print(f"  level-0 fill: {[int(lv.mask.sum()) for lv in lv0]} of "
          f"{c.kp_capacities[0]}; APC after dedup "
          f"{[int(batch.apc0_mask.sum()), int(batch.apc1_mask.sum())]} of "
          f"{c.apc_capacity}; GT correspondences "
          f"{int(batch.corr_mask.sum())}")

    torch.cuda.reset_peak_memory_stats()
    fb0 = build_kp_pyramid.fallbacks
    searchsorted_left.launches = 0
    nn_min.launches = 0
    k3_reset()
    step_s, step_metrics = [], []
    for k in range(TRAIN_STEPS):
        w_sal = 0.0 if k < (TRAIN_STEPS + 1) // 2 else 1.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(trainer.build_batch(singles[k % 2]),
                                     gen, w_sal)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_metrics.append({n: float(v) for n, v in metrics.items()})
    k1_pt, k2_pt = searchsorted_left.launches, nn_min.launches
    k3_take("predator_train")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, (sec, m) in enumerate(zip(step_s, step_metrics)):
        print(f"  step {k}: {sec * 1e3:9.1f} ms  " +
              "  ".join(f"{n} {v:.6g}" for n, v in m.items()))
    steps_per_s = (TRAIN_STEPS - 1) / sum(step_s[1:])
    print(f"  steps/s {steps_per_s:.3f} (build + step, synchronised, steps "
          f"2-{TRAIN_STEPS})  peak device memory {peak:.2f} GiB  exact "
          f"fallbacks of the windowed search "
          f"{build_kp_pyramid.fallbacks - fb0}")
    print(f"  K1 launches {k1_pt}, K2 launches {k2_pt} "
          f"({k2_pt / TRAIN_STEPS:.0f} per step)")
    if not all(np.isfinite(v) for m in step_metrics for v in m.values()):
        raise AssertionError("a Predator train step gave a non-finite loss "
                             "term")
    if any(m["skipped_nonfinite"] != 0.0 for m in step_metrics):
        raise AssertionError("a Predator train step was skipped")
    if k2_pt != 4 * TRAIN_STEPS:
        raise AssertionError(f"K2 launched {k2_pt} times in {TRAIN_STEPS} "
                             f"Predator steps; the pallas Chamfer takes 4 "
                             f"per step (2 clouds x 2 directions)")
    if k1_pt != 0:
        raise AssertionError("the Predator train path launched K1")

    def forward(b):
        trainer.optimizer.zero_grad(set_to_none=False)
        return trainer.loss_fn(b, gen, 1.0, True)

    _, split = stage_split(dict(
        build=lambda _: trainer.build_batch(singles[0]), forward=forward,
        backward=lambda out: out[0].backward(),
        optimizer=lambda _: trainer.optimizer.step()))

    trainer.config = replace(c, chamfer_mode="window")
    nn_min.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = {n: float(v) for n, v in trainer.train_step(
        trainer.build_batch(singles[1]), gen, 1.0).items()}
    torch.cuda.synchronize()
    print(f"  window-mode step: {(time.perf_counter() - t0) * 1e3:.1f} ms  "
          + "  ".join(f"{n} {v:.6g}" for n, v in metrics.items()))
    if not (all(np.isfinite(v) for v in metrics.values())
            and metrics["skipped_nonfinite"] == 0.0):
        raise AssertionError("the window-mode Predator step failed")
    if nn_min.launches != 0:
        raise AssertionError("window mode launched K2")
    trainer.config = c
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    valid = {n: float(v) for n, v in trainer.valid_step(
        trainer.build_batch(singles[0]), gen, 1.0).items()}
    torch.cuda.synchronize()
    print(f"  valid_step: {(time.perf_counter() - t0) * 1e3:.1f} ms  "
          + "  ".join(f"{n} {v:.6g}" for n, v in valid.items()))
    if not all(np.isfinite(v) for v in valid.values()):
        raise AssertionError("the Predator valid_step gave a non-finite "
                             "metric")

    grouped = trainer.build_batch_group(group[0])
    nn_min.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, _ = trainer.train_step_batched_fused(grouped, gen, 1.0,
                                                  group[1])
    torch.cuda.synchronize()
    metrics = {n: float(v) for n, v in metrics.items()}
    print(f"  train_step_batched_fused, B=2: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (step and the next "
          f"group's build), K2 launches {nn_min.launches}  " + "  ".join(
              f"{n} {v:.6g}" for n, v in metrics.items()))
    if not (all(np.isfinite(v) for v in metrics.values())
            and metrics["skipped_nonfinite"] == 0.0):
        raise AssertionError("the grouped Predator step failed")
    if nn_min.launches != 8:
        raise AssertionError(f"the B=2 step launched K2 {nn_min.launches} "
                             f"times; its pairs run one after another, 4 "
                             f"each")

    predator_twin_run(dev)
    print("  K2 at this step's shapes (the 4 launches of one step):")
    rows = time_k2(predator_k2_inputs(trainer, trainer.build_batch(
        singles[0])))
    return k2_pt, rows, split


def bit_hash(t):
    """A checksum of a tensor's bits (any flipped bit changes it)."""
    t = t.detach().contiguous()
    ints = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])
    return (int(ints.long().sum()), int((ints.long() * 31).remainder_(
        1000003).sum()))


def input_grad_hashes(modules):
    """Register hooks that record, in backward order, a bit checksum of
    the gradient of each module call's tensor inputs; returns (the record,
    the function that removes the hooks)."""
    record, handles = [], []
    for top in modules:
        for name, mod in top.named_modules():
            def fwd(m, args, out, name=f"{type(top).__name__}.{name}"):
                for i, a in enumerate(args):
                    if isinstance(a, torch.Tensor) and a.requires_grad:
                        a.register_hook(lambda g, tag=f"{name} input {i}":
                                        record.append((tag, bit_hash(g))))
            handles.append(mod.register_forward_hook(fwd))
    return record, lambda: [h.remove() for h in handles]


def predator_twin_run(dev):
    """A1's gate: the Predator train step at kitti.yaml's width (phase
    16's config, PT_PAIR seed 300) run twice from fresh trainers: every
    loss term, running stat, parameter and gradient leaf bit for bit.  On
    a difference, the first module call (in backward order) whose input
    gradient differs names the site.  Returns the number of gradient
    leaves."""
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import synthetic_pair
    from apr_torch.training.predator import PredatorTrainer

    c = APRConfig(**PT_FIELDS)
    single = tuple(x[0] for x in raw_batch(
        [synthetic_pair(seed=300, **PT_PAIR)], c))

    def once():
        tr = PredatorTrainer(c, device=dev, seed=0)
        batch = tr.build_batch(single)
        record, remove = input_grad_hashes(tr.modules())
        try:
            m = tr.train_step(batch, torch.Generator(dev).manual_seed(6),
                              1.0)
            torch.cuda.synchronize()
        finally:
            remove()
        return readings_of(tr, m), record

    (a, rec_a), (b, rec_b) = once(), once()
    diff = bitwise_same(a, b)
    n_grads = len(a["grads"])
    print(f"  the Predator step run twice (PT_PAIR seed 300): "
          f"{'bit for bit' if not diff else f'{len(diff)} readings differ'}"
          f" in {len(a['metrics'])} loss terms, {len(a['stats'])} running "
          f"stats, {len(a['params'])} parameters and {n_grads} gradient "
          f"leaves")
    if diff:
        first = next(((x, y) for x, y in zip(rec_a, rec_b) if x != y),
                     None)
        print(f"  differing: {diff[:12]}")
        print(f"  first module input gradient that differs, in backward "
              f"order: {first and first[0][0]} (of {len(rec_a)} recorded)")
        raise AssertionError("the Predator train step is not deterministic "
                             "on the card")
    return n_grads


def per_step(rows):
    """K2's rows summed over the launches of one step."""
    return {k: sum(r[k] for r in rows) for k in (
        "ms", "partition_ms", "kernel_ms", "plain_ms", "library_ms",
        "bound_ms", "scan_ms", "sort_ms")}


def planted_cross_attention_fault():
    """Patch the GCN's attention to detach its message: no gradient
    reaches the cross attention's queries, keys and values, which the
    card-vs-CPU gradient check must catch.  Returns the undo."""
    from apr_torch.models import gcn

    orig = gcn._attend
    gcn._attend = lambda *args: orig(*args).detach()
    return lambda: setattr(gcn, "_attend", orig)


def compare_predator_step(dev):
    """Phase 17: one float32 Predator train step at a small size, card
    against CPU, from the same weights, batch (built on the CPU) and
    correspondence draws: loss terms and running stats within 1e-4, each
    gradient leaf within PT_GRAD_TOL of its own largest entry (plus
    GRAD_FLOOR of the largest gradient), beside the CPU's own change under
    a 1e-6 nudge of the weights, a second card run and a planted backward
    fault (the GCN's attention message detached), which must fail."""
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import synthetic_pair
    from apr_torch.training.predator import PredatorTrainer

    cfg = APRConfig(**dict(
        PT_FIELDS, first_feats_dim=64, gnn_feats_dim=64,
        kp_capacities=(4096, 2048, 1024, 512), point_capacity=8192,
        apc_capacity=8192, max_points=256, compute_dtype="float32"))
    pair = synthetic_pair(seed=401, n_points=8000, apc_points=6000,
                          distance=5.0, extent=25.0)
    cpu = PredatorTrainer(cfg, device="cpu", seed=3)
    batch = cpu.build_batch(tuple(x[0] for x in raw_batch([pair], cfg)))

    def card_step(fault):
        card = PredatorTrainer(cfg, device=dev, seed=2)
        for a, b in zip(card.modules(), cpu.modules()):
            a.load_state_dict(b.state_dict())
        undo = planted_cross_attention_fault() if fault else (lambda: None)
        on_card = tree_map(lambda x: x.to(dev), batch)
        try:
            return step_grads(card, lambda: card.loss_fn(
                on_card, None, 1.0, True))
        finally:
            undo()

    lv0 = (batch.pyr0.levels[0], batch.pyr1.levels[0])
    print(f"  level-0 points {[int(lv.mask.sum()) for lv in lv0]}, GT "
          f"correspondences {int(batch.corr_mask.sum())}")
    check_step(nudged_readings(
        cpu, lambda: cpu.loss_fn(batch, None, 1.0, True), card_step),
        PT_GRAD_TOL, "attention message detached")


# the training loops (phases 18, 19): the synthetic dataset at the
# reference's point counts, shrunk in pair count only
LOOP_PAIRS = dict(train=12, val=4, test=4)
PT_LOOP_PAIRS = dict(train=4, val=2, test=2)
# phase 10's full width through the CLI (apr_tpu/config.py's defaults,
# spelled out), with the Chamfer that runs K2 and the fused build
LOOP_ARGV = [
    "--trainer", "GenerativePairTrainer", "--model", "ResUNetFatBN",
    "--model_n_out", "128", "--conv1_kernel_size", "5",
    "--compute_dtype", "bfloat16", "--batch_size", "4",
    "--capacities", "16384", "8192", "4096", "2048",
    "--point_capacity", "131072", "--apc_capacity", "65536",
    "--generator_model", "GenerativeMLP_98", "--point_generation_ratio", "4",
    "--optimizer", "SGD", "--lr", "0.1", "--sgd_momentum", "0.9",
    "--weight_decay", "1e-4", "--chamfer_mode", "pallas",
    "--fused_build", "true", "--dataset", "synthetic", "--max_epoch", "1"]


def shrunk_datasets(counts):
    """Make ``SyntheticPairDataset`` hold ``counts[phase]`` pairs (and
    nothing else changed) until the returned function is called."""
    import apr_torch.data.datasets as dsmod

    real = dsmod.SyntheticPairDataset

    class Shrunk(real):
        def __init__(self, **kw):
            kw["num_pairs"] = counts[kw["phase"]]
            super().__init__(**kw)

    dsmod.SyntheticPairDataset = Shrunk

    def restore():
        dsmod.SyntheticPairDataset = real
    return restore


def captured_trainers(module, name):
    """Wrap ``module.<name>`` (a trainer factory) so that every trainer it
    makes is recorded with a copy of its state dict taken just before its
    first train step; returns (records, undo)."""
    made = []
    real = getattr(module, name)

    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.clone()
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(clone(v) for v in tree)
        return tree

    def make(*args, **kw):
        trainer = real(*args, **kw)
        rec = {"trainer": trainer, "first": None}
        made.append(rec)
        for step in ("train_step", "train_step_batched"):
            inner = getattr(trainer, step, None)
            if inner is None:
                continue

            def wrapped(*a, _inner=inner, **k):
                if rec["first"] is None:
                    rec["first"] = clone(trainer.state_dict())
                return _inner(*a, **k)
            setattr(trainer, step, wrapped)
        return trainer

    setattr(module, name, make)
    return made, lambda: setattr(module, name, real)


def bitwise_equal(a, b):
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bitwise_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bitwise_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def counted_builds(modules):
    """Count the calls of ``make_pair_batch`` through each of ``modules``
    (which import it by name); returns (counts, undo)."""
    counts = {"builds": 0}
    undo = []
    for mod in modules:
        real = mod.make_pair_batch

        def counting(*a, _real=real, **k):
            counts["builds"] += 1
            return _real(*a, **k)
        mod.make_pair_batch = counting
        undo.append((mod, real))

    def restore():
        for mod, real in undo:
            mod.make_pair_batch = real
    return counts, restore


def loop_records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def epoch_means(record):
    """The metrics of a metrics.jsonl train_epoch record."""
    return {k: v for k, v in record.items() if k not in ("phase", "t")}


def check_loop_run(r, steps, val_batches, k1_per_build, what):
    """The launch counts and metrics of one training loop run ``r``: no
    skipped step, finite metrics, ``steps`` steps, one batch build per
    train step and val batch with ``k1_per_build`` K1 launches each, 4 K2
    launches per train step and per val batch."""
    s = r["summary"]
    values = list(s["last_train"].values()) + list(s["last_val"].values())
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"{what} gave a non-finite metric")
    if s["last_train"]["skipped_nonfinite"] != 0.0:
        raise AssertionError(f"{what} skipped a step")
    if s["train_steps"] != steps or steps < 2:
        raise AssertionError(f"{what}: {s['train_steps']} steps in the "
                             f"epoch, {steps} wanted (2 at least)")
    if r.get("builds") is not None and r["builds"] != steps + val_batches:
        raise AssertionError(f"{what} must build each train and val batch "
                             f"once")
    if r["k1"] != k1_per_build * (steps + val_batches):
        raise AssertionError(f"{what}: K1 must launch {k1_per_build} times "
                             f"per batch build")
    if r["k2"] != 4 * (steps + val_batches):
        raise AssertionError(f"{what}: K2 must launch 4 times per train step "
                             f"and per val batch")


def accumulation_steps(trainer, batch_of, what, step=None):
    """Two full-width mini-steps of an ``iter_size=2`` trainer: the
    parameters must stay bit for bit after the first and move after the
    second.  ``batch_of(k)`` gives mini-step k's batch."""
    step = step or trainer.train_step
    params = [p.detach().clone() for p in trainer.parameters()]
    times, metrics = [], []
    for k in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch_of(k))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({n: float(v) for n, v in m.items()})
        same = all(torch.equal(a, p) for a, p in
                   zip(params, trainer.parameters()))
        print(f"  {what} iter_size=2 mini-step {k + 1}: "
              f"{times[-1] * 1e3:.1f} ms  mini_step "
              f"{trainer.accumulation.mini_step}  parameters "
              f"{'unchanged' if same else 'changed'}  loss "
              f"{metrics[-1]['loss']:.6g}")
        if same != (k == 0):
            raise AssertionError(f"{what} iter_size=2: the parameters must "
                                 f"stay after mini-step 1 and move after 2")
    if not all(np.isfinite(v) for m in metrics for v in m.values()) or any(
            m["skipped_nonfinite"] for m in metrics):
        raise AssertionError(f"{what} iter_size=2 gave a non-finite or "
                             f"skipped step")


def fcgf_loop_phase(dev):
    """Phase 18: ``apr_torch.train.main`` at phase 10's full width (fused
    build, K2 Chamfer) over 12 synthetic train pairs and 4 val pairs for
    one epoch, then ``--resume_dir`` to a second; the launch counts against
    the loop's builds and steps, the artifacts, a bit-exact resume; then
    two full-width steps with iter_size=2 and two symmetric steps.  Returns
    (K1 launches, K2 launches) of the two loop runs."""
    import shutil

    import apr_torch.data.pipeline as pipeline_mod
    import apr_torch.training.loop as loop_mod
    import apr_torch.training.trainer as trainer_mod
    from apr_torch.data.datasets import make_dataset
    from apr_torch.data.pipeline import collate_raw
    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.searchsorted import searchsorted_left
    from apr_torch.train import config_from_args, main as train_main
    from apr_torch.training.trainer import FCGFTrainer

    out = os.path.join(HERE, "build", "chip_smoke", "fcgf_loop")
    shutil.rmtree(out, ignore_errors=True)
    argv = LOOP_ARGV + ["--out_dir", out, "--device", DEVICE]
    cfg = config_from_args(argv)
    b = cfg.batch_size
    train_steps = LOOP_PAIRS["train"] // b
    val_batches = -(-LOOP_PAIRS["val"] // cfg.val_batch_size)
    print(f"  python -m apr_torch.train {' '.join(LOOP_ARGV)}; "
          f"{LOOP_PAIRS['train']} train / {LOOP_PAIRS['val']} val synthetic "
          f"pairs of 30000 points, 60000 APC points")
    restore = [shrunk_datasets(LOOP_PAIRS)]
    made, undo = captured_trainers(loop_mod, "get_trainer")
    restore.append(undo)
    counts, undo = counted_builds([trainer_mod, pipeline_mod])
    restore.append(undo)
    runs = []
    try:
        for name, args in (("run", argv),
                           ("resume", ["--resume_dir", out, "--max_epoch",
                                       "2", "--device", DEVICE])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            searchsorted_left.launches = 0
            nn_min.launches = 0
            counts["builds"] = 0
            t0 = time.perf_counter()
            summary = train_main(args)
            torch.cuda.synchronize()
            runs.append(dict(
                name=name, summary=summary, wall=time.perf_counter() - t0,
                k1=searchsorted_left.launches, k2=nn_min.launches,
                builds=counts["builds"],
                peak=torch.cuda.max_memory_allocated() / 2**30))
    finally:
        for fn in reversed(restore):
            fn()
    for r in runs:
        s = r["summary"]
        print(f"  {r['name']}: {r['wall']:.1f} s; epoch steps "
              f"{s['train_steps']} in {s['train_seconds']:.2f} s = "
              f"{s['train_steps'] / s['train_seconds']:.3f} loop steps/s "
              f"(first build, fused steps, last carried step, metric reads)"
              f"; timers: data {s['data_time'] * 1e3:.1f} ms, step "
              f"{s['step_time'] * 1e3:.1f} ms; peak device memory "
              f"{r['peak']:.2f} GiB")
        print(f"    train {json.dumps(s['last_train'])}")
        print(f"    val {json.dumps(s['last_val'])}")
        print(f"    batch builds {r['builds']} (train {train_steps} + val "
              f"{val_batches}), K1 launches {r['k1']}, K2 launches "
              f"{r['k2']}")
        check_loop_run(r, train_steps, val_batches, 1,
                       f"the FCGF loop ({r['name']})")
    if runs[1]["summary"]["steps"] != 2 * train_steps:
        raise AssertionError("the resumed run did not continue the step "
                             "count")
    for item in ("config.json", "metrics.jsonl", "checkpoints",
                 "checkpoints_best"):
        if not os.path.exists(os.path.join(out, item)):
            raise AssertionError(f"the loop wrote no {item}")
    phases = [r["phase"] for r in loop_records(out)]
    print(f"  {out}: {sorted(os.listdir(out))}, checkpoints "
          f"{sorted(os.listdir(os.path.join(out, 'checkpoints')))}, "
          f"metrics.jsonl records {phases}")
    if phases != ["train_epoch", "val", "train_epoch", "val"]:
        raise AssertionError("metrics.jsonl lacks a train_epoch or val "
                             "record")
    saved, resumed = made[0]["trainer"].state_dict(), made[1]["first"]
    same = {k: bitwise_equal(resumed[k], saved[k])
            for k in ("modules", "accumulation", "step")}
    same["optimizer state"] = bitwise_equal(resumed["optimizer"]["state"],
                                            saved["optimizer"]["state"])
    print(f"  resumed trainer before its first step vs the saved one, bit "
          f"for bit: {same}")
    if not all(same.values()):
        raise AssertionError("the resume did not restore the saved state "
                             "bit for bit")
    del made

    ds = make_dataset(cfg.replace(dataset="synthetic"), "train")
    raws = [collate_raw([ds.get_pair(i) for i in range(k * b, k * b + b)],
                        cfg, dev) for k in range(2)]
    acc = FCGFTrainer(cfg.replace(iter_size=2), device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    nn_min.launches = 0
    accumulation_steps(acc, lambda k: acc.build_batch(raws[k]), "FCGF",
                       lambda batch: acc.train_step(batch, gen))
    if nn_min.launches != 8:
        raise AssertionError("each mini-step launches K2 4 times")
    del acc

    sym = FCGFTrainer(cfg.replace(symmetric=True,
                                  generator_model="ResUNetBN2B"),
                      device=dev, seed=0)
    torch.cuda.reset_peak_memory_stats()
    for k in range(2):
        batch = sym.build_batch(raws[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = {n: float(v) for n, v in sym.train_step(batch, gen).items()}
        torch.cuda.synchronize()
        print(f"  symmetric step {k + 1} (ResUNetBN2B decoder, gathered "
              f"{cfg.model_n_out}-channel {cfg.conv1_kernel_size}^3 conv1): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms  " + "  ".join(
                  f"{n} {v:.6g}" for n, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()) or m[
                "skipped_nonfinite"]:
            raise AssertionError("a symmetric step failed")
    print(f"  symmetric peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return (sum(r["k1"] for r in runs), sum(r["k2"] for r in runs))


def yaml_copy(src, dst, overrides, append):
    """Copy the YAML ``src`` to ``dst`` with the ``key: value`` lines of
    ``overrides`` replaced (each must occur once) and the lines of
    ``append`` added to its last section."""
    with open(src) as f:
        lines = f.read().splitlines()
    for key, value in overrides.items():
        hits = [i for i, line in enumerate(lines)
                if line.startswith(" ") and line.strip().split(":")[0] == key]
        if len(hits) != 1:
            raise AssertionError(f"{src}: {key} occurs {len(hits)} times")
        indent = lines[hits[0]][:len(lines[hits[0]])
                                - len(lines[hits[0]].lstrip())]
        lines[hits[0]] = f"{indent}{key}: {value}"
    lines += [f"  {key}: {value}" for key, value in append.items()]
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dst


def predator_loop_phase(dev):
    """Phase 19: ``apr_torch.main.main`` on a copy of
    configs/train/kitti.yaml (only dataset, chamfer_mode, max_epoch, out_dir
    and fused_build overridden) over 4 train and 2 val synthetic pairs for
    one epoch, with the launch counts (0 K1, 4 K2 per train step and per
    val pair), the checkpoint tags; then main in test mode on a copy of
    configs/test/kitti.yaml with that run's weights over 2 test pairs;
    then two full-width Predator steps with iter_size=2.  Returns (K1, K2)
    launches of the training run."""
    import shutil

    from apr_torch.config import APRConfig, flatten, read_yaml
    from apr_torch.data.datasets import make_dataset
    from apr_torch.main import main as yaml_main
    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.searchsorted import searchsorted_left
    from apr_torch.training.predator import PredatorTrainer
    from apr_torch.training.predator_loop import pair_to_raw

    root = os.path.join(HERE, "build", "chip_smoke")
    out = os.path.join(root, "predator_loop")
    test_out = os.path.join(root, "predator_test")
    for d in (out, test_out):
        shutil.rmtree(d, ignore_errors=True)
    train_yaml = yaml_copy(
        os.path.join(HERE, "configs", "train", "kitti.yaml"),
        os.path.join(root, "kitti_train.yaml"),
        {"dataset": "synthetic", "max_epoch": 1, "out_dir": out},
        {"chamfer_mode": "pallas", "fused_build": "true"})
    test_yaml = yaml_copy(
        os.path.join(HERE, "configs", "test", "kitti.yaml"),
        os.path.join(root, "kitti_test.yaml"),
        {"dataset": "synthetic", "out_dir": test_out, "weights": out}, {})
    cfg = APRConfig.from_dict(flatten(read_yaml(train_yaml)))
    print(f"  python -m apr_torch.main {os.path.relpath(train_yaml, HERE)}: "
          f"KPFCNN-{cfg.first_feats_dim} {cfg.compute_dtype}, caps "
          f"{cfg.kp_capacities}, limits {cfg.neighborhood_limits} (pinned), "
          f"points {cfg.point_capacity}, APC {cfg.apc_capacity}; "
          f"{PT_LOOP_PAIRS['train']} train / {PT_LOOP_PAIRS['val']} val "
          f"pairs of 30000 points, 60000 APC points")
    restore = shrunk_datasets(PT_LOOP_PAIRS)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        searchsorted_left.launches = 0
        nn_min.launches = 0
        k3_reset()
        t0 = time.perf_counter()
        summary = yaml_main(train_yaml, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = searchsorted_left.launches, nn_min.launches
        k3_take("predator_loop")
        peak = torch.cuda.max_memory_allocated() / 2**30
        searchsorted_left.launches = 0
        nn_min.launches = 0
        k3_reset()
        t0 = time.perf_counter()
        test = yaml_main(test_yaml, device=DEVICE)
        torch.cuda.synchronize()
        test_wall = time.perf_counter() - t0
        test_k = (searchsorted_left.launches, nn_min.launches)
        k3_take("predator_loop")
    finally:
        restore()
    steps = PT_LOOP_PAIRS["train"]
    print(f"  train: {wall:.1f} s; epoch steps {summary['train_steps']} in "
          f"{summary['train_seconds']:.2f} s = "
          f"{summary['train_steps'] / summary['train_seconds']:.3f} loop "
          f"steps/s; step timer {summary['step_time'] * 1e3:.1f} ms; peak "
          f"device memory {peak:.2f} GiB")
    records = loop_records(out)
    train_rec = [r for r in records if r["phase"] == "train_epoch"][0]
    print(f"    train {json.dumps(train_rec)}")
    print(f"    val {json.dumps(summary['last_val'])}")
    print(f"    K1 launches {k1}, K2 launches {k2} ({steps} steps, "
          f"{PT_LOOP_PAIRS['val']} val pairs)")
    tags = sorted(d for d in os.listdir(out) if d.startswith("checkpoints"))
    print(f"    {out}: {tags}; best_loss {summary['best_loss']:.6g}, "
          f"best_recall {summary['best_recall']:.6g}")
    check_loop_run(dict(summary=dict(summary, last_train=epoch_means(
        train_rec)), k1=k1, k2=k2), steps, PT_LOOP_PAIRS["val"], 0,
        "the Predator loop")
    if tags != ["checkpoints", "checkpoints_best_loss",
                "checkpoints_best_recall"]:
        raise AssertionError("the Predator loop's checkpoint tags are not "
                             "the reference's")
    res = np.load(os.path.join(test_out, "results.npz"))
    print(f"  test mode ({os.path.relpath(test_yaml, HERE)}, weights of the "
          f"run above): {test_wall:.1f} s, {json.dumps(test)}; results.npz "
          f"rte {res['rte'].tolist()} rre {res['rre'].tolist()}; K1 / K2 "
          f"launches {test_k}")
    if res["rte"].shape != (PT_LOOP_PAIRS["test"],) or not np.isfinite(
            res["rre"]).all() or test_k != (0, 0):
        raise AssertionError("test mode wrote no finite results.npz for "
                             "every pair, or launched a kernel")

    ds = make_dataset(cfg, "train")
    raws = [pair_to_raw(ds.get_pair(i), cfg) for i in range(2)]
    acc = PredatorTrainer(cfg.replace(iter_size=2), device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    nn_min.launches = 0
    accumulation_steps(acc, lambda k: acc.build_batch(raws[k]), "Predator",
                       lambda batch: acc.train_step(batch, gen))
    if nn_min.launches != 8:
        raise AssertionError("each Predator mini-step launches K2 4 times")
    return k1, k2


# the real-data path (phase 20): a KITTI-format tree written into a
# temporary directory (no dataset ships with the repository), frames of at
# most 120000 points, 5 m apart on a 50 m circle through one static scene per
# sequence: enough for FCGF's complement window (3 x 10 m a side) and
# kitti.yaml's (5 x 6 m); the walks give 8 train / 4 val / 4 test FCGF pairs
# and 5 train / 2 val kitti.yaml pairs.  Cut: frames and pairs (KITTI's
# sequences hold thousands of frames about 1 m apart), never a frame's width
TREE_FRAMES = {0: 72, 6: 40, 8: 40}
TREE_POINTS = 120000
TREE_STEP, TREE_RADIUS = 5.0, 50.0
# the tree's own LoKITTI list: test pairs 9 frames (43.5 m) apart
TREE_LOKITTI = [[8, 10, 19], [8, 12, 21], [8, 14, 23], [8, 16, 25]]
EVAL_PAIRS = 4
# phase 18's argv on the tree's KITTI pairs
REAL_ARGV = ["PairComplementKittiDataset" if a == "synthetic" else a
             for a in LOOP_ARGV]


def tree_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def loader_ms(cfg, split, n):
    """Host milliseconds per pair of the config's dataset (``get_pair`` in
    index order, as the loader's thread calls it) over its first ``n``
    pairs, and the split's pair count."""
    from apr_torch.data.datasets import make_dataset

    ds = make_dataset(cfg, split)
    n = min(n, len(ds))
    t0 = time.perf_counter()
    for i in range(n):
        ds.get_pair(i)
    return (time.perf_counter() - t0) * 1e3 / max(n, 1), len(ds)


def reference_resunet_pth(channels, tr, k1, n_out, seed=0):
    """A ResUNet2 state_dict in the reference's .pth layout (ME sparse
    kernels [K, in, out], norms wrapping a BatchNorm as ``.bn``)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    def kernel(k, ci, co):
        bound = np.sqrt(3.0 / (k * ci))
        return t(rng.uniform(-bound, bound, (k, ci, co)))

    def norm(name, c):
        for key, lo, hi in (("weight", 0.6, 1.4), ("bias", -0.2, 0.2),
                            ("running_mean", -0.2, 0.2),
                            ("running_var", 0.5, 1.5)):
            sd[f"{name}.bn.{key}"] = t(rng.uniform(lo, hi, c))

    def block(name, c):
        sd[f"{name}.conv1.kernel"] = kernel(27, c, c)
        sd[f"{name}.conv1.bias"] = t(rng.uniform(-0.1, 0.1, c))
        sd[f"{name}.conv2.kernel"] = kernel(27, c, c)
        norm(f"{name}.norm1", c)
        norm(f"{name}.norm2", c)

    prev = 1
    for i, c in enumerate(channels, 1):
        sd[f"conv{i}.kernel"] = kernel(k1 if i == 1 else 27, prev, c)
        norm(f"norm{i}", c)
        block(f"block{i}", c)
        prev = c
    ins = {4: channels[3], 3: channels[2] + tr[3], 2: channels[1] + tr[2]}
    for i in (4, 3, 2):
        sd[f"conv{i}_tr.kernel"] = kernel(27, ins[i], tr[i - 1])
        norm(f"norm{i}_tr", tr[i - 1])
        block(f"block{i}_tr", tr[i - 1])
    sd["conv1_tr.kernel"] = kernel(1, channels[0] + tr[1], tr[0])[0]
    sd["final.kernel"] = kernel(1, tr[0], n_out)
    sd["final.bias"] = t(rng.uniform(-0.1, 0.1, n_out))
    return sd


def real_data_phase(dev):
    """Phase 20: the real-data path on a KITTI-format tree written here.
    (a) the tree; (b) ``python -m apr_torch.train --dataset
    PairComplementKittiDataset`` at phase 10's width (fused build, K2
    Chamfer) for one epoch, then ``apr_torch.scripts.test_apr`` (LoKITTI)
    and ``apr_torch.scripts.test_fcgf`` on that run; (c) ``apr_torch.main``
    on a copy of configs/train/kitti.yaml (only kitti_root, out_dir,
    max_epoch, chamfer_mode and fused_build overridden; d3feat
    augmentation), then test mode on configs/test/kitti.yaml (LoKITTI);
    (d) a reference-layout ResUNetFatBN-128 state_dict imported and its
    encoder run on the card and the CPU.  Returns {path: (K1, K2)}."""
    import shutil
    import tempfile

    import apr_torch.data.pipeline as pipeline_mod
    import apr_torch.eval.tester as tester_mod
    import apr_torch.training.trainer as trainer_mod
    from apr_torch.config import APRConfig, flatten, read_yaml
    from apr_torch.data.datasets import make_dataset
    from apr_torch.data.synthetic import write_kitti_tree
    from apr_torch.import_checkpoint import load_reference_checkpoint_
    from apr_torch.main import main as yaml_main
    from apr_torch.models.sparse import SparseLevel, \
        build_pyramid_from_level
    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.searchsorted import searchsorted_left
    from apr_torch.ops.voxelize import voxelize_lean
    from apr_torch.scripts import test_apr, test_fcgf
    from apr_torch.train import config_from_args, main as train_main
    from apr_torch.training.trainer import get_trainer

    def counted(fn, modules=()):
        counts, undo = counted_builds(list(modules))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        searchsorted_left.launches = 0
        nn_min.launches = 0
        k3_reset()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            undo()
        return dict(summary=out, wall=time.perf_counter() - t0,
                    k1=searchsorted_left.launches, k2=nn_min.launches,
                    k3=k3_counts(),
                    builds=counts["builds"] if modules else None,
                    peak=torch.cuda.max_memory_allocated() / 2**30)

    root = os.path.join(HERE, "build", "chip_smoke")
    tmp = tempfile.mkdtemp(prefix="apr_torch_kitti_")
    launches = {}
    try:
        # (a) the tree
        tree = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        write_kitti_tree(tree, TREE_FRAMES, n_points=TREE_POINTS,
                         step=TREE_STEP, radius=TREE_RADIUS)
        np.save(os.path.join(tree, "file_LoKITTI_50.npy"),
                np.array(TREE_LOKITTI))
        secs = time.perf_counter() - t0
        n_frames = sum(TREE_FRAMES.values())
        sizes = [os.path.getsize(os.path.join(d, f)) // 16
                 for d, _, files in os.walk(tree) for f in files
                 if f.endswith(".bin")]
        print(f"  (a) tree: sequences {sorted(TREE_FRAMES)} with "
              f"{list(TREE_FRAMES.values())} frames of {min(sizes)}-"
              f"{max(sizes)} points (mean {np.mean(sizes):.0f}, at most "
              f"{TREE_POINTS}; {TREE_STEP:g} m apart), "
              f"{tree_bytes(tree) / 2**20:.1f} MiB, "
              f"written in {secs:.1f} s ({secs / n_frames * 1e3:.1f} ms a "
              f"frame)")

        # (b) FCGF: the training loop, then both eval scripts on its run
        run = os.path.join(root, "real_fcgf")
        shutil.rmtree(run, ignore_errors=True)
        argv = REAL_ARGV + ["--kitti_root", tree, "--out_dir", run,
                            "--device", DEVICE]
        cfg = config_from_args(argv)
        ms_pair, n_train = loader_ms(cfg, "train", cfg.batch_size)
        n_val = len(make_dataset(cfg, "val"))
        steps = n_train // cfg.batch_size
        print(f"  (b) python -m apr_torch.train {' '.join(REAL_ARGV)} "
              f"--kitti_root TREE: {n_train} train / {n_val} val pairs; "
              f"the loader takes {ms_pair:.1f} ms of host time a pair "
              f"({2 + 4 * cfg.num_complement_one_side} frames)")
        r = counted(lambda: train_main(argv), (trainer_mod, pipeline_mod))
        s = r["summary"]
        print(f"    {r['wall']:.1f} s; epoch steps {s['train_steps']} in "
              f"{s['train_seconds']:.2f} s = "
              f"{s['train_steps'] / s['train_seconds']:.3f} loop steps/s; "
              f"timers: data {s['data_time'] * 1e3:.1f} ms, step "
              f"{s['step_time'] * 1e3:.1f} ms; peak device memory "
              f"{r['peak']:.2f} GiB")
        print(f"    train {json.dumps(s['last_train'])}")
        print(f"    val {json.dumps(s['last_val'])}")
        print(f"    batch builds {r['builds']}, K1 launches {r['k1']}, K2 "
              f"launches {r['k2']}")
        check_loop_run(r, steps, n_val, 1, "the FCGF loop on KITTI pairs")
        if not os.path.isdir(os.path.join(run, "checkpoints_best")):
            raise AssertionError("the FCGF loop saved no best checkpoint")
        k1, k2 = r["k1"], r["k2"]
        for name, entry, extra in (
                ("test_apr", test_apr.main, ["--LoKITTI", "true"]),
                ("test_fcgf", test_fcgf.main, [])):
            results = os.path.join(run, "results.npz")
            if os.path.exists(results):
                os.remove(results)
            r = counted(lambda: entry(
                ["--save_dir", run, "--num_pairs", str(EVAL_PAIRS),
                 "--device", DEVICE] + extra), (tester_mod,))
            s, res = r["summary"], np.load(results)
            print(f"    python -m apr_torch.scripts.{name} --save_dir RUN "
                  f"--num_pairs {EVAL_PAIRS} {' '.join(extra)}: "
                  f"{r['wall']:.1f} s, {s['pairs_per_sec']:.3f} pairs/s "
                  f"(pairs 2-{EVAL_PAIRS}), recall {s['recall']:.3f} (weights "
                  f"{steps} steps old: not gated), RTE "
                  f"{['%.2f' % x for x in res['rte']]}; builds "
                  f"{r['builds']}, K1 {r['k1']}, K2 {r['k2']}; peak "
                  f"{r['peak']:.2f} GiB")
            if (res["rte"].shape != (EVAL_PAIRS,)
                    or not np.isfinite(res["rre"]).all()):
                raise AssertionError(f"{name} wrote no finite results.npz "
                                     f"for each pair")
            if r["builds"] != EVAL_PAIRS or r["k1"] != EVAL_PAIRS or r[
                    "k2"] != 0:
                raise AssertionError(f"{name}: one batch build and one K1 "
                                     f"launch per pair, no K2")
            k1 += r["k1"]
        launches["real_fcgf"] = (k1, k2)

        # (c) Predator: kitti.yaml as shipped but for the loop cuts
        out = os.path.join(root, "real_predator")
        test_out = os.path.join(root, "real_predator_test")
        for d in (out, test_out):
            shutil.rmtree(d, ignore_errors=True)
        train_yaml = yaml_copy(
            os.path.join(HERE, "configs", "train", "kitti.yaml"),
            os.path.join(root, "kitti_real_train.yaml"),
            {"kitti_root": tree, "out_dir": out, "max_epoch": 1},
            {"chamfer_mode": "pallas", "fused_build": "true"})
        test_yaml = yaml_copy(
            os.path.join(HERE, "configs", "test", "kitti.yaml"),
            os.path.join(root, "kitti_real_test.yaml"),
            {"kitti_root": tree, "out_dir": test_out, "weights": out}, {})
        pcfg = APRConfig.from_dict(flatten(read_yaml(train_yaml)))
        ms_pair, n_train = loader_ms(pcfg, "train", 2)
        n_val = len(make_dataset(pcfg, "val"))
        print(f"  (c) python -m apr_torch.main "
              f"{os.path.relpath(train_yaml, HERE)} ({pcfg.dataset}, "
              f"d3feat_augmentation {pcfg.d3feat_augmentation}): {n_train} "
              f"train / {n_val} val pairs; the loader takes {ms_pair:.1f} "
              f"ms of host time a pair "
              f"({2 + 4 * pcfg.num_complement_one_side} frames)")
        r = counted(lambda: yaml_main(train_yaml, device=DEVICE))
        s = r["summary"]
        print(f"    {r['wall']:.1f} s; epoch steps {s['train_steps']} in "
              f"{s['train_seconds']:.2f} s = "
              f"{s['train_steps'] / s['train_seconds']:.3f} loop steps/s; "
              f"step timer {s['step_time'] * 1e3:.1f} ms; peak device "
              f"memory {r['peak']:.2f} GiB")
        train_rec = [x for x in loop_records(out)
                     if x["phase"] == "train_epoch"][0]
        print(f"    train {json.dumps(train_rec)}")
        print(f"    val {json.dumps(s['last_val'])}")
        print(f"    K1 launches {r['k1']}, K2 launches {r['k2']}")
        r["summary"] = dict(s, last_train=epoch_means(train_rec))
        check_loop_run(r, n_train, n_val, 0, "the Predator loop on KITTI "
                       "pairs")
        k3_take("real_predator", r["k3"])
        k2 = r["k2"]
        r = counted(lambda: yaml_main(test_yaml, device=DEVICE))
        k3_take("real_predator", r["k3"])
        res = np.load(os.path.join(test_out, "results.npz"))
        print(f"    test mode ({os.path.relpath(test_yaml, HERE)}, LoKITTI, "
              f"the run's weights): {r['wall']:.1f} s, "
              f"{json.dumps(r['summary'])}; K1 / K2 {r['k1']} / {r['k2']}")
        if res["rte"].shape != (len(TREE_LOKITTI),) or not np.isfinite(
                res["rre"]).all() or (r["k1"], r["k2"]) != (0, 0):
            raise AssertionError("Predator test mode wrote no finite "
                                 "results.npz for each pair, or launched a "
                                 "kernel")
        launches["real_predator"] = (0, k2)

        # (d) a reference .pth state_dict at ResUNetFatBN-128 width
        icfg = APRConfig(model="ResUNetFatBN", model_n_out=128,
                         conv1_kernel_size=5, compute_dtype="float32")
        sd = reference_resunet_pth((32, 64, 128, 256), (128, 128, 128, 256),
                                   125, 128)
        pair = make_dataset(cfg.replace(LoKITTI=True), "test").get_pair(0)
        pts = torch.as_tensor(pair["points0"][None], device=dev)
        coords, keys, vmask, _ = voxelize_lean(pts, icfg.voxel_size,
                                               icfg.capacities[0])
        pyr = build_pyramid_from_level(SparseLevel(coords, keys, vmask),
                                       icfg.capacities, 5)
        feats = vmask[..., None].float()
        outs = []
        for d in (dev, torch.device("cpu")):
            trainer = get_trainer(icfg, device=d)
            load_reference_checkpoint_(trainer, {"state_dict": sd})
            with torch.inference_mode():
                outs.append(trainer.encoder(
                    feats.to(d), tree_map(lambda x: x.to(d), pyr)).cpu())
        err = float((outs[0] - outs[1]).abs().max())
        occupied = len(np.unique(np.floor(pair["points0"] / icfg.voxel_size),
                                 axis=0))
        print(f"  (d) reference-layout ResUNetFatBN-128 state_dict "
              f"({len(sd)} tensors) imported; encoder on a tree frame "
              f"({len(pair['points0'])} points in {occupied} voxels of "
              f"{icfg.voxel_size:g} m, {int(vmask.sum())} kept at level 0 "
              f"of {icfg.capacities[0]}), card vs CPU: max abs err "
              f"{err:.3e} (tolerance {ENC_F32_TOL:g})")
        if not err <= ENC_F32_TOL or not torch.isfinite(outs[0]).all():
            raise AssertionError("the imported encoder differs between the "
                                 "card and the CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# the odometry-pose GT path (phase 21): a KITTI-format sequence 00 of
# ICP_FRAMES frames of at most 120000 points, 5 m apart on a 50 m circle (2
# train pairs at the tool's defaults: pairs 5-20 m apart, 3 + 3 complements
# 10 m apart, so 25 ICPs a pair); its poses/00.txt holds camera poses
# whose velo2cam chain (the tool's odometry init) gives the true LiDAR
# poses, each frame's perturbed by a known error: a yaw of ICP_ROT_DEG
# times (t mod 8) and a rise of ICP_TRANS_M times (3t mod 8), so any two
# frames of one pair or one side (at most 7 apart) differ by 1-7 steps of
# each (a yaw leaves the rise's difference as it is)
ICP_FRAMES = 32
ICP_POINTS = 120000
ICP_ROT_DEG, ICP_TRANS_M = 0.06, 0.01
# (c): the card against the CPU's plain K2 (tens of seconds for one
# full-size search) on crops of one pair's and one side's clouds: the
# points within ICP_CPU_RADIUS of the key frame's sensor under the odometry
# init, at most ICP_CPU_POINTS of each (a seeded choice)
ICP_CPU_RADIUS, ICP_CPU_POINTS = 15.0, 2500


def perturbed_odometry(lidar_poses):
    """KITTI odometry camera poses ``V (L_t E_t) V^-1`` of the LiDAR poses
    ``L_t`` under ``velo2cam_matrix`` (V = its transpose), with the known
    per-frame error ``E_t``."""
    from apr_torch.data.kitti import velo2cam_matrix
    from apr_torch.geometry.pose_graph import se3_exp

    v = velo2cam_matrix().T
    out = []
    for t, lidar in enumerate(lidar_poses):
        xi = np.r_[0.0, 0.0, np.radians(ICP_ROT_DEG) * (t % 8), 0.0, 0.0,
                   ICP_TRANS_M * (3 * t % 8)]
        out.append(v @ lidar @ se3_exp(xi) @ np.linalg.inv(v))
    return out


def pose_error(m, truth):
    """(rotation error in degrees, translation error in metres)."""
    r = m[:3, :3] @ truth[:3, :3].T
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos))), float(
        np.linalg.norm(m[:3, 3] - truth[:3, 3]))


class KDTreeSearch:
    """scipy's cKDTree in place of :class:`apr_torch.utils.pointcloud.
    NearestSearch` (the same interface): the reference's search, on the
    host, for phase 21's yardstick."""

    def __init__(self, target, device=None):
        from scipy.spatial import cKDTree

        self.tree = cKDTree(target)

    def query(self, queries, distance_upper_bound=np.inf):
        return self.tree.query(queries, k=1,
                               distance_upper_bound=distance_upper_bound)


def wrapped(module, name, record):
    """Replace ``module.name`` by a wrapper that appends (result, seconds)
    to ``record``; returns the undo."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        record.append((out, time.perf_counter() - t0))
        return out
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def crop(points, init, radius, n, seed):
    """The points of ``points`` within ``radius`` (in x, y) of the key
    frame's sensor under ``init``, at most ``n`` of them (a seeded choice,
    file order kept)."""
    warped = points @ init[:3, :3].T + init[:3, 3]
    keep = np.flatnonzero(np.linalg.norm(warped[:, :2], axis=1) < radius)
    if len(keep) > n:
        keep = np.sort(np.random.default_rng(seed).choice(keep, n,
                                                          replace=False))
    return points[keep]


def icp_cache_phase(dev):
    """Phase 21: the odometry-pose GT path.  (a) a KITTI-format tree with
    perturbed odometry poses; (b) ``apr_torch.tools.prepare_icp_cache`` on
    the card (K2 launches against ICP iterations and information matrices,
    every cache file the loader reads, each transform's error to the true
    pose before and after ICP; then ``python -m`` again, which keeps every
    file); (c) one pair's ICP and one multiway side on the card and on the
    CPU (plain K2) from the same crops; (d) the pair's ICP with scipy's
    cKDTree on the host, and K2 at the ICP's shape against its plain
    version; (e) the cache in use: an FCGF train step through the loop CLI
    on ``use_old_pose=True`` pairs, the baseline loader's GT, one frame's
    ``extract_features`` and ``cal_overlap`` on three frames.  Returns the
    launch counts by path and K2's ICP-shape timing."""
    import logging
    import shutil
    import tempfile

    import apr_torch.data.multiway as multiway_mod
    import apr_torch.data.pipeline as pipeline_mod
    import apr_torch.geometry.icp as icp_mod
    import apr_torch.tools.prepare_icp_cache as tool_mod
    import apr_torch.training.trainer as trainer_mod
    import apr_torch.utils.pointcloud as pointcloud_mod
    from apr_torch.config import APRConfig
    from apr_torch.data.kitti import KittiBaselinePairDataset, \
        KittiComplementDataset, velo2cam_matrix
    from apr_torch.data.multiway import _voxel_dedup, full_registration
    from apr_torch.data.synthetic import write_kitti_tree
    from apr_torch.geometry.icp import registration_icp
    from apr_torch.ops.distance import nn_min, nn_min_plain
    from apr_torch.ops.searchsorted import searchsorted_left
    from apr_torch.tools import cal_overlap
    from apr_torch.train import main as train_main
    from apr_torch.training.trainer import get_trainer
    from apr_torch.utils.misc import extract_features

    tmp = tempfile.mkdtemp(prefix="apr_torch_icp_")
    out = {}
    try:
        # (a) the tree, its odometry poses perturbed
        tree = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        lidar = write_kitti_tree(tree, {0: ICP_FRAMES}, n_points=ICP_POINTS,
                                 step=TREE_STEP, radius=TREE_RADIUS)[0]
        cam = perturbed_odometry(lidar)
        with open(os.path.join(tree, "poses", "00.txt"), "w") as f:
            f.writelines(" ".join("%.12e" % v for v in c[:3].reshape(-1))
                         + "\n" for c in cam)
        cfg = APRConfig(kitti_root=tree, use_old_pose=True)
        ds = KittiComplementDataset(cfg, "train")
        print(f"  (a) tree: sequence 00, {ICP_FRAMES} frames of at most "
              f"{ICP_POINTS} points, written in "
              f"{time.perf_counter() - t0:.1f} s; odometry error per frame "
              f"{ICP_ROT_DEG:g} deg, {ICP_TRANS_M:g} m; {len(ds.files)} "
              f"train pairs at the FCGF defaults: "
              f"{[tuple(int(x) for x in e[:3]) for e in ds.files]}")
        if not 2 <= len(ds.files) <= 4:
            raise AssertionError("the tree must give 2-4 train pairs")

        # (b) the tool on the card
        icps, infos, graphs = [], [], []
        undo = [wrapped(multiway_mod, "registration_icp", icps),
                wrapped(tool_mod, "registration_icp", icps),
                wrapped(multiway_mod, "information_matrix", infos),
                wrapped(multiway_mod, "global_optimization", graphs)]
        nn_min.launches = 0
        searchsorted_left.launches = 0
        t0 = time.perf_counter()
        try:
            summary = tool_mod.main(["--kitti_root", tree, "--phase",
                                     "train", "--device", DEVICE])
        finally:
            for fn in undo:
                fn()
        tool_s = time.perf_counter() - t0
        k1_tool, k2_tool = searchsorted_left.launches, nn_min.launches
        iters = sum(r.num_iterations for r, _ in icps)
        icp_s = sum(s for _, s in icps)
        graph_ms = [s * 1e3 for _, s in graphs]
        print(f"  (b) apr_torch.tools.prepare_icp_cache.main(--kitti_root "
              f"TREE --phase train): {summary['written']} files "
              f"in {tool_s:.1f} s; {len(icps)} ICPs, {iters} iterations "
              f"({min(r.num_iterations for r, _ in icps)}-"
              f"{max(r.num_iterations for r, _ in icps)} an ICP), "
              f"{len(infos)} information matrices; K1 / K2 launches "
              f"{k1_tool} / {k2_tool}")
        print(f"    ICP {icp_s:.2f} s: {icp_s / len(icps) * 1e3:.1f} ms an "
              f"ICP, {icp_s / iters * 1e3:.2f} ms an iteration; "
              f"{icp_s / len(ds.files):.2f} s of ICP a pair; pose graphs "
              f"{len(graphs)}, {np.mean(graph_ms):.1f} ms each on the host "
              f"({min(graph_ms):.1f}-{max(graph_ms):.1f})")
        if k2_tool != iters + len(infos) or k1_tool != 0:
            raise AssertionError("K2 must launch once per ICP iteration and "
                                 "once per information matrix, K1 never")
        wanted = set()
        for drive, t0_, t1_, cmpl0, cmpl1 in ds.files:
            wanted.add((drive, int(t0_), int(t1_)))
            for key, cmpl in ((t0_, cmpl0), (t1_, cmpl1)):
                wanted.update((drive, int(c), int(key)) for c in cmpl)
        names = {"%d_%d_%d.npy" % k for k in wanted}
        have = set(os.listdir(summary["icp_path"]))
        # a pair's own file can also be a complement's of the other key
        # frame (the multiway result then replaces the pair's ICP, as in the
        # reference): so ``written`` may exceed the distinct names
        if not names <= have:
            raise AssertionError(f"the cache lacks {sorted(names - have)}")
        v2c = velo2cam_matrix()
        errors = []
        for drive, s, k in sorted(wanted):
            m = np.load(os.path.join(summary["icp_path"],
                                     "%d_%d_%d.npy" % (drive, s, k)))
            truth = np.linalg.inv(lidar[k]) @ lidar[s]
            before = pose_error(tool_mod.odo_init(v2c, cam[s], cam[k]),
                                truth)
            after = pose_error(m, truth)
            pair = any((drive, s, k) == tuple(int(x) for x in e[:3])
                       for e in ds.files)
            errors.append(before + after)
            print(f"    {drive}_{s}_{k}{' (pair)' if pair else ''}: "
                  f"odometry init {before[0]:.4f} deg {before[1] * 100:.2f} "
                  f"cm -> ICP {after[0]:.4f} deg {after[1] * 100:.3f} cm")
            if m.shape != (4, 4) or m.dtype != np.float64:
                raise AssertionError("a cache entry is not float64 [4, 4]")
            if not (after[0] < before[0] and after[1] < before[1]):
                raise AssertionError(f"ICP did not reduce the error of "
                                     f"{drive}_{s}_{k}")
        mean = np.mean(errors, axis=0)
        print(f"    all {len(errors)}: rotation error {mean[0]:.4f} -> "
              f"{mean[2]:.4f} deg, translation {mean[1] * 100:.2f} -> "
              f"{mean[3] * 100:.3f} cm (means)")
        t0 = time.perf_counter()
        rerun = subprocess.run(
            [sys.executable, "-m", "apr_torch.tools.prepare_icp_cache",
             "--kitti_root", tree, "--phase", "train", "--device", DEVICE],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        if rerun.returncode != 0 or "wrote 0 cache entries" not in \
                rerun.stdout:
            raise AssertionError(f"python -m apr_torch.tools."
                                 f"prepare_icp_cache rerun: {rerun.stdout}"
                                 f"{rerun.stderr}")
        print(f"    python -m ... again: {rerun.stdout.strip()} "
              f"({time.perf_counter() - t0:.1f} s)")
        out["icp"] = k2_tool

        # (c) card against CPU on crops of one pair and one side
        drive, t0_, t1_, cmpl0, _ = ds.files[0]
        n_side = cfg.num_complement_one_side
        poses = ds._get_poses(drive)

        def dedup(t):
            return _voxel_dedup(ds._get_xyz(drive, t), 0.05, dev)

        src, tgt = dedup(t0_), dedup(t1_)
        init = tool_mod.odo_init(v2c, poses[t0_], poses[t1_])
        side = [int(t0_)] + [int(t) for t in cmpl0[:n_side]]
        side_init = [np.eye(4)] + [tool_mod.odo_init(v2c, poses[t], poses[t0_])
                                   for t in side[1:]]
        crops = dict(
            src=crop(src, init, ICP_CPU_RADIUS, ICP_CPU_POINTS, 0),
            tgt=crop(tgt, np.eye(4), ICP_CPU_RADIUS, ICP_CPU_POINTS, 1),
            side=[crop(dedup(t), m, ICP_CPU_RADIUS, ICP_CPU_POINTS, 2 + i)
                  for i, (t, m) in enumerate(zip(side, side_init))])
        runs = []
        for d in (dev, torch.device("cpu")):
            its = []
            undo = wrapped(multiway_mod, "registration_icp", its)
            t0 = time.perf_counter()
            try:
                reg = registration_icp(crops["src"], crops["tgt"], 0.2, init,
                                       device=d)
                nodes = full_registration(crops["side"], side_init,
                                          device=d)
            finally:
                undo()
            runs.append(dict(reg=reg, nodes=nodes,
                             iters=[reg.num_iterations] + [
                                 r.num_iterations for r, _ in its],
                             s=time.perf_counter() - t0))
        gpu, cpu = runs
        err = max([np.abs(gpu["reg"].transformation
                          - cpu["reg"].transformation).max()]
                  + [np.abs(a - b).max() for a, b in zip(gpu["nodes"],
                                                         cpu["nodes"])])
        print(f"  (c) pair {drive}_{t0_}_{t1_} and the left side of "
              f"{t0_} ({side}), crops of {len(crops['src'])} / "
              f"{len(crops['tgt'])} and {[len(x) for x in crops['side']]} "
              f"points: card {gpu['s']:.2f} s, CPU {cpu['s']:.2f} s; "
              f"iterations card {gpu['iters']}, CPU {cpu['iters']}; max "
              f"|card - CPU| over the transforms {err:.3e} (tolerance 1e-9)")
        if gpu["iters"] != cpu["iters"] or not err <= 1e-9:
            raise AssertionError("ICP differs between the card and the CPU")

        # (d) the same pair's ICP with cKDTree on the host, K2 at the shape;
        # the card's iteration split into nn_min (synchronised), the rest
        # of the search (copies, the float64 distances) and the rest of the
        # iteration (the warp, the float64 Kabsch)
        searches, nn_calls = [], []

        def synced_nn_min(*a, **k):
            found = nn_min(*a, **k)
            torch.cuda.synchronize()
            return found
        pointcloud_mod.nn_min = synced_nn_min
        undo = [wrapped(pointcloud_mod.NearestSearch, "query", searches),
                wrapped(pointcloud_mod, "nn_min", nn_calls),
                lambda: setattr(pointcloud_mod, "nn_min", nn_min)]
        t0 = time.perf_counter()
        try:
            card = registration_icp(src, tgt, 0.2, init, device=dev)
        finally:
            for fn in undo:     # in this order: the last restores nn_min
                fn()
        card_s = time.perf_counter() - t0
        per_it = [sum(x for _, x in r) * 1e3 / card.num_iterations
                  for r in (nn_calls, searches)]
        icp_mod.NearestSearch = KDTreeSearch
        try:
            t0 = time.perf_counter()
            host = registration_icp(src, tgt, 0.2, init)
            host_s = time.perf_counter() - t0
        finally:
            icp_mod.NearestSearch = pointcloud_mod.NearestSearch
        diff = float(np.abs(card.transformation - host.transformation).max())
        print(f"  (d) pair {drive}_{t0_}_{t1_}, {len(src)} x {len(tgt)} "
              f"points: ICP on the card {card_s * 1e3:.1f} ms "
              f"({card.num_iterations} iterations, "
              f"{card_s / card.num_iterations * 1e3:.2f} ms each); with "
              f"scipy's cKDTree on the host {host_s * 1e3:.1f} ms "
              f"({host.num_iterations} iterations, "
              f"{host_s / host.num_iterations * 1e3:.2f} ms each); max "
              f"|card - cKDTree| {diff:.3e}, fitness {card.fitness:.6f} / "
              f"{host.fitness:.6f}")
        print(f"    the card's iteration: nn_min {per_it[0]:.2f} ms "
              f"(synchronised), the rest of the search (copies, float64 "
              f"distances) {per_it[1] - per_it[0]:.2f} ms, the warp and the "
              f"float64 Kabsch "
              f"{card_s * 1e3 / card.num_iterations - per_it[1]:.2f} ms")
        warped = src @ init[:3, :3].T + init[:3, 3]
        q = torch.from_numpy(warped.astype(np.float32))[None].to(dev)
        s = torch.from_numpy(np.ascontiguousarray(tgt))[None].to(dev)
        m = torch.ones(s.shape[:2], dtype=torch.bool, device=dev)
        k2_err = k2_check(q, s, m, None, "the ICP's shape")[2]
        pairs = q.shape[1] * s.shape[1]
        bound_ms = max(pairs * K2_OPS_PER_PAIR / FP32_OPS_PER_S,
                       (q.numel() + s.numel()) * 4 / HBM_BYTES_PER_S
                       + q.shape[1] * 8 / HBM_BYTES_PER_S) * 1e3
        kd = KDTreeSearch(tgt)
        t0 = time.perf_counter()
        kd.query(warped, 0.2)
        kd_ms = (time.perf_counter() - t0) * 1e3
        shape = dict(ms=cuda_ms(lambda: nn_min(q, s), 5),
                     plain_ms=cuda_ms(lambda: nn_min_plain(q, s, m), 1),
                     bound_ms=bound_ms, ckdtree_query_ms=kd_ms,
                     max_abs_err=k2_err)
        print(f"    K2 at the ICP's shape (B=1, {q.shape[1]} x {s.shape[1]},"
              f" {pairs:.3e} pairs): exact against its plain version; "
              f"nn_min {shape['ms']:.3f} ms, plain {shape['plain_ms']:.3f} "
              f"ms, bound {bound_ms:.3f} ms ({bound_ms / shape['ms']:.2f} of "
              f"it); one cKDTree query on the host {kd_ms:.1f} ms")
        out["icp_shape"] = shape

        # (e) the cache in use
        run = os.path.join(HERE, "build", "chip_smoke", "icp_fcgf")
        shutil.rmtree(run, ignore_errors=True)
        argv = REAL_ARGV + ["--kitti_root", tree, "--out_dir", run,
                            "--device", DEVICE, "--use_old_pose", "true",
                            "--batch_size", str(len(ds.files))]
        counts, undo = counted_builds([trainer_mod, pipeline_mod])
        searchsorted_left.launches = 0
        nn_min.launches = 0
        t0 = time.perf_counter()
        try:
            res = train_main(argv)
            torch.cuda.synchronize()
        finally:
            undo()
        k1, k2, builds = searchsorted_left.launches, nn_min.launches, \
            counts["builds"]
        print(f"  (e) python -m apr_torch.train ... --use_old_pose true "
              f"--batch_size {len(ds.files)}: {time.perf_counter() - t0:.1f}"
              f" s, {res['train_steps']} step, train "
              f"{json.dumps(res['last_train'])}; batch builds {builds}, K1 "
              f"{k1}, K2 {k2}")
        if (res["train_steps"], builds, k1, k2) != (1, 1, 1, 4) or not all(
                np.isfinite(v) for v in res["last_train"].values()) or \
                res["last_train"]["skipped_nonfinite"] != 0.0:
            raise AssertionError("the odometry-pose FCGF step: one step, one "
                                 "build, 1 K1 and 4 K2, finite, no skip")
        out["icp_loop"] = (k1, k2)

        bcfg = APRConfig(kitti_root=tree)
        base = KittiBaselinePairDataset(bcfg, "train", "nm")
        warned = []
        handler = logging.Handler()
        handler.emit = lambda rec: warned.append(rec.getMessage())
        kitti_log = logging.getLogger("apr_torch.data.kitti")
        kitti_log.addHandler(handler)
        try:
            for drive, s_, k in sorted(wanted):
                got = base._gt_transform(drive, s_, k)
                if not np.array_equal(got, np.load(os.path.join(
                        summary["icp_path"], "%d_%d_%d.npy" % (drive, s_,
                                                              k)))):
                    raise AssertionError("the baseline loader's GT is not "
                                         "the cached transform")
        finally:
            kitti_log.removeHandler(handler)
        missing = [w for w in warned if "ICP cache missing" in w]
        print(f"    KittiBaselinePairDataset (nm, {len(base)} pairs of its "
              f"own): the GT of the {len(wanted)} cached keys read from the "
              f"cache, {len(missing)} 'ICP cache missing' warnings")
        if missing:
            raise AssertionError("the baseline loader missed the cache")

        fcfg = APRConfig(model="ResUNetFatBN", model_n_out=128,
                         conv1_kernel_size=5, compute_dtype="float32")
        frame = ds._get_xyz(drive, t0_)
        searchsorted_left.launches = 0
        feats = [extract_features(get_trainer(fcfg, device=dev), frame,
                                  fcfg.voxel_size, fcfg.capacities, 5)]
        k1_ef = searchsorted_left.launches
        feats.append(extract_features(get_trainer(fcfg, device="cpu"), frame,
                                      fcfg.voxel_size, fcfg.capacities, 5))
        ef_err = float(np.abs(feats[0][1] - feats[1][1]).max())
        print(f"    extract_features on frame {t0_} ({len(frame)} points): "
              f"{len(feats[0][0])} voxels x {feats[0][1].shape[1]}, K1 "
              f"{k1_ef}; card vs CPU: xyz equal "
              f"{np.array_equal(feats[0][0], feats[1][0])}, features max abs "
              f"err {ef_err:.3e} (tolerance {ENC_F32_TOL:g})")
        if k1_ef != 1 or not np.array_equal(feats[0][0], feats[1][0]) or \
                not ef_err <= ENC_F32_TOL:
            raise AssertionError("extract_features: one K1 launch, card "
                                 "equal to the CPU")
        out["extract_features"] = k1_ef

        # three frames as 3DMatch-style fragments: in one frame (frame
        # t0's, by the true poses)
        frag = os.path.join(tmp, "fragments")
        os.makedirs(frag)
        for t in (t0_, t0_ + 1, t0_ + 2):
            m = np.linalg.inv(lidar[t0_]) @ lidar[t]
            np.save(os.path.join(frag, "frame_%02d.npy" % t),
                    (ds._get_xyz(drive, t) @ m[:3, :3].T
                     + m[:3, 3]).astype(np.float32))
        overlaps = os.path.join(tmp, "overlaps.txt")
        nn_min.launches = 0
        t0 = time.perf_counter()
        cal_overlap.main(["--dir", frag, "--voxel", "0.0625", "--out",
                          overlaps, "--device", DEVICE])
        secs = time.perf_counter() - t0
        k2_ov = nn_min.launches
        files = sorted(os.listdir(frag))
        clouds = [np.load(os.path.join(frag, f)) for f in files]
        want = []
        for i in range(3):
            for j in range(i + 1, 3):
                d0 = KDTreeSearch(clouds[j]).query(clouds[i], 0.0625)[0]
                d1 = KDTreeSearch(clouds[i]).query(clouds[j], 0.0625)[0]
                ratio = min(np.isfinite(d0).mean(), np.isfinite(d1).mean())
                want.append(f"{files[i]} {files[j]} {ratio:.6f}")
        with open(overlaps) as f:
            got = f.read().splitlines()
        print(f"    apr_torch.tools.cal_overlap.main on 3 frames: "
              f"{secs:.2f} s, K2 {k2_ov}; {got}; cKDTree's ratios equal: "
              f"{got == want}")
        if got != want or k2_ov != 6:
            raise AssertionError("cal_overlap differs from the cKDTree "
                                 "ratios or did not launch K2 twice a pair")
        out["cal_overlap"] = k2_ov
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 22: the multi-device paths on one card.  NCCL refuses two ranks on
# one GPU, so NCCL runs at world size 1 and the two-rank checks run gloo
# with both ranks on cuda:0: they time-slice the card, so their times
# measure the port's overhead, not scaling
DP_RANKS = 2
DP_TIMEOUT = 180          # seconds a collective may wait
DP_DEADLINE = 900         # seconds the ranks may take together
CHAMFER_SP_POINTS = 65536
EVAL_FIELDS = dict(model="ResUNetFatBN", model_n_out=128,
                   conv1_kernel_size=5, compute_dtype="bfloat16",
                   voxel_size=0.3, point_capacity=POINT_CAPACITY,
                   capacities=CAPS, test_subsample=SUBSAMPLE,
                   test_num_ransac_hypotheses=HYPOTHESES)


def readings_of(trainer, metrics):
    """A train step's readings from the trainer after it (numpy, so they
    can leave a rank): the metrics, the gradients the optimizer stepped on
    (summed over the ranks under a mesh), the running stats and the
    parameters after the step."""
    def host(t):
        return t.detach().to("cpu", copy=True).numpy()

    return dict(
        metrics={n: float(v) for n, v in metrics.items()},
        grads={f"{type(m).__name__}.{k}": host(
            torch.zeros_like(p) if p.grad is None else p.grad)
            for m in trainer.modules() for k, p in m.named_parameters()
            if p.requires_grad},
        stats={f"{i}.{n}": host(b) for i, m in enumerate(trainer.modules())
               for n, b in m.named_buffers()},
        params={f"{i}.{n}": host(p) for i, m in enumerate(trainer.modules())
                for n, p in m.named_parameters()})


def as_torch(readings):
    return {k: ({n: torch.from_numpy(v) for n, v in x.items()}
                if k != "metrics" else x) for k, x in readings.items()}


def bitwise_same(a, b, kinds=("metrics", "stats", "params", "grads")):
    """The names of the readings that differ in any bit."""
    out = []
    for kind in kinds:
        for n, x in a[kind].items():
            y = b[kind][n]
            same = (x == y or (np.isnan(x) and np.isnan(y))) \
                if kind == "metrics" else np.array_equal(x, y, equal_nan=True)
            if not same:
                out.append(f"{kind} {n}")
    return out


K3_LAUNCHES = {}       # Predator path -> K3 launches in its main run


def k3_reset():
    """Kernel K3's counters set to 0 before a run."""
    from apr_torch.ops.neighbors import radius_select

    radius_select.launches = radius_select.plain_cuda = 0


def k3_counts():
    """(K3 launches, card searches left on the plain chain) since
    :func:`k3_reset`."""
    from apr_torch.ops.neighbors import radius_select

    return radius_select.launches, radius_select.plain_cuda


def k3_take(path, counts=None):
    """A Predator path's K3 launches and card searches left on the plain
    chain in its main run (``k3_counts()``, or ``counts`` summed over
    ranks), added to K3_LAUNCHES[path]: every KP search of a Predator build
    on the card selects in K3, so there must be launches and no plain-chain
    search."""
    n, plain = k3_counts() if counts is None else counts
    print(f"  {path}: K3 launches {n}, card searches on the plain chain "
          f"{plain}")
    if n == 0 or plain != 0:
        raise AssertionError(f"{path}: K3 launches {n}, card searches on "
                             f"the plain chain {plain}; the Predator build "
                             f"selects in K3 alone")
    K3_LAUNCHES[path] = K3_LAUNCHES.get(path, 0) + n
    return n


class Counted:
    """K1 / K2 / K3 launches and K3's plain-chain card searches of the
    enclosed block (counts set to 0 on entry, read on exit)."""

    def __enter__(self):
        from apr_torch.ops.distance import nn_min
        from apr_torch.ops.searchsorted import searchsorted_left

        self.k = (searchsorted_left, nn_min)
        for f in self.k:
            f.launches = 0
        k3_reset()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.k1, self.k2 = (f.launches for f in self.k)
        self.k3, self.k3_plain = k3_counts()


def synced_ms(fn, reps=3):
    """The median of ``reps`` synchronised calls of ``fn``, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase22_rank(mesh, job):
    """One rank of phase 22's gloo world (every rank on cuda:0): the FCGF
    data-parallel step (its readings, with and without the planted fault,
    step time and the collectives' split), the Predator grouped step
    (readings with and without its planted fault), test_sharded of both
    testers, the sequence-parallel Chamfer and the builder / trainer
    pipeline; each path's K1 / K2 launches on this rank."""
    from apr_torch.config import APRConfig
    from apr_torch.eval import FeatureTester, PredatorTester
    from apr_torch.parallel import BuilderTrainerPipeline, shard_batch
    from apr_torch.parallel.chamfer_sp import chamfer_distance_sp
    from apr_torch.training.predator import PredatorTrainer
    from apr_torch.training.trainer import FCGFTrainer

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"launches": {}}
    cfg = APRConfig(**job["fields"]["train"])

    def fcgf_step(fault=False, c=cfg):
        tr = FCGFTrainer(c, device=dev, seed=0)
        tr.use_mesh(mesh)
        undo = planted_fault() if fault else (lambda: None)
        try:
            with Counted() as n:
                batch = tr.build_batch(shard_batch(job["raw"], mesh))
                m = tr.train_step(batch, torch.Generator(dev).manual_seed(5))
        finally:
            undo()
        return tr, batch, m, n

    tr, batch, m, n = fcgf_step()
    out["launches"]["dp_fcgf"] = (n.k1, n.k2)
    out["fcgf_bf16"] = readings_of(tr, m)
    gen = torch.Generator(dev).manual_seed(8)
    out["fcgf_step_ms"] = synced_ms(lambda: tr.train_step(batch, gen))
    mesh.timings = {}
    out["fcgf_split_ms"] = synced_ms(lambda: tr.train_step(batch, gen), 1)
    out["fcgf_split"] = {k: v * 1e3 for k, v in mesh.timings.items()}
    mesh.timings = None
    del tr, batch
    f32 = APRConfig(**job["fields"]["train_f32"])
    out["fcgf"] = readings_of(*fcgf_step(c=f32)[::2])
    out["fcgf_faulted"] = readings_of(*fcgf_step(fault=True, c=f32)[::2])

    pcfg = APRConfig(**job["fields"]["predator_train"])

    def predator_step(fault=False):
        tr = PredatorTrainer(pcfg, device=dev, seed=0)
        tr.use_mesh(mesh)
        undo = planted_cross_attention_fault() if fault else (lambda: None)
        try:
            with Counted() as n:
                batch = tr.build_batch_group(shard_batch(job["pt_raw"],
                                                         mesh))
                m = tr.train_step_batched(
                    batch, torch.Generator(dev).manual_seed(6), 1.0,
                    pair_weights=job["pt_weights"])
        finally:
            undo()
        return tr, batch, m, n

    tr, batch, m, n = predator_step()
    out["launches"]["dp_predator"] = (n.k1, n.k2)
    out["k3"] = {"dp_predator": (n.k3, n.k3_plain)}
    out["predator"] = readings_of(tr, m)
    out["predator_step_ms"] = synced_ms(lambda: tr.train_step_batched(
        batch, gen, 1.0, pair_weights=job["pt_weights"]))
    out["predator_faulted"] = readings_of(*predator_step(fault=True)[::2])
    del tr, batch

    k1 = k2 = 0
    for name, kind, pairs in (("fcgf_eval", "eval", job["pairs"]),
                              ("predator_eval", "predator_eval",
                               job["kp_pairs"])):
        tester = tester_for(kind, job["fields"][kind], dev)
        with Counted() as n:
            t0 = time.perf_counter()
            stats = tester.test_sharded(pairs, mesh=mesh, seed=0)
        k1, k2 = k1 + n.k1, k2 + n.k2
        if kind == "predator_eval":
            out["k3"]["sharded_predator_eval"] = (n.k3, n.k3_plain)
        out[name] = dict(rte=stats.rte, rre=stats.rre,
                         fitness=stats.fitness, success=stats.success,
                         pairs_per_sec=stats.summary()["pairs_per_sec"],
                         seconds=time.perf_counter() - t0, k1=n.k1)
        del tester
    out["launches"]["sharded_eval"] = (k1, k2)

    a, b, am, bm = (torch.from_numpy(x).to(dev) for x in job["chamfer"])
    a.requires_grad_(True)
    b.requires_grad_(True)
    v = chamfer_distance_sp(mesh)(a, b, am, bm)
    v.backward()
    out["chamfer_sp"] = (float(v.detach()), a.grad.cpu().numpy(),
                         b.grad.cpu().numpy())

    ptr = FCGFTrainer(cfg, device=dev, seed=0)
    pipe = BuilderTrainerPipeline(ptr, 1, mesh)
    losses = []
    with Counted() as n:
        t0 = time.perf_counter()
        pipe.run(job["pipe_raws"], torch.Generator(dev).manual_seed(7),
                 on_metrics=lambda m: losses.append(float(m["loss"])))
    out["launches"]["pipeline"] = (n.k1, n.k2)
    out["pipeline"] = dict(
        builder=pipe.is_builder, losses=losses,
        seconds=time.perf_counter() - t0,
        params=None if pipe.is_builder else readings_of(ptr, {})["params"])
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def tester_for(kind, fields, dev):
    """The FCGF ("eval") or Predator tester of ``fields``, random weights
    from seed 0."""
    from apr_torch.config import APRConfig
    from apr_torch.eval import FeatureTester, PredatorTester
    from apr_torch.training.predator import PredatorTrainer
    from apr_torch.training.trainer import FCGFTrainer

    c = APRConfig(**fields)
    if kind == "eval":
        return FeatureTester(c, FCGFTrainer(c, device=dev, seed=0),
                             device=dev)
    return PredatorTester(c, PredatorTrainer(c, device=dev, seed=0),
                          device=dev)


def nccl_rank(mesh):
    """One NCCL all-reduce (the probe of two ranks on one card)."""
    import torch.distributed as dist

    t = torch.ones(1, device=mesh.device)
    dist.all_reduce(t)
    return float(t)


def nccl_refuses_one_card(dev):
    """Two NCCL ranks on one card: the error NCCL gives (the reason the
    two-rank checks run gloo), or None when it takes them."""
    from apr_torch.parallel.launch import spawn

    try:
        spawn(nccl_rank, 2, devices=str(dev), backend="nccl", timeout=60,
              deadline=180, threads=None)
    except RuntimeError as e:
        return next((ln.strip() for ln in str(e).splitlines()
                     if "Duplicate GPU" in ln or "NCCL error" in ln),
                    str(e).splitlines()[-1])
    return None


def compare_rank_step(c, ranks, nudged, faulted, tol, fault):
    """check_step's rule for a data-parallel step: rank 0's readings
    against the one-process step's on the card, beside rank 1's, the
    one-process step under a 1e-6 nudge and the planted fault's."""
    check_step((as_torch(c), as_torch(ranks[0]), as_torch(ranks[1]),
                as_torch(nudged), as_torch(faulted)), tol, fault)


def multi_rank_phase(dev, pairs, kp_pairs, raws, pairs_per_s):
    """Phase 22: (a) NCCL at world size 1 and the dry run; (b)-(f) two
    gloo ranks on the card (see the module docstring).  Returns each
    path's K1 / K2 launches over the ranks."""
    import torch.distributed as dist

    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import synthetic_pair
    from apr_torch.ops.chamfer import chamfer_distance
    from apr_torch.parallel import make_mesh
    from apr_torch.parallel.launch import spawn
    from apr_torch.parallel.mesh import pair_generators
    from apr_torch.training.predator import PredatorTrainer
    from apr_torch.training.trainer import FCGFTrainer

    fields = dict(train=TRAIN_FIELDS, predator_train=PT_FIELDS,
                  eval=EVAL_FIELDS, predator_eval=KP_FIELDS,
                  train_f32=dict(TRAIN_FIELDS, compute_dtype="float32"))
    cfg = APRConfig(**TRAIN_FIELDS)

    def one_step(mesh=None, nudge=False, c=cfg):
        tr = FCGFTrainer(c, device=dev, seed=0)
        if nudge:
            g = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for p in tr.parameters():
                    p.mul_(1.0 + 1e-6 * torch.randn(p.shape, generator=g)
                           .to(dev))
        if mesh is not None:
            tr.use_mesh(mesh)
        batch = tr.build_batch(raws[0])
        m = tr.train_step(batch, torch.Generator(dev).manual_seed(5))
        return readings_of(tr, m), tr, batch

    print("  (a) NCCL at world size 1: the FCGF data-parallel step through "
          "make_mesh against the meshless step, phase 10's config, B = "
          f"{cfg.batch_size}")
    pcfg = APRConfig(**PT_FIELDS)
    pair = synthetic_pair(seed=300, **PT_PAIR)
    pt_raw = raw_batch([pair, pair], pcfg)     # the tail pair repeats
    pt_weights = (1.0, 0.0)

    def predator_one(mesh=None, nudge=False):
        tr = PredatorTrainer(pcfg, device=dev, seed=0)
        if nudge:
            g = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for p in tr.parameters():
                    p.mul_(1.0 + 1e-6 * torch.randn(p.shape, generator=g)
                           .to(dev))
        if mesh is not None:
            tr.use_mesh(mesh)
        batch = tr.build_batch_group(tuple(torch.from_numpy(x).to(dev)
                                           for x in pt_raw))
        m = tr.train_step_batched(batch, torch.Generator(dev).manual_seed(6),
                                  1.0, pair_weights=pt_weights)
        return readings_of(tr, m), tr, batch

    one, tr, batch = one_step()
    one_ms = synced_ms(lambda: tr.train_step(
        batch, torch.Generator(dev).manual_seed(8)))
    del tr, batch
    again = one_step()[0]
    pt_one, tr, batch = predator_one()
    pt_one_ms = synced_ms(lambda: tr.train_step_batched(
        batch, torch.Generator(dev).manual_seed(8), 1.0,
        pair_weights=pt_weights))
    del tr, batch
    mesh = make_mesh(dev, rank=0, world_size=1)
    try:
        nccl, tr, batch = one_step(mesh)
        nccl_ms = synced_ms(lambda: tr.train_step(
            batch, torch.Generator(dev).manual_seed(8)))
        del tr, batch
        pt_nccl = predator_one(mesh)[0]
    finally:
        dist.destroy_process_group()
    rerun = bitwise_same(one, again)
    diff = bitwise_same(nccl, one)
    print(f"  meshless step twice: {'bit for bit' if not rerun else rerun}")
    print(f"  NCCL world-1 step vs meshless: "
          f"{'bit for bit' if not diff else diff[:4]} (loss "
          f"{nccl['metrics']['loss']!r} vs {one['metrics']['loss']!r}; "
          f"{len(one['params'])} parameters, {len(one['stats'])} running "
          f"stats)")
    print(f"  step ms: meshless {one_ms:.1f}, NCCL world 1 {nccl_ms:.1f}")
    if diff:
        raise AssertionError(f"the NCCL world-1 step differs from the "
                             f"meshless one: {diff[:8]}")
    pt_rerun = bitwise_same(pt_one, predator_one()[0])
    pt_diff = bitwise_same(pt_nccl, pt_one)
    print(f"  the grouped Predator step (kitti.yaml's width, group of 2, "
          f"weights (1, 0)) twice: "
          f"{'bit for bit' if not pt_rerun else pt_rerun[:4]}; NCCL world "
          f"1 vs meshless: {'bit for bit' if not pt_diff else pt_diff[:4]} "
          f"({len(pt_one['grads'])} gradient leaves, "
          f"{len(pt_one['stats'])} running stats)")
    if pt_rerun or pt_diff:
        raise AssertionError(f"the grouped Predator step is not bit for "
                             f"bit: twice {pt_rerun[:8]}, NCCL world 1 "
                             f"{pt_diff[:8]}")
    nudged_bf16 = one_step(nudge=True)[0]
    f32 = APRConfig(**fields["train_f32"])
    one_f32 = one_step(c=f32)[0]
    nudged = one_step(nudge=True, c=f32)[0]
    pt_nudged = predator_one(nudge=True)[0]

    rng = np.random.default_rng(22)
    cham = [rng.uniform(-40, 40, (CHAMFER_SP_POINTS, 3)).astype(np.float32)
            for _ in range(2)]
    masks = [np.arange(CHAMFER_SP_POINTS) < CHAMFER_SP_POINTS
             - CHAMFER_SP_POINTS // k for k in (64, 20)]
    job = dict(fields=fields, raw=raws[0], pt_raw=pt_raw,
               pt_weights=pt_weights,
               pairs=pairs, kp_pairs=kp_pairs,
               chamfer=(cham[0], cham[1], masks[0], masks[1]),
               pipe_raws=[raws[0], raws[1], raws[0]])
    torch.cuda.empty_cache()
    # the dry run (NCCL, one rank) starts beside the two gloo ranks: its
    # card work is a few small steps, done while the ranks start up
    t0 = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-m", "apr_torch.dryrun", "1",
                            "--device", dev.type], cwd=HERE,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        ranks = spawn(phase22_rank, DP_RANKS, args=(job,),
                      devices=str(dev), backend="gloo", timeout=DP_TIMEOUT,
                      deadline=DP_DEADLINE, threads=None)
        print(f"  two gloo ranks on {dev} ran (b)-(f) in "
              f"{time.perf_counter() - t0:.1f} s, start-up included")
        out, err = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    lines = [ln for ln in out.splitlines()
             if ln.startswith("dryrun_multichip(1)")]
    for ln in lines:
        print(f"  {ln}")
    print(f"  python -m apr_torch.dryrun 1 (NCCL): exit {dry.returncode}")
    if dry.returncode != 0 or len(lines) != 2:
        raise AssertionError(f"the NCCL dry run failed:\n{err[-3000:]}")
    launches = {path: tuple(sum(r["launches"][path][i] for r in ranks)
                            for i in (0, 1))
                for path in ranks[0]["launches"]}
    for path in ranks[0]["k3"]:
        k3_take(path, [sum(r["k3"][path][i] for r in ranks) for i in (0, 1)])

    print(f"  (b) FCGF data-parallel step, B = {cfg.batch_size} as "
          f"{cfg.batch_size // DP_RANKS} + {cfg.batch_size // DP_RANKS}, "
          "against the one-process step on the card")
    for r, res in enumerate(ranks):
        k1, k2 = res["launches"]["dp_fcgf"]
        split = res["fcgf_split"]
        print(f"  rank {r}: step {res['fcgf_step_ms']:.1f} ms (one process "
              f"B = {cfg.batch_size}: {one_ms:.1f} ms); a synchronised step "
              f"{res['fcgf_split_ms']:.1f} ms of which gather "
              f"{split.get('gather', 0.0):.2f}, BN all-reduces "
              f"{split.get('bn_all_reduce', 0.0):.2f}, gradient all-reduce "
              f"{split.get('grad_all_reduce', 0.0):.2f}, finite flag "
              f"{split.get('finite', 0.0):.2f} ms; K1 {k1} (one build), "
              f"K2 {k2} (one step); peak {res['peak_gib']:.2f} GiB")
        if (k1, k2) != (1, 4):
            raise AssertionError(f"rank {r}: the data-parallel FCGF path "
                                 f"launched K1 {k1} / K2 {k2} times, not "
                                 f"1 / 4")
    same = (bitwise_same(ranks[0]["fcgf"], ranks[1]["fcgf"])
            + bitwise_same(ranks[0]["fcgf_bf16"], ranks[1]["fcgf_bf16"]))
    print(f"  the ranks' readings: {'bit for bit' if not same else same[:4]}")
    if same:
        raise AssertionError("the ranks' FCGF steps differ")
    # phase 12's rule is a float32 rule: in bf16 a 1e-6 nudge of the
    # weights already moves the running stats by ~1e-3 of a tensor, so the
    # gated comparison runs the same widths in float32; the bf16 step is
    # printed beside its own nudge
    bf16 = ranks[0]["fcgf_bf16"]
    errs = leaf_errors(as_torch(one), as_torch(bf16), as_torch(nudged_bf16))
    loss_rel = [max(abs(x["metrics"][n] - v) / max(abs(v), 1e-12)
                    for n, v in one["metrics"].items())
                for x in (bf16, nudged_bf16)]
    top = {kind: [max(e[i] for k, _, _, e in errs if k == kind)
                  for i in (0, 1)] for kind in ("stats", "grads")}
    print(f"  bf16 (not gated), the largest differences, ranks vs one "
          f"process / one process under a 1e-6 nudge: loss terms "
          f"{loss_rel[0]:.2e} / {loss_rel[1]:.2e} (relative), running "
          f"stats {top['stats'][0]:.2e} / {top['stats'][1]:.2e}, gradients "
          f"{top['grads'][0]:.2e} / {top['grads'][1]:.2e} (of each "
          f"tensor's largest entry)")
    print("  float32 at the same widths, gated by phase 12's rule:")
    compare_rank_step(one_f32, [r["fcgf"] for r in ranks], nudged,
                      ranks[0]["fcgf_faulted"], GRAD_TOL,
                      "no reverse_k flip")

    print("  (c) Predator grouped step at kitti.yaml's width, group 2 over "
          "2 ranks, weights (1, 0), against the one-process group")
    for r, res in enumerate(ranks):
        k1, k2 = res["launches"]["dp_predator"]
        print(f"  rank {r}: step {res['predator_step_ms']:.1f} ms (one "
              f"process, group of 2: {pt_one_ms:.1f} ms); K1 {k1}, K2 {k2}")
        if (k1, k2) != (0, 4):
            raise AssertionError(f"rank {r}: the grouped Predator path "
                                 f"launched K1 {k1} / K2 {k2} times, not "
                                 f"0 / 4")
    same = bitwise_same(ranks[0]["predator"], ranks[1]["predator"])
    print(f"  the ranks' readings: {'bit for bit' if not same else same[:4]}"
          f" (the two ranks sum in another order than one process: held "
          f"by phase 17's rule)")
    if same:
        raise AssertionError("the ranks' Predator steps differ")
    compare_rank_step(pt_one, [r["predator"] for r in ranks], pt_nudged,
                      ranks[0]["predator_faulted"], PT_GRAD_TOL,
                      "attention message detached")

    print(f"  (d) test_sharded of both testers, {len(pairs)} pairs over "
          f"{DP_RANKS} ranks, against one-process steps with the same "
          "per-pair draws")
    for name, kind, ps, per_s in (
            ("fcgf_eval", "eval", pairs, pairs_per_s[0]),
            ("predator_eval", "predator_eval", kp_pairs, pairs_per_s[1])):
        tester = tester_for(kind, fields[kind], dev)
        gen = torch.Generator(dev).manual_seed(0)
        want = []
        for kw, group in tester._sharded_groups(list(ps), DP_RANKS):
            gens = pair_generators(gen, DP_RANKS)
            for i, p in enumerate(group):
                _, rte, rre, fit = tester.step(tester._pair_to_batch(
                    p, **kw), gens[i])
                want.append((float(rte), float(rre), float(fit)))
        want = np.asarray(want)
        want[:, 1] = np.where(np.isfinite(want[:, 1]), want[:, 1], 180.0)
        for r, res in enumerate(ranks):
            got = np.stack([res[name]["rte"], res[name]["rre"],
                            res[name]["fitness"]], 1)
            err = float(np.abs(got - want).max())
            print(f"  {name} rank {r}: {res[name]['pairs_per_sec']:.3f} "
                  f"pairs/s over both ranks (test on one process: "
                  f"{per_s:.3f}); {res[name]['seconds']:.1f} s; K1 "
                  f"{res[name]['k1']}; max |rank - one process| over RTE, "
                  f"RRE, fitness {err:.3g}")
            if err:
                raise AssertionError(f"{name}: rank {r}'s results differ "
                                     f"from the one-process steps")

    a, b, am, bm = (torch.from_numpy(x).to(dev)
                    for x in (cham[0], cham[1], masks[0], masks[1]))
    a.requires_grad_(True)
    b.requires_grad_(True)
    v = chamfer_distance(a[None], b[None], am[None], bm[None])[0]
    v.backward()
    print(f"  (e) chamfer_sp, two {CHAMFER_SP_POINTS}-point clouds over "
          f"{DP_RANKS} ranks, against chamfer_distance")
    for r, res in enumerate(ranks):
        val, ga, gb = res["chamfer_sp"]
        ea = float(np.abs(ga - a.grad.cpu().numpy()).max())
        eb = float(np.abs(gb - b.grad.cpu().numpy()).max())
        print(f"  rank {r}: value {val!r} vs {float(v.detach())!r}; max "
              f"grad errors {ea:.3g} / {eb:.3g}")
        np.testing.assert_allclose(val, float(v.detach()), rtol=1e-5)
        np.testing.assert_allclose(ga, a.grad.cpu().numpy(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(gb, b.grad.cpu().numpy(), rtol=1e-4,
                                   atol=1e-6)

    print("  (f) BuilderTrainerPipeline, 1 builder + 1 trainer, 3 steps, "
          "against 3 serial steps on one process")
    tr = FCGFTrainer(cfg, device=dev, seed=0)
    gen = torch.Generator(dev).manual_seed(7)
    losses = [float(tr.train_step(tr.build_batch(raw), gen)["loss"])
              for raw in job["pipe_raws"]]
    serial = readings_of(tr, {})["params"]
    del tr
    trainer_rank = next(r for r in ranks if not r["pipeline"]["builder"])
    builder_rank = next(r for r in ranks if r["pipeline"]["builder"])
    got = trainer_rank["pipeline"]
    exact = (got["losses"] == losses and not bitwise_same(
        dict(params=got["params"]), dict(params=serial), ("params",)))
    err = max(float(np.abs(got["params"][n] - serial[n]).max())
              for n in serial)
    print(f"  losses {got['losses']} vs serial {losses}; parameters "
          f"{'bit for bit' if exact else f'max abs diff {err:.3g}'}; "
          f"{got['seconds']:.1f} s; K1 / K2 builder "
          f"{builder_rank['launches']['pipeline']}, trainer "
          f"{trainer_rank['launches']['pipeline']}")
    if builder_rank["launches"]["pipeline"] != (3, 0) or \
            trainer_rank["launches"]["pipeline"] != (0, 12):
        raise AssertionError("the pipeline's builder must launch K1 once a "
                             "build and its trainer K2 four times a step")
    # held as phase 12 holds running stats: each tensor within 1e-4 of
    # its own largest entry (exact where the builds and steps are)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for n in serial:
        np.testing.assert_allclose(
            got["params"][n], serial[n], rtol=0,
            atol=1e-4 * float(np.abs(serial[n]).max()), err_msg=n)
    if dev.type == "cuda" and torch.cuda.device_count() == 1:
        refused = nccl_refuses_one_card(dev)
        print(f"  NCCL with two ranks on this one card: "
              f"{refused or 'taken (the gloo checks above stand)'}")
    print("  (two ranks share one card and time-slice it: these times are "
          "the port's overhead, not multi-GPU scaling)")
    return launches


class Shared:
    """What the phases share.  A phase that needs what an earlier phase
    makes (the eval pairs, the level-0 grids, the train batches, the KP
    pairs) takes it from here, where it is made at first use when that
    phase was not selected; each phase adds its kernels' launches and
    readings for the record."""

    def __init__(self, dev, args):
        self.dev = dev
        self.args = args
        self.baseline = None
        self.smi = None
        self.k1_launches = {}          # path -> K1 launches in its run
        self.k2_launches = {}
        self.k1_err = 0
        self.k2_err = 0.0
        self.k1_time = None            # phase 8's record (one eval build)
        self.k2_time = None            # phase 11's (one FCGF step)
        self.pt_step = None            # phase 16's (one Predator step)
        self.k3_time = None            # phase 13's (one Predator build)
        self.splits = {}               # phases 10, 16: their stage splits
        self.icp_shape = None          # phase 21's (one ICP search)
        self.pairs_per_s = [float("nan"), float("nan")]
        self._made = {}

    def made(self, name, fn):
        if name not in self._made:
            self._made[name] = fn()
        return self._made[name]

    @property
    def pairs(self):
        """The eval slice's N_PAIRS synthetic pairs."""
        from apr_torch.data.synthetic import synthetic_pair

        return self.made("pairs", lambda: [
            synthetic_pair(seed=s, n_points=N_POINTS, apc_points=4,
                           extent=60.0, distance=20.0)
            for s in range(N_PAIRS)])

    @property
    def levels(self):
        """The level-0 grid of the first 4 pairs' 8 clouds at 0.3 m and
        its coarser levels (SparseLevel each)."""
        def make():
            from apr_torch.data.synthetic import pad_points
            from apr_torch.models.sparse import SparseLevel, \
                downsample_level
            from apr_torch.ops.voxelize import voxelize_lean

            clouds = [p[k] for p in self.pairs[:4]
                      for k in ("points0", "points1")]
            padded = [pad_points(c, POINT_CAPACITY) for c in clouds]
            pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(
                self.dev)
            msk = torch.from_numpy(np.stack([m for _, m in padded])).to(
                self.dev)
            coords, keys, vmask, _ = voxelize_lean(pts, 0.3, CAPS[0], msk)
            levels = [SparseLevel(coords, keys, vmask)]
            for cap in CAPS[1:]:
                levels.append(downsample_level(levels[-1], cap))
            return levels
        return self.made("levels", make)

    @property
    def tester(self):
        """The eval slice's FeatureTester (ResUNetFatBN-128 bf16)."""
        def make():
            from apr_torch.config import APRConfig
            from apr_torch.eval import FeatureTester
            from apr_torch.training.trainer import FCGFTrainer

            cfg = APRConfig(**EVAL_FIELDS)
            return FeatureTester(cfg, FCGFTrainer(cfg, device=self.dev,
                                                  seed=0), device=self.dev)
        return self.made("tester", make)

    @property
    def raws(self):
        """The training slice's two batches of raw arrays."""
        def make():
            from apr_torch.config import APRConfig

            cfg = APRConfig(**TRAIN_FIELDS)
            b = cfg.batch_size
            t0 = time.perf_counter()
            tpairs = train_pairs(2 * b)
            out = [raw_batch(tpairs[:b], cfg), raw_batch(tpairs[b:], cfg)]
            print(f"  {len(tpairs)} synthetic pairs ({TRAIN_POINTS} points, "
                  f"{TRAIN_APC_POINTS} APC points) made on the host in "
                  f"{time.perf_counter() - t0:.1f} s (set-up, not timed)")
            return out
        return self.made("raws", make)

    @property
    def train_trainer(self):
        """The training slice's FCGFTrainer."""
        from apr_torch.config import APRConfig
        from apr_torch.training.trainer import FCGFTrainer

        return self.made("train_trainer", lambda: FCGFTrainer(
            APRConfig(**TRAIN_FIELDS), device=self.dev, seed=0))

    @property
    def kp_pairs(self):
        """The Predator eval's N_PAIRS synthetic pairs."""
        from apr_torch.data.synthetic import synthetic_pair

        return self.made("kp_pairs", lambda: [
            synthetic_pair(seed=s, **KP_PAIR) for s in range(N_PAIRS)])


def phase_1(ctx):
    phase("1 device")
    import apr_torch  # noqa: F401  (sets the TF32 flags)

    ctx.smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(ctx.smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the port's float32 paths")


def phase_2(ctx):
    phase("2 build")
    from apr_torch.kernels.build import BUILD_ROOT, build_all

    secs = build_all()
    print(f"built every kernel in {secs:.1f} s into "
          f"{os.path.relpath(BUILD_ROOT, HERE)}")
    for log in sorted(BUILD_ROOT.glob("*/*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem}: {line.strip()}")
    if ctx.args.k1_baseline:
        ctx.baseline = baseline_k1(ctx.args.k1_baseline)
        print(f"  baseline K1 built from {ctx.args.k1_baseline}")


def phase_3a(ctx):
    phase("3a K1 contract cases (kernel vs plain vs numpy, exact; one by "
          "one, then grouped)")
    from apr_torch.ops.searchsorted import searchsorted_left, \
        searchsorted_left_many, searchsorted_left_plain

    dev = ctx.dev
    cases = [(name, sup, q, torch.from_numpy(sup)[None].to(dev),
              torch.from_numpy(q)[None].to(dev))
             for name, sup, q in contract_cases()]
    grouped = searchsorted_left_many([(s_t, q_t) for *_, s_t, q_t in cases])
    for (name, sup, q, s_t, q_t), got_many in zip(cases, grouped):
        got = searchsorted_left(s_t, q_t)
        want = searchsorted_left_plain(s_t, q_t)
        err = max(int((got - want).abs().max()),
                  int((got_many - want).abs().max()))
        ctx.k1_err = max(ctx.k1_err, err)
        ref = np.searchsorted(sup, q, side="left")
        if err or not np.array_equal(got[0].cpu().numpy(), ref):
            raise AssertionError(f"K1 wrong on {name}: err {err}")
        print(f"  {name}: S={sup.shape[0]} G={q.shape[0]} C={q.shape[1]} "
              f"exact")
    print(f"  {len(cases)} cases grouped into "
          f"{-(-len(cases) // 8)} launches: exact")
    torch.cuda.synchronize()


def phase_3b(ctx):
    t = phase("3b K1 at full capacity, 7 searches over 8 clouds")
    levels = ctx.levels
    print(f"  voxels per cloud at level 0: "
          f"{levels[0].mask.sum(1).tolist()} of {CAPS[0]}")
    k1_b8 = time_searches(searches_of(levels, 5), baseline=ctx.baseline)
    ctx.k1_err = max(ctx.k1_err, k1_b8["max_abs_err"])
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_4(ctx):
    t = phase("4 pyramid: fast maps through K1 equal the slow oracles")
    from apr_torch.models.sparse import build_pyramid_from_level, \
        kernel_map_down, kernel_map_same, kernel_map_up

    levels = ctx.levels
    pyr = build_pyramid_from_level(levels[0], CAPS, 5)
    checks = [("conv1 5^3", pyr.conv1_map, kernel_map_same(levels[0], 5))]
    for l in range(1, 4):
        checks.append((f"same L{l}", pyr.same_maps[l],
                       kernel_map_same(levels[l], 3)))
    for l in range(3):
        checks.append((f"down L{l}->L{l + 1}", pyr.down_maps[l],
                       kernel_map_down(levels[l + 1], levels[l], 3)))
        checks.append((f"up L{l + 1}->L{l}", pyr.up_maps[l],
                       kernel_map_up(levels[l], levels[l + 1], 3)))
    for name, fast, slow in checks:
        if not torch.equal(fast, slow):
            raise AssertionError(f"kernel map {name} differs from the "
                                 f"oracle")
        print(f"  {name}: {tuple(fast.shape)} equal")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_5(ctx):
    t = phase("5 encoder ResUNetFatBN, card vs CPU (float32) and bf16")
    from apr_torch.models import load_model
    from apr_torch.models.sparse import SparseLevel, \
        build_pyramid_from_level

    dev = ctx.dev
    coords, keys, vmask = ctx.levels[0]
    one = SparseLevel(coords[:1], keys[:1], vmask[:1])
    pyr1 = build_pyramid_from_level(one, CAPS, 5)
    pyr1_cpu = tree_map(lambda x: x.cpu(), pyr1)
    feats = vmask[:1, :, None].float()
    kw = dict(out_channels=128, conv1_kernel_size=5, ones_input=True,
              normalize_feature=True, seed=0)
    make = load_model("ResUNetFatBN")
    with torch.inference_mode():
        f_gpu = make(device=dev, **kw)(feats, pyr1)
        f_cpu = make(device="cpu", **kw)(feats.cpu(), pyr1_cpu)
        f_bf16 = make(device=dev, compute_dtype="bfloat16", **kw)(
            feats, pyr1)
    enc_err = float((f_gpu.cpu() - f_cpu).abs().max())
    bf16_dev = float((f_bf16 - f_gpu).abs().max())
    print(f"  float32 card vs CPU: max abs err {enc_err:.3e} on unit-norm "
          f"features (tolerance {ENC_F32_TOL:g})")
    print(f"  bf16 vs float32 on the card: max abs deviation {bf16_dev:.3e}")
    if not enc_err <= ENC_F32_TOL:
        raise AssertionError("float32 encoder differs between card and CPU")
    if not torch.isfinite(f_bf16).all():
        raise AssertionError("bf16 encoder output is not finite")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_6(ctx):
    phase("6 RANSAC on ground-truth correspondences, 50% outliers")
    from apr_torch.registration.metrics import registration_errors
    from apr_torch.registration.ransac import ransac_pose

    dev = ctx.dev
    rng = np.random.default_rng(1)
    yaw = 0.4
    t_gt = np.eye(4, dtype=np.float32)
    t_gt[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    t_gt[:3, 3] = [12.0, -7.0, 0.3]
    src = rng.uniform(-40, 40, (SUBSAMPLE, 3)).astype(np.float32)
    src[:, 2] *= 0.1
    tgt = src @ t_gt[:3, :3].T + t_gt[:3, 3]
    tgt += rng.normal(0, 0.02, tgt.shape)
    out = rng.random(SUBSAMPLE) < 0.5
    tgt[out] = rng.uniform(-40, 40, (out.sum(), 3))
    res = ransac_pose(torch.Generator(device=dev).manual_seed(0),
                      torch.from_numpy(src).to(dev),
                      torch.from_numpy(tgt.astype(np.float32)).to(dev),
                      distance_threshold=0.3, num_hypotheses=HYPOTHESES)
    rte, rre = (float(x) for x in registration_errors(
        res.transform, torch.from_numpy(t_gt).to(dev)))
    print(f"  RTE {rte:.4f} m  RRE {rre:.4f} deg  fitness "
          f"{float(res.fitness):.3f}")
    if not (rte < 0.05 and rre < 0.5):
        raise AssertionError("RANSAC missed the ground-truth pose")


def phase_7(ctx):
    t = phase("7 slice: FeatureTester.test, 8 pairs, ResUNetFatBN-128 bf16")
    from apr_torch.ops.searchsorted import searchsorted_left

    dev, pairs, tester = ctx.dev, ctx.pairs, ctx.tester
    trainer = tester.trainer
    searchsorted_left.launches = 0
    t_main = time.perf_counter()
    stats = tester.test(pairs, seed=0)
    main_s = time.perf_counter() - t_main
    launches = searchsorted_left.launches
    ctx.k1_launches["eval"] = launches
    summ = stats.summary()
    ctx.pairs_per_s[0] = summ["pairs_per_sec"]
    print(f"  pairs/s {summ['pairs_per_sec']:.3f} (pairs 2-8, pipelined; "
          f"{main_s:.2f} s for all 8 with the first pair's warm-up)")
    print(f"  recall {summ['recall']:.3f} (random weights: not asserted)")
    print(f"  RTE {['%.2f' % x for x in stats.rte]}")
    print(f"  RRE {['%.2f' % x for x in stats.rre]}")
    print(f"  K1 launches during the run: {launches} for {len(pairs)} "
          f"batch builds")
    if launches != len(pairs):
        raise AssertionError("the slice did not run each batch build's "
                             "kernel maps through one K1 launch")
    if not (np.isfinite(stats.rte).all() and np.isfinite(stats.rre).all()
            and np.isfinite(stats.fitness).all()):
        raise AssertionError("non-finite RTE/RRE/fitness")

    gen = torch.Generator(device=dev).manual_seed(1)
    x, _ = stage_split(dict(
        build=lambda _: tester._pair_to_batch(pairs[0]),
        encode=lambda b: (b, trainer._encode_pair(b)),
        eval=lambda bf: tester.eval_one(
            bf[1][0][0], bf[1][1][0], bf[0].xyz0[0], bf[0].xyz1[0],
            bf[0].pyramid0.levels[0].mask[0],
            bf[0].pyramid1.levels[0].mask[0], bf[0].t_gt[0], gen)),
        inference=True, unit="pair")
    if not all(bool(torch.isfinite(v).all()) for v in x):
        raise AssertionError("non-finite raw outputs of one pair")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_8(ctx):
    t = phase("8 K1 at the main path's shapes (one batch build, B=2)")
    batch = ctx.tester._pair_to_batch(ctx.pairs[0])
    both = tree_map(lambda a, b: torch.cat([a, b]), batch.pyramid0.levels,
                    batch.pyramid1.levels)
    ctx.k1_time = time_searches(searches_of(both, 5), baseline=ctx.baseline)
    ctx.k1_err = max(ctx.k1_err, ctx.k1_time["max_abs_err"])
    print("  (the record's times are those of these 7 searches)")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_9(ctx):
    t = phase("9 K2 contract cases (kernel vs plain, d2 bit for bit, idx "
              "exact)")
    dev = ctx.dev
    for name, q, s, m, qm in k2_contract_cases():
        qm_t = None if qm is None else torch.from_numpy(qm).to(dev)
        d2, idx, err = k2_check(
            *(torch.from_numpy(x).to(dev) for x in (q, s, m)), qm_t, name)
        ctx.k2_err = max(ctx.k2_err, err)
        none = torch.from_numpy(~m.any(1)).to(dev)
        if (bool((idx[none] != s.shape[1]).any())
                or not bool(torch.isinf(d2[none]).all())):
            raise AssertionError(f"K2 on {name}: a query with no valid "
                                 f"support must get (inf, Ns)")
        print(f"  {name}: B={q.shape[0]} Nq={q.shape[1]} Ns={s.shape[1]} "
              f"valid queries {'all' if qm is None else qm.sum(1).tolist()} "
              f"supports {m.sum(1).tolist()} exact")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_10(ctx):
    t = phase("10 training slice: FCGFTrainer.train_step, ResUNetFatBN-128 "
              "bf16, B=4, chamfer_mode=pallas")
    from dataclasses import replace

    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.searchsorted import searchsorted_left

    dev, raws, trainer_t = ctx.dev, ctx.raws, ctx.train_trainer
    cfg_t = trainer_t.config
    print(f"  {cfg_t.trainer} {cfg_t.model}-{cfg_t.model_n_out} conv1 "
          f"{cfg_t.conv1_kernel_size}^3 {cfg_t.compute_dtype} B="
          f"{cfg_t.batch_size} caps {cfg_t.capacities} points "
          f"{cfg_t.point_capacity} APC {cfg_t.apc_capacity} "
          f"{cfg_t.generator_model} ratio {cfg_t.point_generation_ratio} "
          f"{cfg_t.optimizer} lr {cfg_t.lr} momentum {cfg_t.sgd_momentum} "
          f"wd {cfg_t.weight_decay} chamfer {cfg_t.chamfer_mode}")
    b_t = cfg_t.batch_size
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    searchsorted_left.launches = 0
    nn_min.launches = 0
    step_s, step_metrics, positives = [], [], []
    for k in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_t = trainer_t.build_batch(raws[k % 2])
        metrics = trainer_t.train_step(batch_t, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_metrics.append({n: float(v) for n, v in metrics.items()})
        positives.append(int(batch_t.pos_mask.sum()))
    k1_train, k2_train = searchsorted_left.launches, nn_min.launches
    ctx.k1_launches["train"], ctx.k2_launches["train"] = k1_train, k2_train
    for k, (sec, m, n_pos) in enumerate(zip(step_s, step_metrics,
                                            positives)):
        print(f"  step {k}: {sec * 1e3:9.1f} ms  positives {n_pos}  " +
              "  ".join(f"{n} {v:.6g}" for n, v in m.items()))
    steps_per_s = (TRAIN_STEPS - 1) / sum(step_s[1:])
    print(f"  steps/s {steps_per_s:.3f}  pairs/s {steps_per_s * b_t:.3f} "
          f"(build + step, synchronised, steps 2-{TRAIN_STEPS})  peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    print(f"  K1 launches {k1_train} ({k1_train / TRAIN_STEPS:.0f} per "
          f"step: one batch build), K2 launches {k2_train} "
          f"({k2_train / TRAIN_STEPS:.0f} per step)")
    if not all(np.isfinite(v) for m in step_metrics for v in m.values()):
        raise AssertionError("a train step gave a non-finite loss term")
    if any(m["skipped_nonfinite"] != 0.0 for m in step_metrics):
        raise AssertionError("a train step was skipped as non-finite")
    if min(positives) <= 0:
        raise AssertionError("a training batch has no GT positive pair")
    if k2_train != 4 * TRAIN_STEPS:
        raise AssertionError(f"K2 launched {k2_train} times in "
                             f"{TRAIN_STEPS} steps; the pallas Chamfer "
                             f"takes 4 per step (2 sides x 2 directions)")
    if k1_train != TRAIN_STEPS:
        raise AssertionError(f"K1 launched {k1_train} times in "
                             f"{TRAIN_STEPS} batch builds; each build's "
                             f"kernel maps take one grouped launch")

    # one step by stage, synchronised at each boundary: wall time (second
    # repetition), then a profiled repetition for busy time and launches
    def forward(batch):
        trainer_t.optimizer.zero_grad(set_to_none=False)
        return trainer_t.loss_fn(batch, gen, train=True)

    _, ctx.splits["fcgf"] = stage_split(dict(
        build=lambda _: trainer_t.build_batch(raws[0]), forward=forward,
        backward=lambda out: out[0].backward(),
        optimizer=lambda _: trainer_t.optimizer.step()))

    cfg_w = replace(cfg_t, chamfer_mode="window")
    trainer_t.config = cfg_w
    nn_min.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = {n: float(v) for n, v in trainer_t.train_step(
        trainer_t.build_batch(raws[1]), gen).items()}
    torch.cuda.synchronize()
    print(f"  window-mode step: {(time.perf_counter() - t0) * 1e3:.1f} ms  "
          + "  ".join(f"{n} {v:.6g}" for n, v in metrics.items()))
    if not (all(np.isfinite(v) for v in metrics.values())
            and metrics["skipped_nonfinite"] == 0.0):
        raise AssertionError("the window-mode step failed")
    if nn_min.launches != 0:
        raise AssertionError("window mode launched K2")
    trainer_t.config = cfg_t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    valid = {n: float(v) for n, v in trainer_t.valid_step(
        trainer_t.build_batch(raws[0]), gen).items()}
    torch.cuda.synchronize()
    print(f"  valid_step: {(time.perf_counter() - t0) * 1e3:.1f} ms  "
          + "  ".join(f"{n} {v:.6g}" for n, v in valid.items()))
    if not all(np.isfinite(v) for v in valid.values()):
        raise AssertionError("valid_step gave a non-finite metric")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_11(ctx):
    t = phase("11 K2 at the train step's shapes (the 4 launches of a step)")
    trainer_t = ctx.train_trainer
    k2_rows = time_k2(k2_inputs(trainer_t,
                                trainer_t.build_batch(ctx.raws[0])))
    ctx.k2_err = max([ctx.k2_err] + [r["max_abs_err"] for r in k2_rows])
    k2_step = ctx.k2_time = per_step(k2_rows)
    print(f"  per step: nn_min {k2_step['ms']:.3f} ms (partition "
          f"{k2_step['partition_ms']:.3f} ms, kernel "
          f"{k2_step['kernel_ms']:.3f} ms)  plain "
          f"{k2_step['plain_ms']:.3f} ms  cdist+min "
          f"{k2_step['library_ms']:.3f} ms  bound "
          f"{k2_step['bound_ms']:.3f} ms: nn_min reaches "
          f"{k2_step['bound_ms'] / k2_step['ms']:.2f} of the bound, the "
          f"kernel alone {k2_step['bound_ms'] / k2_step['kernel_ms']:.2f}")
    print(f"  per step, the 8 partitions alone: partition "
          f"{k2_step['scan_ms'] * 1e3:.1f} us, stable argsort "
          f"{k2_step['sort_ms'] * 1e3:.1f} us")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_12(ctx):
    t = phase("12 train step, card vs CPU (float32, small, same weights and "
              "samples)")
    compare_train_step(ctx.dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_13(ctx):
    t = phase("13 KP neighbours at full capacity, card vs CPU; kernel K3 "
              "against the plain chain")
    ctx.k3_time = kp_neighbour_phase(ctx.dev, ctx.kp_pairs[0])
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_14(ctx):
    t = phase("14 KPFCNN forward at full width, card vs CPU (float32) and "
              "bf16")
    kp_forward_phase(ctx.dev, ctx.kp_pairs[0])
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_15(ctx):
    t = phase(f"15 Predator slice: PredatorTester.test, {N_PAIRS} pairs, "
              f"KPFCNN-256 bf16")
    ctx.pairs_per_s[1] = predator_slice_phase(ctx.dev, ctx.kp_pairs)
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_16(ctx):
    t = phase("16 Predator training slice: PredatorTrainer.train_step, "
              "kitti.yaml at full width, chamfer_mode=pallas, and the step "
              "twice bit for bit")
    k2_pt, k2_pt_rows, ctx.splits["predator"] = predator_train_phase(
        ctx.dev)
    ctx.k1_launches["predator_train"] = 0
    ctx.k2_launches["predator_train"] = k2_pt
    ctx.k2_err = max([ctx.k2_err] + [r["max_abs_err"] for r in k2_pt_rows])
    pt_step = ctx.pt_step = per_step(k2_pt_rows)
    print(f"  per step: nn_min {pt_step['ms']:.3f} ms (kernel "
          f"{pt_step['kernel_ms']:.3f} ms)  plain {pt_step['plain_ms']:.3f} "
          f"ms  cdist+min {pt_step['library_ms']:.3f} ms  bound "
          f"{pt_step['bound_ms']:.3f} ms: nn_min reaches "
          f"{pt_step['bound_ms'] / pt_step['ms']:.2f} of the bound")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_17(ctx):
    t = phase("17 Predator train step, card vs CPU (float32, small, same "
              "weights and draws)")
    compare_predator_step(ctx.dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_18(ctx):
    t = phase("18 FCGF training loop through the CLI (python -m "
              "apr_torch.train), resume, iter_size=2, symmetric")
    ctx.k1_launches["fcgf_loop"], ctx.k2_launches["fcgf_loop"] = \
        fcgf_loop_phase(ctx.dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_19(ctx):
    t = phase("19 Predator training loop through the YAML entry (python -m "
              "apr_torch.main configs/train/kitti.yaml), test mode, "
              "iter_size=2")
    ctx.k1_launches["predator_loop"], ctx.k2_launches["predator_loop"] = \
        predator_loop_phase(ctx.dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_20(ctx):
    t = phase("20 the real-data path: a KITTI-format tree, FCGF training "
              "and both eval scripts, Predator kitti.yaml train and test, "
              "the .pth import")
    real = real_data_phase(ctx.dev)
    for path in ("real_fcgf", "real_predator"):
        ctx.k1_launches[path], ctx.k2_launches[path] = real[path]
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_21(ctx):
    t = phase("21 the odometry-pose GT path: prepare_icp_cache on the card, "
              "ICP card vs CPU and vs cKDTree, the cache in use")
    icp = icp_cache_phase(ctx.dev)
    ctx.k1_launches["icp_fcgf"], ctx.k2_launches["icp_fcgf"] = \
        icp["icp_loop"]
    ctx.k1_launches["extract_features"] = icp["extract_features"]
    ctx.k2_launches["icp"] = icp["icp"]
    ctx.k2_launches["cal_overlap"] = icp["cal_overlap"]
    ctx.icp_shape = icp["icp_shape"]
    ctx.k2_err = max(ctx.k2_err, icp["icp_shape"]["max_abs_err"])
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_22(ctx):
    t = phase("22 the multi-device paths: NCCL at world size 1 (FCGF and "
              "Predator steps bit for bit), then two gloo ranks sharing the "
              "card (data-parallel FCGF and Predator steps, test_sharded, "
              "chamfer_sp, the builder / trainer pipeline)")
    dp = multi_rank_phase(ctx.dev, ctx.pairs, ctx.kp_pairs, ctx.raws,
                          tuple(ctx.pairs_per_s))
    for path, (k1, k2) in dp.items():
        ctx.k1_launches[path], ctx.k2_launches[path] = k1, k2
    print(f"  phase {time.perf_counter() - t:.1f} s")


OPS_POINTS = 120000       # phase 23's LiDAR-scale cloud
OPS_VOXEL = 0.3
OPS_CAPACITY = 131072
OPS_FEATURES = 32
BITONIC_BATCH = (8, 32768)  # phase 23: the frame's keys as 8 sorted rows


def phase_23(ctx):
    """A2's segment mean and E1's down-samplers on one LiDAR-scale cloud:
    two card runs bit for bit, the card against the CPU (masks and counts
    exact, floats bit for bit: each voxel's run adds in index order on
    both), and the package recipe."""
    t = phase(f"23 ops: segment_mean_capped, voxel_down_sample, "
              f"grid_subsample and the bitonic network on a "
              f"{OPS_POINTS}-point cloud at {OPS_VOXEL} m, card twice and "
              f"against the CPU; the apr_torch.ops recipe")
    from apr_torch.data.synthetic import synthetic_pair
    from apr_torch.ops import chamfer_distance, grid_subsample, \
        radius_neighbors, segment_mean_capped, voxel_down_sample, voxelize

    dev = ctx.dev
    pair = synthetic_pair(seed=23, n_points=OPS_POINTS, apc_points=4,
                          extent=60.0, distance=10.0)
    rng = np.random.default_rng(23)
    pts_h = torch.from_numpy(pair["points0"])[None]
    feats_h = torch.from_numpy(rng.normal(size=(
        1, pts_h.shape[1], OPS_FEATURES)).astype(np.float32))
    mask_h = torch.from_numpy(rng.random((1, pts_h.shape[1])) > 0.05)
    pts, feats, mask = pts_h.to(dev), feats_h.to(dev), mask_h.to(dev)
    seg_h = voxelize(pts_h, OPS_VOXEL, OPS_CAPACITY, mask_h).point_voxel
    seg = seg_h.to(dev)

    def ops_on(p, f, m, s):
        return (segment_mean_capped(f, s, OPS_CAPACITY),
                *voxel_down_sample(p, OPS_VOXEL, OPS_CAPACITY, m),
                *grid_subsample(p, OPS_VOXEL, OPS_CAPACITY, f, m),
                voxelize(p, OPS_VOXEL, OPS_CAPACITY, m).counts)

    names = ("segment_mean_capped", "voxel_down_sample points",
             "voxel_down_sample mask", "grid_subsample points",
             "grid_subsample features", "grid_subsample mask",
             "voxelize counts")
    first = ops_on(pts, feats, mask, seg)
    again = ops_on(pts, feats, mask, seg)
    cpu = ops_on(pts_h, feats_h, mask_h, seg_h)
    n_vox = int(first[2].sum())
    print(f"  {pts_h.shape[1]} points, {int(mask_h.sum())} valid, {n_vox} "
          f"voxels of {OPS_CAPACITY}, {OPS_FEATURES} features a point")
    for name, a, b, c in zip(names, first, again, cpu):
        twice, vs_cpu = torch.equal(a, b), torch.equal(a.cpu(), c)
        print(f"  {name}: card twice {'bit for bit' if twice else 'DIFFER'}"
              f", card vs CPU {'bit for bit' if vs_cpu else 'DIFFER'}")
        if not (twice and vs_cpu):
            raise AssertionError(f"{name} is not the same bits twice on the "
                                 f"card and on the CPU")
    ms = cuda_ms(lambda: grid_subsample(pts, OPS_VOXEL, OPS_CAPACITY, feats,
                                        mask), reps=10)
    ms_mean = cuda_ms(lambda: segment_mean_capped(feats, seg, OPS_CAPACITY),
                      reps=10)
    print(f"  card: grid_subsample {ms:.3f} ms, segment_mean_capped "
          f"{ms_mean:.3f} ms (mean of 10)")
    bitonic_on_voxel_keys(pts_h, mask_h, dev)

    g0 = voxelize(pts, OPS_VOXEL, OPS_CAPACITY, mask)
    g1 = voxelize(torch.from_numpy(pair["points1"])[None].to(dev), OPS_VOXEL,
                  OPS_CAPACITY)
    nb = radius_neighbors(g0.barycenter, g0.barycenter, 1.0, 16, g0.mask,
                          g0.mask)
    cd = chamfer_distance(g0.barycenter, g1.barycenter, g0.mask, g1.mask)
    found = nb[g0.mask]
    per_voxel = float((found < OPS_CAPACITY).sum(1).float().mean())
    print(f"  recipe (voxelize, radius_neighbors, chamfer_distance from "
          f"apr_torch.ops): {per_voxel:.1f} neighbours a voxel within 1 m, "
          f"Chamfer {float(cd[0]):.4f} m^2")
    if not (bool((found[:, 0] < OPS_CAPACITY).all())
            and bool(torch.isfinite(cd).all())):
        raise AssertionError("the ops recipe failed")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def bitonic_on_voxel_keys(pts_h, mask_h, dev):
    """E4's bitonic network on the frame's voxel keys with an INVALID
    tail: bitonic_sort and bitonic_argsort over one row of OPS_CAPACITY
    and over BITONIC_BATCH rows (profile_sort's batched shape), twice on
    the card bit for bit, equal to the CPU's, keys equal to
    torch.sort's."""
    from apr_torch.ops.hashing import INVALID_KEY
    from apr_torch.ops.sort import bitonic_argsort, bitonic_sort
    from apr_torch.ops.voxelize import _voxel_keys

    k = _voxel_keys(pts_h, OPS_VOXEL, mask_h)[0]
    for shape in ((OPS_CAPACITY,), BITONIC_BATCH):
        x_h = torch.full((int(np.prod(shape)),), INVALID_KEY,
                         dtype=torch.int32)
        x_h[:k.shape[0]] = k
        x_h = x_h.reshape(shape)
        x = x_h.to(dev)
        runs = [(bitonic_sort(x)[0], *bitonic_argsort(x)) for _ in range(2)]
        cpu = (bitonic_sort(x_h)[0], *bitonic_argsort(x_h))
        want = torch.sort(x, dim=-1).values
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        vs_cpu = all(torch.equal(a.cpu(), c) for a, c in zip(runs[0], cpu))
        sorted_ok = (torch.equal(runs[0][0], want)
                     and torch.equal(runs[0][1], want)
                     and torch.equal(torch.gather(x, -1, runs[0][2].long()),
                                     want))
        ms = cuda_ms(lambda: bitonic_argsort(x), reps=3)
        print(f"  bitonic_sort / bitonic_argsort {list(shape)} "
              f"({int((x_h != INVALID_KEY).sum())} keys): card twice "
              f"{'bit for bit' if same else 'DIFFER'}, card vs CPU "
              f"{'bit for bit' if vs_cpu else 'DIFFER'}, keys "
              f"{'equal' if sorted_ok else 'NOT equal'} to torch.sort's; "
              f"argsort {ms:.3f} ms on the card")
        if not (same and vs_cpu and sorted_ok):
            raise AssertionError(f"the bitonic network on {list(shape)} "
                                 f"voxel keys failed")


def run_tool(module, argv, log=None):
    """``python -m apr_torch.tools.<module> argv`` in this process (so the
    kernels' launches are counted), the standard output also written to
    ``log``; returns (main's result, K1 launches, K2 launches)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"apr_torch.tools.{module}")
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return sys.__stdout__.write("    " + s if s.strip() else s)

    with Counted() as n, contextlib.redirect_stdout(Tee()):
        out = mod.main(argv)
    if log is not None:
        with open(log, "w") as f:
            f.write(buf.getvalue())
    return out, n.k1, n.k2


def phase_24(ctx):
    """E2's tools at short settings through their mains, with the kernels'
    launches asserted: one K1 launch a batch build, four K2 a step with
    the pallas Chamfer, none on the Predator tool."""
    t = phase("24 the synthetic-convergence tools at short settings "
              "(validate_convergence, validate_predator_convergence, "
              "validate_apr_gain + pool_apr_gain, sweep_ransac)")
    import tempfile

    steps, pairs = 8, 2
    on = ["--device", ctx.dev.type]
    for chamfer in (None, "pallas"):
        argv = on + ["--steps", str(steps), "--eval_pairs", str(pairs)]
        if chamfer:
            argv += ["--chamfer", chamfer]
        t0 = time.perf_counter()
        s, k1, k2 = run_tool("validate_convergence", argv)
        path = f"validate_convergence{'_' + chamfer if chamfer else ''}"
        ctx.k1_launches[path], ctx.k2_launches[path] = k1, k2
        print(f"  validate_convergence {' '.join(argv[2:])}: "
              f"{time.perf_counter() - t0:.1f} s, recall {s['recall']:.3f} "
              f"(8 steps: not asserted), K1 {k1} (4 train + {pairs} eval "
              f"builds), K2 {k2}")
        if k1 != 4 + pairs or k2 != (4 * steps if chamfer else 0):
            raise AssertionError(f"validate_convergence launched K1 {k1} / "
                                 f"K2 {k2} times")
    t0 = time.perf_counter()
    res, k1, k2 = run_tool("validate_predator_convergence",
                           on + ["--steps", "4", "--eval_pairs", str(pairs)])
    ctx.k1_launches["validate_predator"] = k1
    ctx.k2_launches["validate_predator"] = k2
    k3_take("validate_predator")
    print(f"  validate_predator_convergence --steps 4: "
          f"{time.perf_counter() - t0:.1f} s, recall {res['recall']:.3f}, "
          f"K1 {k1}, K2 {k2} (the tool's window Chamfer)")
    if k1 != 0 or k2 != 0:
        raise AssertionError("the Predator tool launched K1 or K2")
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "gain.log")
        argv = on + ["--steps", "4", "--seeds", "1", "--seed0", "2",
                "--pool_pairs", "4", "--eval_pairs", str(pairs)]
        t0 = time.perf_counter()
        lines, k1, k2 = run_tool("validate_apr_gain", argv, log)
        ctx.k1_launches["validate_apr_gain"] = k1
        ctx.k2_launches["validate_apr_gain"] = k2
        builds = 2 * (4 // 2 + 4 * pairs)
        print(f"  validate_apr_gain {' '.join(argv[2:])}: "
              f"{time.perf_counter() - t0:.1f} s, K1 {k1} ({builds} batch "
              f"builds over both arms), K2 {k2}")
        if k1 != builds or len(lines) != 4:
            raise AssertionError("validate_apr_gain: wrong launches or "
                                 "PAIRED lines")
        pooled, _, _ = run_tool("pool_apr_gain", [log])
        if len(pooled) != 4:
            raise AssertionError("pool_apr_gain did not pool the log")
    t0 = time.perf_counter()
    table, k1, k2 = run_tool("sweep_ransac", on + [
        "--pairs", "4", "--ratios", "0.05", "--hyps", "32768",
        "--esc_rungs", "2"])
    print(f"  sweep_ransac --pairs 4 --ratios 0.05: "
          f"{time.perf_counter() - t0:.1f} s, recall by column "
          f"{table[0.05]}")
    print(f"  phase {time.perf_counter() - t:.1f} s")


def phase_25(ctx):
    """E3: the host C++ library, built with g++ from apr_torch/csrc at
    first use, against its numpy fallbacks on a LiDAR-scale cloud."""
    t = phase("25 apr_torch.native: the compiled host library against its "
              "numpy fallbacks")
    from apr_torch import native
    from apr_torch.data.synthetic import synthetic_pair

    t0 = time.perf_counter()
    lib = native.get_lib()
    path = native.lib_path()
    print(f"  library {os.path.relpath(path, HERE)} "
          f"({time.perf_counter() - t0:.1f} s to build and load)")
    if lib is None or not path.is_file():
        raise AssertionError("apr_torch.native did not build its library")
    pts = synthetic_pair(seed=25, n_points=OPS_POINTS, apc_points=4,
                         extent=60.0, distance=10.0)["points0"]
    feats = np.random.default_rng(25).normal(size=(len(pts), 8)).astype(
        np.float32)

    def lexicographic(p, f):
        order = np.lexsort(np.floor(p / OPS_VOXEL).T[::-1])
        return p[order], f[order]

    t0 = time.perf_counter()
    got = native.grid_subsample(pts, OPS_VOXEL, None, feats)
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = native.grid_subsample_numpy(pts, OPS_VOXEL, len(pts), feats)
    np_s = time.perf_counter() - t0
    got_l, want_l = lexicographic(*got), lexicographic(*want)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    sel = native.voxel_dedup(pts, OPS_VOXEL)
    np.testing.assert_array_equal(sel, native.voxel_dedup_numpy(
        pts, OPS_VOXEL, len(pts)))
    q = pts[::60]
    nb = native.radius_neighbors(q, pts, 1.0, 16)
    nb_np = native.radius_neighbors_numpy(q, pts, 1.0, 16)
    rows = np.flatnonzero((nb != nb_np).any(1))
    for i in rows:      # near-ties only: the same distances within 1e-5
        d = [np.sort(np.linalg.norm(pts[r[r < len(pts)]] - q[i], axis=1))
             for r in (nb[i], nb_np[i])]
        np.testing.assert_allclose(d[0], d[1], atol=1e-5)
    print(f"  grid_subsample: {len(got[0])} voxels, library {lib_s:.3f} s "
          f"vs numpy {np_s:.3f} s, equal within 1e-6; voxel_dedup "
          f"{len(sel)} exact; radius_neighbors {len(q)} queries, "
          f"{len(rows)} rows differ by near-ties only")
    print(f"  phase {time.perf_counter() - t:.1f} s")


PROFILER_K = 2          # phase 26: iterations of each profiler stage
# phase 26: |tool / phase - 1| of a step's card busy ms, the tools' against
# the stage splits of phases 10 and 16.  Busy, not wall: the Predator step
# is host-launch bound, and its wall moved from 239 to 365 ms a step
# between two runs at the same 160 ms busy (one H100 80GB HBM3, 700 W)
READS_ALIKE = 0.2
# K1 / K2 launches of one profiled iteration of each stage phase 26
# asserts (every other stage of the seven tools launches neither)
PROFILER_LAUNCHES = {
    "profile_build": {"full build": (1, 0),
                      "build w/o GT correspondences": (1, 0),
                      "pyramids+maps only (2B fold)": (1, 0)},
    "profile_pyramid": {"voxelize + build_pyramid x8": (1, 0),
                        "voxelize + conv1 map z-run x8": (1, 0),
                        "levels + pyramid_searches + grouped K1 x8": (1, 0),
                        "levels + searches + K1 + zrun_decode x8": (1, 0)},
    "profile_train_step": {"full train_step": (0, 4),
                           "sustained (batch build + step)": (1, 4),
                           "chamfer fwd+bwd 8x [pallas]": (0, 2)},
    "profile_predator_sustained at phase 16's config": {
        "train step (batch prebuilt)": (0, 4),
        "sustained (build + step)": (0, 4)},
}


def phase_26(ctx):
    """The seven profilers through their mains at their defaults with
    PROFILER_K iterations a stage (profile_train_step with the pallas
    Chamfer and the sustained stage), then profile_predator_sustained at
    phase 16's config: every stage line printed, K1 / K2 launches per
    iteration as PROFILER_LAUNCHES says, and the tools' step times within
    READS_ALIKE of phases 10 and 16's stage splits in card busy ms."""
    t = phase("26 profilers: profile_build, profile_pyramid, "
              "profile_train_step, profile_predator, "
              "profile_predator_sustained, profile_sort, "
              "probe_radius_select")
    import tempfile

    from apr_torch.tools import profile_predator_sustained, profile_pyramid

    k = str(PROFILER_K)
    on = ["--device", ctx.dev.type]
    card = device_line(ctx.dev)       # every tool's header names the card
    runs = [
        ("profile_build", ["--k", k]),
        ("profile_pyramid", []),
        ("profile_train_step", ["--k", k, "--chamfer", "pallas", "--only",
                                "step,sustained,nogen,fwd,fwd2x,chamfer"]),
        ("profile_predator", ["--iters", k]),
        ("profile_predator_sustained", ["--k", k]),
        ("profile_sort", ["--k", k]),
        ("probe_radius_select", ["--iters", k]),
        ("profile_predator_sustained at phase 16's config",
         ["--k", k, "--points", str(PT_PAIR["n_points"]), "--apc",
          str(PT_FIELDS["apc_capacity"])]),
    ]
    saved = (profile_pyramid.K, profile_predator_sustained.CONFIG,
             profile_predator_sustained.PAIR)
    rows_of, k1_all, k2_all = {}, 0, 0
    try:
        profile_pyramid.K = PROFILER_K
        with tempfile.TemporaryDirectory() as tmp:
            for name, argv in runs:
                module = name.split()[0]
                if name != module:
                    profile_predator_sustained.CONFIG = {
                        f: v for f, v in PT_FIELDS.items()
                        if f != "apc_capacity"}
                    profile_predator_sustained.PAIR = dict(
                        seed=300, distance=PT_PAIR["distance"],
                        extent=PT_PAIR["extent"],
                        apc_points=PT_PAIR["apc_points"])
                log = os.path.join(tmp, module + ".log")
                t0 = time.perf_counter()
                rows, k1, k2 = run_tool(module, argv + on, log)
                k1_all, k2_all = k1_all + k1, k2_all + k2
                if module.startswith("profile_predator"):
                    k3_take("profilers")
                with open(log) as f:
                    text = f.read()
                missing = [r.label for r in rows if r.label not in text]
                print(f"  {name}: {time.perf_counter() - t0:.1f} s, "
                      f"{len(rows)} stages, K1 {k1}, K2 {k2} in all")
                if not rows or missing or card not in text:
                    raise AssertionError(f"{name}: no stage lines or no "
                                         f"card line ({missing})")
                want = PROFILER_LAUNCHES.get(name, {})
                for r in rows:
                    if (r.k1, r.k2) != want.get(r.label, (0, 0)):
                        raise AssertionError(
                            f"{name} [{r.label}]: K1 {r.k1} / K2 {r.k2} in "
                            f"one iteration, want "
                            f"{want.get(r.label, (0, 0))}")
                if set(want) - {r.label for r in rows}:
                    raise AssertionError(f"{name}: stages missing: "
                                         f"{set(want) - {r.label for r in rows}}")
                rows_of[name] = {r.label: r for r in rows}
    finally:
        (profile_pyramid.K, profile_predator_sustained.CONFIG,
         profile_predator_sustained.PAIR) = saved
    ctx.k1_launches["profilers"] = k1_all
    ctx.k2_launches["profilers"] = k2_all

    step_of = (("forward", "backward", "optimizer"),
               ("build", "forward", "backward", "optimizer"))
    checks = [("fcgf", "profile_train_step", "full train_step", 0, 10),
              ("fcgf", "profile_train_step", "sustained (batch build + step)",
               1, 10),
              ("predator", "profile_predator_sustained at phase 16's config",
               "train step (batch prebuilt)", 0, 16),
              ("predator", "profile_predator_sustained at phase 16's config",
               "sustained (build + step)", 1, 16)]
    for path, name, label, with_build, pid in checks:
        if path not in ctx.splits:
            print(f"  {name} [{label}]: not compared (phase {pid} not "
                  f"selected)")
            continue
        row, split = rows_of[name][label], ctx.splits[path]
        busy = sum(split[stage][1] for stage in step_of[with_build])
        wall = sum(split[stage][0] for stage in step_of[with_build])
        print(f"  reads alike: {name} [{label}] busy {row.busy_ms:.1f} ms "
              f"against phase {pid}'s stage split {busy:.1f} ms "
              f"({row.busy_ms / busy - 1:+.1%}, bound +-{READS_ALIKE:.0%}); "
              f"wall {row.wall_ms:.1f} against {wall:.1f} ms "
              f"({row.wall_ms / wall - 1:+.1%}, not bounded)")
        if abs(row.busy_ms / busy - 1) > READS_ALIKE:
            raise AssertionError(f"{name} [{label}] does not read alike "
                                 f"with phase {pid}")
    print(f"  phase {time.perf_counter() - t:.1f} s")


PHASES = [("1", phase_1), ("2", phase_2), ("3a", phase_3a),
          ("3b", phase_3b), ("4", phase_4), ("5", phase_5), ("6", phase_6),
          ("7", phase_7), ("8", phase_8), ("9", phase_9), ("10", phase_10),
          ("11", phase_11), ("12", phase_12), ("13", phase_13),
          ("14", phase_14), ("15", phase_15), ("16", phase_16),
          ("17", phase_17), ("18", phase_18), ("19", phase_19),
          ("20", phase_20), ("21", phase_21), ("22", phase_22),
          ("23", phase_23), ("24", phase_24), ("25", phase_25),
          ("26", phase_26)]


def selected_phases(spec):
    """The phase ids a ``--phases`` value names: comma-separated numbers
    or ranges ("3-5,16"); a number names all its lettered phases ("3" is
    3a and 3b).  Phases 1 and 2 (the device, the build) always run."""
    if spec is None:
        return [pid for pid, _ in PHASES]
    nums = set()
    for item in spec.split(","):
        lo, _, hi = item.strip().partition("-")
        nums.update(range(int(lo), int(hi or lo) + 1))
    chosen = [pid for pid, _ in PHASES
              if pid in ("1", "2") or int(pid.rstrip("ab")) in nums]
    if len(chosen) == 2 and not nums & {1, 2}:
        raise SystemExit(f"chip_smoke.py: --phases {spec!r} names no phase")
    return chosen


def kernel_record(ctx):
    """The kernels' JSON record: launches by path from this run (K3's: the
    Predator paths' main runs in phases 15, 16, 19, 20, 22, 24 and 26),
    the timings of phases 8 (K1), 11 (K2), 16 and 21, and 13 (K3: the
    searches of one predator-apr.train build) where they ran."""
    def timing(t, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
        return {k: (t[k] if t else None) for k in keys}

    return {"kernels": [
        dict(K1, route="cuda", launches=sum(ctx.k1_launches.values()),
             launches_by_path=dict(ctx.k1_launches), max_abs_err=ctx.k1_err,
             **timing(ctx.k1_time), bound_by="bytes"),
        dict(K2, route="cuda", launches=sum(ctx.k2_launches.values()),
             launches_by_path=dict(ctx.k2_launches), max_abs_err=ctx.k2_err,
             **timing(ctx.k2_time), bound_by="operations",
             predator_train=timing(ctx.pt_step),
             icp=timing(ctx.icp_shape, ("ms", "plain_ms", "bound_ms",
                                        "ckdtree_query_ms"))),
        dict(K3, route="cuda", launches=sum(K3_LAUNCHES.values()),
             launches_by_path=dict(K3_LAUNCHES),
             **timing(ctx.k3_time, ("ms", "plain_ms", "bound_ms")),
             bound_by="operations"),
    ]}


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", metavar="LIST",
                    help="run only these phases (and 1, 2): numbers or "
                         "ranges, comma-separated, e.g. 16,22-25; default "
                         "every phase")
    ap.add_argument("--k1-baseline", metavar="DIR",
                    help="another checkout of this repo whose K1 (wrapper "
                         "and kernel source) phases 3b and 8 time beside "
                         "this one's")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "apr_torch")):
        sys.exit("chip_smoke.py: apr_torch/ not found next to this script; "
                 "run it from the root of a checkout")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this script runs on the "
                 "card only")
    chosen = selected_phases(args.phases)
    t_all = time.perf_counter()
    ctx = Shared(torch.device(DEVICE), args)
    for pid, fn in PHASES:
        if pid in chosen:
            fn(ctx)

    print("(K1's times: the 7 searches of one eval batch build, one grouped "
          "launch; K2's: the 4 nn_min calls of one FCGF train step, "
          "partitions included, under predator_train those of one "
          "Predator train step, under icp one ICP search of phase 21; K3's: "
          "the searches of one predator-apr.train build; the "
          "launches of dp_fcgf, dp_predator, sharded_eval and pipeline are "
          "summed over phase 22's two ranks; null: the phase that times it "
          "was not selected)")
    print(f"phases {','.join(chosen)}: total "
          f"{time.perf_counter() - t_all:.1f} s")
    print(ctx.smi)
    print(json.dumps(kernel_record(ctx)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
