#!/usr/bin/env python3
"""Drive the apr_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card
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
   every search of the build (the windowed search with each selector, the
   brute-force radius search, the 1-NN) from the same barycenters on both,
   held exact, with each search's device time;
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
   train_step_batched_fused at B = 2 (8 K2 launches); then K2 at this
   step's shapes against its plain version (exact), timed against its
   bound;
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
   ResUNetFatBN-128 .pth state_dict imported, its encoder card vs CPU.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# the main path at full width (the sizes of bench.py's FCGF eval)
DEVICE = "cuda"
CAPS = (16384, 8192, 4096, 2048)
POINT_CAPACITY = 32768
N_POINTS = 30000
N_PAIRS = 8
SUBSAMPLE = 5000
HYPOTHESES = 32768
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
SM_HZ = 1.98e9                   # H100 SXM boost clock: cycles of a sleep
# H100 SXM float32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two operations, so 3.35e13 instructions a second; K2's
# subtractions, products and sums cannot fuse and count one each
FP32_OPS_PER_S = 3.35e13
K2_OPS_PER_PAIR = 8              # 3 subtractions, 3 products, 2 sums
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


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def host_ms(fn, reps=20, rounds=5):
    """Host time to enqueue one call of ``fn``: the least over ``rounds``
    of the mean over ``reps`` calls (no synchronisation inside a round).
    The least, because the host's cores are shared and other work only
    adds to a round."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
    torch.cuda.synchronize()
    return best


def cuda_ms(fn, reps, warmup=True):
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up
    (skipped for a call that takes seconds and needs none).  A sleep kernel
    holds the card while the host enqueues the launches, so calls whose
    device time is shorter than their host time are timed back to back on
    the device and not at the host's pace."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if warmup:
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(1.5 * reps * enqueue_s, 2.0) * SM_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tree_map(fn, *trees):
    """``fn`` leafwise over tensors in nested tuples / NamedTuples."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    items = [tree_map(fn, *xs) for xs in zip(*trees)]
    return (type(trees[0])(*items) if hasattr(trees[0], "_fields")
            else tuple(items))


def profiled(fn, x, inference=True):
    """Run ``fn(x)`` under torch.profiler; returns (result, card busy ms,
    kernel count, the three longest kernels by total time).  Busy time is
    the sum of the device activities' durations (one stream: they do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode(inference):
            out = fn(x)
        torch.cuda.synchronize()
    # the optimizer's step and zero_grad also leave device-side user
    # annotations: ranges, not kernels
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    per_name = {}
    for e in dev_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
    busy = sum(per_name.values()) / 1e3
    return out, busy, len(dev_events), "; ".join(
        f"{n[:48]} {us / 1e3:.2f} ms" for n, us in top)


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


def kp_neighbour_phase(dev, pair):
    """Phase 13: one pair's KP pyramid built twice on the card and once on
    the CPU from the raw points, every field held bit for bit (two card
    builds, card vs CPU), then every search of the build from the SAME
    barycenters (the card's) on both sides, held exact, with each search's
    device time."""
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import pad_points
    from apr_torch.models.kpconv import KPLevel, build_kp_pyramid
    from apr_torch.ops.neighbors import knn, radius_neighbors, \
        windowed_radius_neighbors

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

    # every search of the build from the card's barycenters on both sides
    lv = [(lvl.points, lvl.mask) for lvl in pyr_gpu.levels]
    r0 = c.first_subsampling_dl * c.conv_radius
    cap = c.neighborhood_limits[0]

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
    ]
    for name, fn in searches:
        got, want = fn(dev).cpu(), fn("cpu")
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the card's table differs from "
                                 f"the CPU's from the same barycenters in "
                                 f"{int((got != want).sum())} entries")
        print(f"  {name:28s} {tuple(got.shape)} exact card vs CPU; device "
              f"time {cuda_ms(lambda: fn(dev), 3):8.3f} ms")
    build_ms = cuda_ms(lambda: build_kp_pyramid(pts.to(dev), msk.to(dev),
                                                **kw), 3)
    print(f"  whole pyramid build (two clouds, one host sync for the "
          f"overflow flags): {build_ms:.3f} ms a build")


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
    fb0 = build_kp_pyramid.fallbacks
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = tester.test(pairs, seed=0)
    main_s = time.perf_counter() - t0
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
    x = stage_split(dict(
        build=lambda _: tester._pair_to_batch(pairs[0]),
        forward=lambda b: (b, tester.forward(b)),
        eval=lambda bo: tester.eval_one(bo[1], bo[0], gen)),
        inference=True, unit="pair")
    if not all(bool(torch.isfinite(v).all()) for v in x):
        raise AssertionError("non-finite raw outputs of one pair")


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


def stage_split(stages, inference=False, unit="step"):
    """One ``unit`` (a step, a pair) by stage, each stage synchronised at
    its boundaries: host-clock wall (second repetition), then a profiled
    repetition for the card's busy time, its kernel launches and the top
    kernels.  Each stage takes the previous one's result; returns the
    last."""
    wall = {}
    for rep in range(3):
        x = None
        for name, fn in stages.items():
            if rep < 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode(inference):
                    x = fn(x)
                torch.cuda.synchronize()
                wall[name] = (time.perf_counter() - t0) * 1e3
            else:
                x, busy, n_kern, top = profiled(fn, x, inference)
                print(f"  {name:9s} wall {wall[name]:8.2f} ms  card busy "
                      f"{busy:8.2f} ms (idle share "
                      f"{1 - busy / wall[name]:.2f})  kernels {n_kern}  "
                      f"top: {top}")
    print(f"  {unit} total {sum(wall.values()):.2f} ms (wall, synchronised "
          f"per stage; busy and launches from a separate profiled run)")
    return x


def predator_train_phase(dev):
    """Phase 16: PredatorTrainer.train_step at configs/train/kitti.yaml's
    full width on synthetic pairs (TRAIN_STEPS single-pair steps, w_saliency
    0 then 1), with the K1 / K2 launch counts read around them (0 and 4 per
    step), steps/s, peak memory and a stage split; one step in
    chamfer_mode="window", one valid_step and one train_step_batched_fused
    at B = 2 (8 K2 launches: its pairs run one after another); then K2 at
    this step's shapes, exact against its plain version, timed against
    its bound.  Returns (K2 launches of the single-pair steps, K2's rows)."""
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

    stage_split(dict(build=lambda _: trainer.build_batch(singles[0]),
                     forward=forward,
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

    print("  K2 at this step's shapes (the 4 launches of one step):")
    rows = time_k2(predator_k2_inputs(trainer, trainer.build_batch(
        singles[0])))
    return k2_pt, rows


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
        t0 = time.perf_counter()
        summary = yaml_main(train_yaml, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = searchsorted_left.launches, nn_min.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        searchsorted_left.launches = 0
        nn_min.launches = 0
        t0 = time.perf_counter()
        test = yaml_main(test_yaml, device=DEVICE)
        torch.cuda.synchronize()
        test_wall = time.perf_counter() - t0
        test_k = (searchsorted_left.launches, nn_min.launches)
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
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            undo()
        return dict(summary=out, wall=time.perf_counter() - t0,
                    k1=searchsorted_left.launches, k2=nn_min.launches,
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
        k2 = r["k2"]
        r = counted(lambda: yaml_main(test_yaml, device=DEVICE))
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


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    sys.path.insert(0, HERE)
    t_all = time.perf_counter()
    dev = torch.device(DEVICE)

    phase("1 device")
    import apr_torch  # noqa: F401  (sets the TF32 flags)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the port's float32 paths")

    phase("2 build")
    from apr_torch.kernels.build import BUILD_ROOT, build_all

    secs = build_all()
    print(f"built every kernel in {secs:.1f} s into "
          f"{os.path.relpath(BUILD_ROOT, HERE)}")
    for log in sorted(BUILD_ROOT.glob("*/*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem}: {line.strip()}")
    baseline = None
    if args.k1_baseline:
        baseline = baseline_k1(args.k1_baseline)
        print(f"  baseline K1 built from {args.k1_baseline}")

    phase("3a K1 contract cases (kernel vs plain vs numpy, exact; one by "
          "one, then grouped)")
    from apr_torch.ops.searchsorted import searchsorted_left, \
        searchsorted_left_many, searchsorted_left_plain

    max_err = 0
    cases = [(name, sup, q, torch.from_numpy(sup)[None].to(dev),
              torch.from_numpy(q)[None].to(dev))
             for name, sup, q in contract_cases()]
    grouped = searchsorted_left_many([(s_t, q_t) for *_, s_t, q_t in cases])
    for (name, sup, q, s_t, q_t), got_many in zip(cases, grouped):
        got = searchsorted_left(s_t, q_t)
        want = searchsorted_left_plain(s_t, q_t)
        err = max(int((got - want).abs().max()),
                  int((got_many - want).abs().max()))
        max_err = max(max_err, err)
        ref = np.searchsorted(sup, q, side="left")
        if err or not np.array_equal(got[0].cpu().numpy(), ref):
            raise AssertionError(f"K1 wrong on {name}: err {err}")
        print(f"  {name}: S={sup.shape[0]} G={q.shape[0]} C={q.shape[1]} "
              f"exact")
    print(f"  {len(cases)} cases grouped into "
          f"{-(-len(cases) // 8)} launches: exact")
    torch.cuda.synchronize()

    t = phase("3b K1 at full capacity, 7 searches over 8 clouds")
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import pad_points, synthetic_pair
    from apr_torch.models.sparse import SparseLevel, \
        build_pyramid_from_level, downsample_level, kernel_map_down, \
        kernel_map_same, kernel_map_up
    from apr_torch.ops.voxelize import voxelize_lean

    caps = CAPS
    pairs = [synthetic_pair(seed=s, n_points=N_POINTS, apc_points=4,
                            extent=60.0, distance=20.0)
             for s in range(N_PAIRS)]
    clouds = [p[k] for p in pairs[:4] for k in ("points0", "points1")]
    padded = [pad_points(c, POINT_CAPACITY) for c in clouds]
    pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
    msk = torch.from_numpy(np.stack([m for _, m in padded])).to(dev)
    coords, keys, vmask, _ = voxelize_lean(pts, 0.3, caps[0], msk)
    level0 = SparseLevel(coords, keys, vmask)
    print(f"  voxels per cloud at level 0: "
          f"{vmask.sum(1).tolist()} of {caps[0]}")
    levels = [level0]
    for cap in caps[1:]:
        levels.append(downsample_level(levels[-1], cap))
    k1_b8 = time_searches(searches_of(levels, 5), baseline=baseline)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("4 pyramid: fast maps through K1 equal the slow oracles")
    pyr = build_pyramid_from_level(level0, caps, 5)
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

    t = phase("5 encoder ResUNetFatBN, card vs CPU (float32) and bf16")
    from apr_torch.models import load_model

    one = SparseLevel(coords[:1], keys[:1], vmask[:1])
    pyr1 = build_pyramid_from_level(one, caps, 5)
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

    t = phase("6 RANSAC on ground-truth correspondences, 50% outliers")
    from apr_torch.registration.metrics import registration_errors
    from apr_torch.registration.ransac import ransac_pose

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

    t = phase("7 slice: FeatureTester.test, 8 pairs, ResUNetFatBN-128 bf16")
    from apr_torch.eval import FeatureTester
    from apr_torch.training.trainer import FCGFTrainer

    cfg = APRConfig(model="ResUNetFatBN", model_n_out=128,
                    conv1_kernel_size=5, compute_dtype="bfloat16",
                    voxel_size=0.3, point_capacity=POINT_CAPACITY,
                    capacities=caps, test_subsample=SUBSAMPLE,
                    test_num_ransac_hypotheses=HYPOTHESES)
    trainer = FCGFTrainer(cfg, device=dev, seed=0)
    tester = FeatureTester(cfg, trainer, device=dev)
    searchsorted_left.launches = 0
    t_main = time.perf_counter()
    stats = tester.test(pairs, seed=0)
    main_s = time.perf_counter() - t_main
    launches = searchsorted_left.launches
    summ = stats.summary()
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
    x = stage_split(dict(
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

    t = phase("8 K1 at the main path's shapes (one batch build, B=2)")
    batch = tester._pair_to_batch(pairs[0])
    both = tree_map(lambda a, b: torch.cat([a, b]), batch.pyramid0.levels,
                    batch.pyramid1.levels)
    k1_b2 = time_searches(searches_of(both, 5), baseline=baseline)
    max_err = max(max_err, k1_b8["max_abs_err"], k1_b2["max_abs_err"])
    print("  (the record's times are those of these 7 searches)")
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("9 K2 contract cases (kernel vs plain, d2 bit for bit, idx "
              "exact)")
    from apr_torch.ops.distance import nn_min

    k2_err = 0.0
    for name, q, s, m, qm in k2_contract_cases():
        qm_t = None if qm is None else torch.from_numpy(qm).to(dev)
        d2, idx, err = k2_check(
            *(torch.from_numpy(x).to(dev) for x in (q, s, m)), qm_t, name)
        k2_err = max(k2_err, err)
        none = torch.from_numpy(~m.any(1)).to(dev)
        if (bool((idx[none] != s.shape[1]).any())
                or not bool(torch.isinf(d2[none]).all())):
            raise AssertionError(f"K2 on {name}: a query with no valid "
                                 f"support must get (inf, Ns)")
        print(f"  {name}: B={q.shape[0]} Nq={q.shape[1]} Ns={s.shape[1]} "
              f"valid queries {'all' if qm is None else qm.sum(1).tolist()} "
              f"supports {m.sum(1).tolist()} exact")
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("10 training slice: FCGFTrainer.train_step, ResUNetFatBN-128 "
              "bf16, B=4, chamfer_mode=pallas")
    from dataclasses import replace

    cfg_t = APRConfig(**TRAIN_FIELDS)
    print(f"  {cfg_t.trainer} {cfg_t.model}-{cfg_t.model_n_out} conv1 "
          f"{cfg_t.conv1_kernel_size}^3 {cfg_t.compute_dtype} B="
          f"{cfg_t.batch_size} caps {cfg_t.capacities} points "
          f"{cfg_t.point_capacity} APC {cfg_t.apc_capacity} "
          f"{cfg_t.generator_model} ratio {cfg_t.point_generation_ratio} "
          f"{cfg_t.optimizer} lr {cfg_t.lr} momentum {cfg_t.sgd_momentum} "
          f"wd {cfg_t.weight_decay} chamfer {cfg_t.chamfer_mode}")
    t0 = time.perf_counter()
    b_t = cfg_t.batch_size
    tpairs = train_pairs(2 * b_t)
    raws = [raw_batch(tpairs[:b_t], cfg_t), raw_batch(tpairs[b_t:], cfg_t)]
    print(f"  {len(tpairs)} synthetic pairs ({TRAIN_POINTS} points, "
          f"{TRAIN_APC_POINTS} APC points) made on the host in "
          f"{time.perf_counter() - t0:.1f} s (set-up, not timed below)")
    trainer_t = FCGFTrainer(cfg_t, device=dev, seed=0)
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

    stage_split(dict(build=lambda _: trainer_t.build_batch(raws[0]),
                     forward=forward,
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

    t = phase("11 K2 at the train step's shapes (the 4 launches of a step)")
    k2_rows = time_k2(k2_inputs(trainer_t, trainer_t.build_batch(raws[0])))
    k2_step = per_step(k2_rows)
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

    t = phase("12 train step, card vs CPU (float32, small, same weights and "
              "samples)")
    compare_train_step(dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    from apr_torch.data.synthetic import synthetic_pair as kp_pair

    kp_pairs = [kp_pair(seed=s, **KP_PAIR) for s in range(N_PAIRS)]
    t = phase("13 KP neighbours at full capacity, card vs CPU")
    kp_neighbour_phase(dev, kp_pairs[0])
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("14 KPFCNN forward at full width, card vs CPU (float32) and "
              "bf16")
    kp_forward_phase(dev, kp_pairs[0])
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase(f"15 Predator slice: PredatorTester.test, {N_PAIRS} pairs, "
              f"KPFCNN-256 bf16")
    predator_slice_phase(dev, kp_pairs)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("16 Predator training slice: PredatorTrainer.train_step, "
              "kitti.yaml at full width, chamfer_mode=pallas")
    k2_pt, k2_pt_rows = predator_train_phase(dev)
    pt_step = per_step(k2_pt_rows)
    print(f"  per step: nn_min {pt_step['ms']:.3f} ms (kernel "
          f"{pt_step['kernel_ms']:.3f} ms)  plain {pt_step['plain_ms']:.3f} "
          f"ms  cdist+min {pt_step['library_ms']:.3f} ms  bound "
          f"{pt_step['bound_ms']:.3f} ms: nn_min reaches "
          f"{pt_step['bound_ms'] / pt_step['ms']:.2f} of the bound")
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("17 Predator train step, card vs CPU (float32, small, same "
              "weights and draws)")
    compare_predator_step(dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("18 FCGF training loop through the CLI (python -m "
              "apr_torch.train), resume, iter_size=2, symmetric")
    k1_loop, k2_loop = fcgf_loop_phase(dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("19 Predator training loop through the YAML entry (python -m "
              "apr_torch.main configs/train/kitti.yaml), test mode, "
              "iter_size=2")
    k1_ploop, k2_ploop = predator_loop_phase(dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("20 the real-data path: a KITTI-format tree, FCGF training "
              "and both eval scripts, Predator kitti.yaml train and test, "
              "the .pth import")
    real = real_data_phase(dev)
    print(f"  phase {time.perf_counter() - t:.1f} s")

    k2_err = max([k2_err] + [r["max_abs_err"] for r in k2_rows + k2_pt_rows])
    record = {"kernels": [
        dict(K1, route="cuda",
             launches=launches + k1_train + k1_loop + real["real_fcgf"][0],
             launches_by_path={"eval": launches, "train": k1_train,
                               "predator_train": 0, "fcgf_loop": k1_loop,
                               "predator_loop": k1_ploop,
                               "real_fcgf": real["real_fcgf"][0],
                               "real_predator": 0},
             max_abs_err=max_err, ms=k1_b2["ms"],
             plain_ms=k1_b2["plain_ms"], bound_ms=k1_b2["bound_ms"],
             bound_by="bytes", library_ms=k1_b2["library_ms"]),
        dict(K2, route="cuda",
             launches=(k2_train + k2_pt + k2_loop + k2_ploop
                       + real["real_fcgf"][1] + real["real_predator"][1]),
             launches_by_path={"train": k2_train, "predator_train": k2_pt,
                               "fcgf_loop": k2_loop,
                               "predator_loop": k2_ploop,
                               "real_fcgf": real["real_fcgf"][1],
                               "real_predator": real["real_predator"][1]},
             max_abs_err=k2_err, ms=k2_step["ms"],
             plain_ms=k2_step["plain_ms"], bound_ms=k2_step["bound_ms"],
             bound_by="operations", library_ms=k2_step["library_ms"],
             predator_train={k: pt_step[k] for k in (
                 "ms", "plain_ms", "bound_ms", "library_ms")}),
    ]}
    print("(K1's times: the 7 searches of one eval batch build, one grouped "
          "launch; K2's: the 4 nn_min calls of one FCGF train step, "
          "partitions included, and under predator_train those of one "
          "Predator train step)")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
