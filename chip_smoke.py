#!/usr/bin/env python3
"""Drive the apr_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (each prints its lines and raises on failure, so any failure exits
non-zero; with no card, or outside a checkout, it exits non-zero at once):

1. device: the card's name and power limit, the TF32 settings;
2. build: every kernel under apr_torch/csrc, from the checkout's sources;
3. kernel K1 (searchsorted_left) against its plain version, exact: (a) the
   contract cases, (b) the seven searches of a full-capacity pyramid
   build batched over 8 clouds, with kernel / plain / torch.searchsorted
   times and the memory bound per shape;
4. pyramid: the fast kernel maps (through K1) equal the slow oracles;
5. encoder: ResUNetFatBN in float32 on the card against the CPU, and the
   bf16 deviation;
6. RANSAC on a ground-truth correspondence set with 50% outliers;
7. the slice: FeatureTester.test on 8 synthetic pairs at full width, with
   K1's launch count read around it, and a per-stage time split.
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
ENC_F32_TOL = 1e-4               # abs, on unit-norm float32 features
KERNEL_SOURCE = "apr_torch/csrc/searchsorted.cu"
KERNEL_REPLACES = "apr_tpu/ops/pallas/searchsorted.py:116"


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def profiled(fn, x):
    """Run ``fn(x)`` under torch.profiler; returns (result, card busy ms,
    kernel count, the three longest kernels by total time).  Busy time is
    the sum of the device activities' durations (one stream: they do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            out = fn(x)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    per_name = {}
    for e in dev_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
    busy = sum(per_name.values()) / 1e3
    return out, busy, len(dev_events), "; ".join(
        f"{n[:48]} {us / 1e3:.2f} ms" for n, us in top)


def searches_of(lv, conv1_kernel_size):
    """The seven (name, support [B, S], queries [B, G, C]) searches that
    build_pyramid_from_level runs over the levels ``lv``, as _zrun_maps
    forms them."""
    from apr_torch.ops.hashing import INVALID_KEY, pack_coords
    from apr_torch.models.sparse import zrun_queries

    out = [("conv1 same L0", lv[0].keys,
            zrun_queries(lv[0].keys, lv[0].coords, lv[0].mask,
                         conv1_kernel_size)[0])]
    for l in range(len(lv) - 1):
        base = lv[l + 1].coords * 2
        keys = torch.where(lv[l + 1].mask, pack_coords(base), INVALID_KEY)
        out.append((f"down L{l}->L{l + 1}", lv[l].keys,
                    zrun_queries(keys, base, lv[l + 1].mask, 3)[0]))
    for l in range(1, len(lv)):
        out.append((f"same L{l}", lv[l].keys,
                    zrun_queries(lv[l].keys, lv[l].coords, lv[l].mask,
                                 3)[0]))
    return [(n, s.contiguous(), q.contiguous()) for n, s, q in out]


def time_searches(searches, reps=20):
    """Kernel / plain / library times and the bound of each search; the
    kernel is held to the plain version (exact) on the way."""
    from apr_torch.ops.searchsorted import searchsorted_left, \
        searchsorted_left_plain

    rows = []
    for name, sup, q in searches:
        b, s = sup.shape
        g, c = q.shape[1:]
        got = searchsorted_left(sup, q)
        want = searchsorted_left_plain(sup, q)
        err = int((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}: max abs err {err}")
        flat = q.reshape(b, g * c)
        bound_ms = (2 * g * c + s) * 4 * b / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            name=name, B=b, G=g, C=c, S=s, max_abs_err=err,
            ms=cuda_ms(lambda: searchsorted_left(sup, q), reps),
            plain_ms=cuda_ms(lambda: searchsorted_left_plain(sup, q), 3),
            library_ms=cuda_ms(lambda: torch.searchsorted(
                sup, flat, out_int32=True), reps),
            bound_ms=bound_ms))
        r = rows[-1]
        print(f"  {name:14s} B={b} G={g:3d} C={c:5d} S={s:5d}  "
              f"kernel {r['ms'] * 1e3:8.1f} us  plain {r['plain_ms'] * 1e3:9.1f}"
              f" us  torch.searchsorted {r['library_ms'] * 1e3:8.1f} us  "
              f"bound {bound_ms * 1e3:6.2f} us  exact", flush=True)
    return rows


def contract_cases():
    """The four cases of tests/test_pallas_searchsorted.py (holes and
    padding, multi-slab spans, extremes and duplicates, empty support) and
    a support too long to stage in shared memory, as [S] and [G, C]."""
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
        ("S > 58112, no staging",
         np.arange(0, 200000, 3, dtype=np.int32)[:60000],
         np.sort(rng.integers(-5, 190000, (3, 1000)).astype(np.int32),
                 axis=1)),
    ]
    return cases


def main():
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

    phase("3a K1 contract cases (kernel vs plain vs numpy, exact)")
    from apr_torch.ops.searchsorted import searchsorted_left, \
        searchsorted_left_plain

    max_err = 0
    for name, sup, q in contract_cases():
        s_t = torch.from_numpy(sup)[None].to(dev)
        q_t = torch.from_numpy(q)[None].to(dev)
        got = searchsorted_left(s_t, q_t)
        want = searchsorted_left_plain(s_t, q_t)
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        ref = np.searchsorted(sup, q, side="left")
        if err or not np.array_equal(got[0].cpu().numpy(), ref):
            raise AssertionError(f"K1 wrong on {name}: err {err}")
        print(f"  {name}: S={sup.shape[0]} G={q.shape[0]} C={q.shape[1]} "
              f"exact")
    torch.cuda.synchronize()

    t = phase("3b K1 at full capacity, 7 searches over 8 clouds")
    from apr_torch.config import APRConfig
    from apr_torch.data.synthetic import pad_points, synthetic_pair
    from apr_torch.models.sparse import SparseLevel, \
        build_pyramid_from_level, downsample_level, kernel_map_down, \
        kernel_map_same
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
    rows8 = time_searches(searches_of(levels, 5))
    print(f"  sum over the 7 searches (B=8): kernel "
          f"{sum(r['ms'] for r in rows8) * 1e3:.1f} us, bound "
          f"{sum(r['bound_ms'] for r in rows8) * 1e3:.1f} us")
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
    print(f"  K1 launches during the run: {launches} "
          f"({launches / len(pairs):.0f} per batch build)")
    if launches < 7 * len(pairs):
        raise AssertionError("the slice did not run every kernel map "
                             "through K1")
    if not (np.isfinite(stats.rte).all() and np.isfinite(stats.rre).all()
            and np.isfinite(stats.fitness).all()):
        raise AssertionError("non-finite RTE/RRE/fitness")

    # one pair by stage, synchronised at each boundary: host-clock wall
    # time (second repetition), then a profiled repetition for the card's
    # busy time and kernel launches per stage
    gen = torch.Generator(device=dev).manual_seed(1)
    stages = dict(
        build=lambda _: tester._pair_to_batch(pairs[0]),
        encode=lambda b: (b, trainer._encode_pair(b)),
        eval=lambda bf: tester.eval_one(
            bf[1][0][0], bf[1][1][0], bf[0].xyz0[0], bf[0].xyz1[0],
            bf[0].pyramid0.levels[0].mask[0],
            bf[0].pyramid1.levels[0].mask[0], bf[0].t_gt[0], gen),
    )
    wall = {}
    for rep in range(3):
        x = None
        for name, fn in stages.items():
            if rep < 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    x = fn(x)
                torch.cuda.synchronize()
                wall[name] = (time.perf_counter() - t0) * 1e3
            else:
                x, busy, n_kern, top = profiled(fn, x)
                print(f"  {name:6s} wall {wall[name]:8.2f} ms  card busy "
                      f"{busy:8.2f} ms (idle share "
                      f"{1 - busy / wall[name]:.2f})  kernels {n_kern}  "
                      f"top: {top}")
    t_est, rte0, rre0, fit0 = x
    print(f"  pair total {sum(wall.values()):.2f} ms (wall, synchronised "
          f"per stage; busy and launches from a separate profiled run)")
    if not all(bool(torch.isfinite(v).all()) for v in x):
        raise AssertionError("non-finite raw outputs of one pair")
    print(f"  phase {time.perf_counter() - t:.1f} s")

    t = phase("8 K1 at the main path's shapes (one batch build, B=2)")
    batch = tester._pair_to_batch(pairs[0])
    both = tree_map(lambda a, b: torch.cat([a, b]), batch.pyramid0.levels,
                    batch.pyramid1.levels)
    rows = time_searches(searches_of(both, 5))
    max_err = max([max_err] + [r["max_abs_err"] for r in rows + rows8])
    record = {"kernels": [{
        "name": "searchsorted_left",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
    }]}
    print("  (the record's times are sums over these 7 searches)")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
