"""The profilers of ``apr_torch/tools`` on the CPU at small sizes.

- Each tool's stage functions return what the library call they time
  returns (exactly: the same ops on the same inputs), and the z-run
  conv1 stage equals the naive oracle map.
- ``probe_radius_select``: the ported ``tournament`` and ``itermin``
  selectors equal ``_smallest_k`` (values and positions, ties included),
  and the windowed tables under each equal the reference's
  ``windowed_radius_neighbors(select_method=...)`` for that method; the
  module global ``_smallest_k`` comes back after a selector raises.
- ``time_stage`` chains its iterations and consumes every output; the
  CPU run reads the wall clock only, and the card's timers raise there.
- The mains of the tools whose stages are cheap on the CPU print every
  stage line in the reference's order (the training and Predator tools'
  mains run on the card, in chip_smoke.py's phase 26).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.models import sparse
from apr_torch.ops import neighbors
from apr_torch.ops.voxelize import dedup_points, voxelize_lean
from apr_torch.tools import probe_radius_select as probe
from apr_torch.tools import profile_build, profile_predator, \
    profile_predator_sustained, profile_pyramid, profile_sort, \
    profile_train_step
from apr_torch.training.batching import make_pair_batch
from apr_torch.utils import profiling
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)

ref_nb = importlib.import_module("apr_tpu.ops.neighbors")
CPU = torch.device("cpu")
SMALL_BUILD = dict(voxel_size=1.0, point_capacity=2048,
                   capacities=(1024, 512, 256, 128), apc_capacity=2048,
                   conv1_kernel_size=3)
SMALL_PAIR = dict(n_points=1500, apc_points=1500, distance=5.0, extent=20.0)
SMALL_KP = dict(point_capacity=2048, neighborhood_limits=(16, 16, 16, 16),
                first_feats_dim=16, gnn_feats_dim=16, final_feats_dim=8,
                compute_dtype="float32", test_subsample=256,
                test_num_ransac_hypotheses=256)


def _equal(a, b):
    la, lb = profiling.leaves(a), profiling.leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(profile_build, "CONFIG", SMALL_BUILD)
    monkeypatch.setattr(profile_build, "PAIR", SMALL_PAIR)
    return APRConfig(**SMALL_BUILD)


def test_profile_build_stages_return_the_library_calls(small):
    raw = profile_build.raw_arrays(2, small, CPU)
    p0, m0, p1, m1, a0, am0, a1, am1, tg = raw
    st = profile_build.stages(small, raw)
    assert list(st) == ["full build", "build w/o GT correspondences",
                        "pyramids+maps only (2B fold)",
                        "voxelize only (2B fold)",
                        "APC dedup via full voxelize (r3 path)",
                        "APC dedup via dedup_points (lean)"]
    kw = dict(voxel_size=1.0, capacities=small.capacities,
              conv1_kernel_size=3, corr_cap=small.corr_capacity_per_point,
              search_multiplier=(
                  small.positive_pair_search_voxel_size_multiplier),
              device="cpu")
    _equal(st["full build"](p0), make_pair_batch(*raw, **kw))
    _equal(st["build w/o GT correspondences"](p0), make_pair_batch(
        *raw, with_correspondences=False, **kw))
    vox = voxelize_lean(torch.cat([p0, p1]), 1.0, 1024, torch.cat([m0, m1]))
    _equal(st["voxelize only (2B fold)"](p0), vox)
    _equal(st["pyramids+maps only (2B fold)"](p0),
           sparse.build_pyramid_from_level(sparse.SparseLevel(*vox[:3]),
                                           small.capacities, 3))
    lean = dedup_points(torch.cat([a0, a1]), 1.0, torch.cat([am0, am1]))
    _equal(st["APC dedup via dedup_points (lean)"](p0), lean)
    # the full-voxelize dedup keeps the same representatives, in key order
    full_pts, full_mask = st["APC dedup via full voxelize (r3 path)"](p0)
    assert int(full_mask.sum()) == int(lean[1].sum())
    np.testing.assert_array_equal(full_pts[full_mask].numpy(),
                                  lean[0][lean[1]].numpy())


def test_profile_pyramid_stages(monkeypatch):
    monkeypatch.setattr(profile_pyramid, "B", 2)
    monkeypatch.setattr(profile_pyramid, "N", 2048)
    monkeypatch.setattr(profile_pyramid, "C0", 1024)
    monkeypatch.setattr(profile_pyramid, "CAPS", (1024, 512, 256, 128))
    pts, mask = profile_pyramid.make_points(CPU)
    pts = pts / 30   # dense: the maps find neighbours
    st = profile_pyramid.stages(mask)
    pyr = sparse.build_pyramid(profile_pyramid.voxelize(pts, 0.3, 1024,
                                                        mask),
                               (1024, 512, 256, 128), 5)
    _equal(st["voxelize + build_pyramid x8"](pts), pyr)
    _equal(st["voxelize + downsample levels x8"](pts), pyr.levels)
    lv0 = pyr.levels[0]
    naive = st["voxelize + conv1 map naive x8"](pts)
    _equal(naive, sparse.kernel_map_same(lv0, 5))
    _equal(st["voxelize + conv1 map z-run x8"](pts).transpose(1, 2), naive)
    _equal(st["voxelize + one 27-off same map x8"](pts),
           sparse.kernel_map_same(lv0, 3))
    assert int((naive < 1024).sum()) > 2 * int(lv0.mask.sum())
    levels, maps = st["levels + searches + K1 + zrun_decode x8"](pts)
    _equal(levels, pyr.levels)
    names = [n for n, _ in sparse.pyramid_searches(pyr.levels, 5)]
    by_name = dict(zip(names, maps))
    _equal(by_name["conv1"].transpose(1, 2), pyr.conv1_map)
    for l, down in enumerate(pyr.down_maps):
        _equal(by_name[f"down{l}"].transpose(1, 2), down)


def test_profile_sort_stages_sort():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 30, (2, 256)).astype(np.int32))
    for label, fn, which in profile_sort.stages(256, 2):
        inp = x[0] if which == "1" else x
        out = fn(inp)
        keys = out[0] if isinstance(out, tuple) else out
        _equal(keys, torch.sort(inp, dim=-1).values)
        if isinstance(out, tuple):
            np.testing.assert_array_equal(
                torch.gather(inp, -1, out[1].long()).numpy(), keys.numpy())
    nxt = profile_sort.rekey(x, torch.sort(x, dim=-1), 1)
    assert nxt.dtype == torch.int32 and int(nxt.max()) < (1 << 30)
    assert not torch.equal(nxt, x)


TINY_PAIR = dict(n_points=800, apc_points=800, distance=5.0, extent=15.0)


def test_profile_train_step_stages(monkeypatch):
    from apr_torch.training import get_trainer

    monkeypatch.setattr(profile_train_step, "PAIR", TINY_PAIR)
    cfg = APRConfig(
        trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=8,
        conv1_kernel_size=3, generator_model="GenerativeMLP_54",
        point_generation_ratio=2, voxel_size=1.0, point_capacity=1024,
        capacities=(512, 256, 128, 64), apc_capacity=1024, batch_size=1,
        num_pos_per_batch=32, num_hn_samples_per_batch=16,
        compute_dtype="float32", chamfer_mode="pallas")
    raw = profile_train_step.raw_arrays(cfg, CPU)
    twins = [get_trainer(cfg, device="cpu", seed=0) for _ in range(2)]
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    batch = twins[0].build_batch(raw)
    st = {label: (fn, x0) for label, fn, x0, _, _ in
          profile_train_step.stages(cfg, twins[0], raw, batch, gens[0],
                                    {"sustained", "fwd", "fwd2x",
                                     "chamfer"})}
    assert list(st) == ["sustained (batch build + step)",
                        "encoder fwd (pair-folded)",
                        "encoder fwd x2 (unfolded)",
                        "chamfer fwd+bwd 2x [pallas]"]
    with torch.inference_mode():
        _equal(st["encoder fwd (pair-folded)"][0](batch),
               twins[1]._encode_pair(batch))
        _equal(st["encoder fwd x2 (unfolded)"][0](batch),
               twins[1]._encode_pair(batch, fold=False))
    fn, x0 = st["sustained (batch build + step)"]
    _equal(fn(x0), twins[1].train_step(twins[1].build_batch(raw), gens[1]))
    fn, mo = st["chamfer fwd+bwd 2x [pallas]"]
    moved = fn(mo)
    assert moved.shape == mo.shape and not torch.equal(moved, mo)
    assert float((moved - mo).abs().max()) < 1e-6


def test_profile_predator_stages():
    from apr_torch.eval.predator_tester import PredatorTester
    from apr_torch.training.predator import PredatorTrainer

    cfg = APRConfig(trainer="PredatorTrainer",
                    kp_capacities=(1024, 512, 256, 128), **SMALL_KP)
    tester = PredatorTester(cfg, PredatorTrainer(cfg, device="cpu", seed=0),
                            device="cpu")
    pair = synthetic_pair(seed=0, n_points=1500, apc_points=4, extent=20.0,
                          distance=5.0)
    batch = tester._pair_to_batch(pair)
    st = profile_predator.stages(tester, torch.Generator().manual_seed(1))
    assert list(st) == ["encoder only (incl skips)", "KPFCNN forward",
                        "+ sampling + feature match", "full tester step"]
    with torch.inference_mode():
        _equal(st["KPFCNN forward"][0](batch),
               tester.trainer.model(batch.pyr0, batch.pyr1))
        _equal(st["full tester step"][0](batch), tester.step(
            batch, torch.Generator().manual_seed(1)))
    moved = profile_predator.jitter_pyramids(batch, batch.t_gt, 1)
    d = (moved.pyr0.levels[0].points - batch.pyr0.levels[0].points).abs()
    assert 0 < float(d.max()) < 1e-3


def test_profile_predator_sustained_stages(monkeypatch):
    from apr_torch.training.predator import PredatorTrainer

    cfg = APRConfig(trainer="PredatorTrainer",
                    kp_capacities=(512, 256, 128, 64), apc_capacity=1024,
                    generator_model="GenerativeMLP_4",
                    **dict(SMALL_KP, point_capacity=1024))
    monkeypatch.setattr(profile_predator_sustained, "PAIR",
                        dict(seed=0, distance=5.0, extent=15.0,
                             apc_points=800))
    raw = profile_predator_sustained.raw_arrays(cfg, 800, CPU)
    twins = [PredatorTrainer(cfg, device="cpu", seed=0) for _ in range(2)]
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    (_, _, _, _), (label, fn, x0, _) = profile_predator_sustained.stages(
        twins[0], raw, twins[0].build_batch(raw), gens[0])
    assert label == "sustained (build + step)"
    _equal(fn(x0), twins[1].train_step(twins[1].build_batch(raw), gens[1],
                                       0.0))


@pytest.mark.parametrize("method", ["tournament", "itermin"])
def test_selectors_equal_smallest_k(method):
    rng = np.random.default_rng(7)
    # multiples of 1/4 below the radius: many ties; inf where masked
    d2 = (rng.integers(0, 40, (3, 5, 768)) / 4).astype(np.float32)
    d2[rng.random(d2.shape) < 0.3] = np.inf
    d2 = torch.from_numpy(d2)
    for k in (1, 24, 128):
        want = neighbors._smallest_k(d2, k)
        got = probe.SELECTORS[method](d2, k)
        _equal(got, want)


@pytest.mark.parametrize("method", ["tournament", "itermin"])
def test_probe_tables_equal_the_references_select_method(method):
    d = synthetic_pair(5, n_points=3000, apc_points=4, distance=6.0,
                       extent=30.0)
    p, m = pad_points(d["points0"], 3072)
    kw = dict(tile=64, window=768)
    with probe.selector(method) as fn:
        assert neighbors._smallest_k is fn
        got = neighbors.windowed_radius_neighbors(
            torch.from_numpy(p)[None], torch.from_numpy(p)[None], 2.5, 24,
            torch.from_numpy(m)[None], torch.from_numpy(m)[None], **kw)
    assert neighbors._smallest_k is probe._KEEP
    want = jax.jit(lambda q, qm: ref_nb.windowed_radius_neighbors(
        q, q, 2.5, 24, q_mask=qm, s_mask=qm, select_method=method, **kw))(
        jnp.asarray(p), jnp.asarray(m))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int((got[0] < 3072).sum()) > 5 * int(m.sum())


def test_selector_is_restored_after_a_raise():
    with pytest.raises(ZeroDivisionError):
        with probe.selector("itermin"):
            assert neighbors._smallest_k is probe._smallest_k_itermin
            1 / 0
    assert neighbors._smallest_k is probe._KEEP


def test_time_stage_chains_and_reads_the_wall_on_the_cpu(capsys):
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2

    row, out = profiling.time_stage("double", fn, torch.ones(3),
                                    lambda b, o, i: b + o.sum(), 3, CPU)
    # the warm-up chain, the timed chain, one profiled iteration; each
    # input made from the base and the previous output
    assert len(seen) == 7
    for i, v in enumerate([1.0, 7.0, 43.0, 1.0, 7.0, 43.0, 259.0]):
        torch.testing.assert_close(seen[i], torch.full((3,), v))
    assert row.device_ms is None and row.busy_ms is None and row.wall_ms > 0
    assert "device not measured" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="times the card"):
        profiling.cuda_ms(lambda: None, 1, device="cpu")
    with pytest.raises(RuntimeError, match="times the card"):
        profiling.profiled(lambda x: x, None, device="cpu")
    with pytest.raises(ValueError, match="no tensor"):
        profiling.checksum({"a": 1.0})


def _mains(tmp_path, monkeypatch):
    monkeypatch.setattr(profile_build, "CONFIG", SMALL_BUILD)
    monkeypatch.setattr(profile_build, "PAIR", SMALL_PAIR)
    for name, v in dict(B=1, N=1024, C0=512, CAPS=(512, 256, 128, 64),
                        K=1).items():
        monkeypatch.setattr(profile_pyramid, name, v)
    for name, v in dict(CAPS=(1024, 512, 256, 128), LIMITS=(8, 8, 8, 8),
                        POINTS=1500, POINT_CAPACITY=2048).items():
        monkeypatch.setattr(probe, name, v)
    return {
        "profile_build": (profile_build, ["--batch", "1", "--k", "1"], 6),
        "profile_pyramid": (profile_pyramid, [], 8),
        "profile_sort": (profile_sort, ["--n", "64", "--batch", "2",
                                        "--k", "1"], 6),
        "probe_radius_select": (probe, ["--iters", "1"], 3),
    }


@pytest.mark.parametrize("tool", ["profile_build", "profile_pyramid",
                                  "profile_sort", "probe_radius_select"])
def test_main_prints_every_stage(tool, tmp_path, monkeypatch, capsys):
    mod, argv, n = _mains(tmp_path, monkeypatch)[tool]
    rows = mod.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(rows) == n
    assert "device cpu (wall clock only: no device metric)" in out
    for r in rows:
        assert r.label in out and r.wall_ms > 0 and r.device_ms is None
    assert [r.k1 for r in rows] == [0] * n      # the CPU runs no kernel
