"""The synthetic-convergence tools of the port (``python -m
apr_torch.tools.{validate_convergence, validate_predator_convergence,
validate_apr_gain, pool_apr_gain, sweep_ransac}``) against the root
``tools/`` scripts, loaded by path.

- ``mcnemar_exact_p``, ``paired_delta_ci``, ``make_set`` and ``errors``
  equal the reference tools' functions exactly (the same float64 / numpy
  arithmetic; ``make_set``'s rotation is scipy's bits, from
  ``apr_torch.geometry.rotation``);
- the PAIRED line parses under both packages' pooling regex, and the
  reference's ``pool_apr_gain`` prints the same POOLED lines as the
  port's on the same logs;
- each CLI runs end to end with ``--device cpu`` at a tiny step count and
  small scenes (the tools' recipes shrunk in widths, capacities and
  scene sizes) and
  prints its RESULT / PAIRED / table lines; without ``--device`` it asks
  for the card and raises here.
The first steps of the two training loops are held to the reference's
library calls in tests/test_torch_train.py (FCGF) and
tests/test_torch_predator_train.py (Predator), which compile the
reference's steps once for their other tests.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from apr_torch.config import APRConfig
from apr_torch.tools import pool_apr_gain, sweep_ransac, validate_apr_gain, \
    validate_convergence, validate_predator_convergence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tools' CPU runs launch many small ops: on one torch thread their
    time barely depends on the other test workers' load (see
    tests/test_torch_loop.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_gain():
    return _reference_tool("validate_apr_gain")


def test_paired_statistics_match_the_reference(ref_gain):
    for n01 in range(0, 30, 3):
        for n10 in range(0, 30, 4):
            assert validate_apr_gain.mcnemar_exact_p(n01, n10) == \
                ref_gain.mcnemar_exact_p(n01, n10)
            for n in (max(n01 + n10, 1), 96):
                assert validate_apr_gain.paired_delta_ci(n01, n10, n) == \
                    ref_gain.paired_delta_ci(n01, n10, n)
    assert validate_apr_gain.paired_delta_ci(0, 0, 0) == (0.0, 0.0, 0.0)


def test_make_set_and_errors_match_the_reference():
    ref = _reference_tool("sweep_ransac")
    for ratio in (0.02, 0.05, 0.5):
        a, b = np.random.default_rng(7), np.random.default_rng(7)
        got, want = sweep_ransac.make_set(a, 400, ratio), \
            ref.make_set(b, 400, ratio)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        t = got[2].copy()
        t[:3, 3] += 0.5
        assert sweep_ransac.errors(t, got[2]) == ref.errors(t, got[2])


def test_train_pools_are_disjoint_and_below_the_eval_seeds():
    pools = [validate_apr_gain.train_pools(k, 96, [6.0, 10.0, 14.0, 18.0])
             for k in range(3)]
    seeds = [{s for batch in p for s, _ in batch} for p in pools]
    assert all(len(s) == 96 for s in seeds)
    assert not (seeds[0] & seeds[1]) and not (seeds[1] & seeds[2])
    assert pools[1][0] == [(96, 6.0), (97, 10.0)]
    with pytest.raises(AssertionError, match="overlap the eval seed"):
        validate_apr_gain.train_pools(10, 96, [6.0])


def test_pooled_lines_match_the_reference_pool(tmp_path, capsys):
    a = np.array([1, 1, 0, 1, 0, 1], bool)
    b = np.array([1, 0, 0, 0, 1, 1], bool)
    logs = []
    for k in range(2):
        path = tmp_path / f"rep{k}.log"
        path.write_text("# arm=apr\n" + "\n".join(
            validate_apr_gain.paired_line(d, np.roll(a, k), b)
            for d in (12.0, 40.0)) + "\n")
        logs.append(str(path))
    got = pool_apr_gain.main(logs)
    capsys.readouterr()
    _reference_tool("pool_apr_gain").main(logs)
    want = capsys.readouterr().out.strip().splitlines()
    assert got == want and len(got) == 2
    assert got[0].startswith("POOLED eval_dist=12.0 runs=2 ")


SMALL_FCGF = dict(
    model_n_out=16, conv1_kernel_size=3, num_pos_per_batch=32,
    num_hn_samples_per_batch=16, voxel_size=0.75, point_capacity=512,
    capacities=(256, 128, 64, 32), apc_capacity=512,
    compute_dtype="float32", test_num_ransac_hypotheses=256,
    test_subsample=100)
SMALL_PREDATOR = dict(
    final_feats_dim=8, first_feats_dim=16, gnn_feats_dim=16, dgcnn_k=4,
    num_head=2, generator_model="GenerativeMLP_4", first_subsampling_dl=1.0,
    point_capacity=1024, apc_capacity=512,
    kp_capacities=(512, 256, 128, 64), neighborhood_limits=(12,) * 4,
    pos_radius=1.0, safe_radius=2.5, overlap_radius=1.2,
    matchability_radius=1.2, max_points=64, compute_dtype="float32",
    test_subsample=200, test_num_ransac_hypotheses=256)


@pytest.fixture
def small(monkeypatch):
    """The tools' recipes at small widths and scenes."""
    real_fcgf = validate_convergence.make_config
    real_pred = validate_predator_convergence.make_config
    monkeypatch.setattr(validate_convergence, "make_config",
                        lambda chamfer=None, compute=None, **kw: real_fcgf(
                            chamfer, compute, **{**SMALL_FCGF, **kw}))
    monkeypatch.setattr(validate_convergence, "SCENE",
                        dict(n_points=500, extent=12.0))
    monkeypatch.setattr(validate_convergence, "APC_POINTS", 500)
    monkeypatch.setattr(validate_apr_gain, "convergence_config",
                        validate_convergence.make_config)
    monkeypatch.setattr(validate_apr_gain, "TRAIN_POINTS", 500)
    monkeypatch.setattr(validate_predator_convergence, "make_config",
                        lambda compute=None, **kw: real_pred(
                            compute, **{**SMALL_PREDATOR, **kw}))
    monkeypatch.setattr(validate_predator_convergence, "TRAIN_SCENE",
                        dict(n_points=1000, apc_points=500, extent=20.0))
    monkeypatch.setattr(validate_predator_convergence, "EVAL_SCENE",
                        dict(n_points=1000, apc_points=4, extent=20.0))


def test_the_tools_keep_the_reference_recipes():
    c = validate_convergence.make_config()
    assert (c.model, c.model_n_out, c.conv1_kernel_size, c.capacities,
            c.generator_model, c.optimizer, c.lr) == (
        "ResUNetBN2", 32, 5, (8192, 4096, 2048, 1024), "GenerativeMLP_54",
        "SGD", 0.1)
    assert validate_convergence.make_config("pallas").chamfer_mode == \
        "pallas"
    assert validate_apr_gain.make_config(0.0).loss_ratio == 0.0
    p = validate_predator_convergence.make_config()
    assert (p.first_feats_dim, p.kp_capacities, p.lr, p.sgd_momentum,
            p.exp_gamma, p.test_num_ransac_hypotheses) == (
        64, (8192, 2048, 1024, 512), 0.05, 0.98, 0.99, 32768)
    assert isinstance(p, APRConfig)


@pytest.mark.parametrize("tool", [validate_convergence,
                                  validate_predator_convergence,
                                  validate_apr_gain, sweep_ransac])
def test_a_tool_asks_for_the_card_by_default(tool):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--steps", "1"] if tool is not sweep_ransac else [])


@pytest.mark.parametrize("chamfer", [None, "pallas"])
def test_validate_convergence_runs_on_the_cpu(small, capsys, chamfer):
    argv = ["--device", "cpu", "--steps", "2", "--eval_pairs", "1"]
    s = validate_convergence.main(
        argv + (["--chamfer", chamfer] if chamfer else []))
    out = capsys.readouterr().out
    assert f"# chamfer={chamfer or 'window'} " in out
    assert "RESULT recall=" in out and s["n_pairs"] == 1


def test_validate_predator_convergence_runs_on_the_cpu(small, capsys):
    res = validate_predator_convergence.main(
        ["--device", "cpu", "--steps", "2", "--train_pairs", "1",
         "--eval_pairs", "1"])
    out = capsys.readouterr().out
    assert "# step    0 loss" in out and "# step    1 loss" in out
    assert "RESULT recall " in out and len(res["rte"]) == 1


def test_validate_apr_gain_and_its_pool_run_on_the_cpu(small, capsys,
                                                      tmp_path):
    lines = validate_apr_gain.main(
        ["--device", "cpu", "--steps", "1", "--eval_pairs", "1",
         "--pool_pairs", "2", "--eval_dists", "12", "--eval_points", "500",
         "--extent", "12", "--apc_complement_dist", "0", "--seed0", "3"])
    out = capsys.readouterr().out
    assert out.count("RESULT arm=") == 2 and "seed0=3" in out
    assert len(lines) == 1 and lines[0].startswith("PAIRED eval_dist=12.0 ")
    log = tmp_path / "gain.log"
    log.write_text(out)
    pooled = pool_apr_gain.main([str(log)])
    assert len(pooled) == 1 and " runs=1 " in pooled[0]


def test_sweep_ransac_runs_on_the_cpu(capsys):
    table = sweep_ransac.main(
        ["--device", "cpu", "--pairs", "2", "--m", "200", "--ratios", "0.3",
         "--hyps", "256", "--esc_base", "256", "--esc_factor", "2",
         "--esc_rungs", "2"])
    out = capsys.readouterr().out
    assert "ratio  analytic32k H=0k H=0kesc H=0kesc2c" in out
    assert list(table) == [0.3] and len(table[0.3]) == 3
