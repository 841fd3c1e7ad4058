"""Both testers' ``test_sharded`` over 2 gloo ranks on the CPU, against
apr_tpu's on a 2-device mesh (FCGF) and its per-pair program with the
sharded path's keys (Predator: apr_tpu's ``test_sharded`` vmaps that
program over the mesh), from bridged weights with the reference's random
numbers replayed (each group's keys split as the reference splits them;
the rank bodies are in test_torch_rank_bodies.py).

- FCGF, capacity tiers on (test_capacity_buckets=2), pairs light, light,
  heavy, light: the same groups in input order (the heavy pair's tier
  breaks them; the tail groups are padded by repetition), every pair
  once, pair_dist in input order; RTE / RRE within 1e-3 (relative and
  absolute), fitness within 1e-4 and the same success flags as the
  reference (the port's features differ from the reference's by float32
  rounding, ~1e-5);
- each pair's result equals, bit for bit, the one-process ``step`` on the
  same pair with the same draws, for FCGF's tier groups and for Predator's
  3 pairs on 2 ranks (a ragged tail), and Predator's the reference's
  within test_torch_predator_slice's tolerances;
- every rank holds the same stats, and sec_per_pair leaves out the first
  group.
"""

import jax
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.synthetic import synthetic_pair
from apr_tpu.eval import FeatureTester as RefTester
from apr_tpu.parallel import make_mesh as ref_make_mesh
from apr_tpu.training import get_trainer
from apr_torch.bridge import load_flax_predator_, load_flax_train_state_
from apr_torch.config import APRConfig
from apr_torch.eval import FeatureTester, PredatorTester
from apr_torch.parallel.launch import spawn
from apr_torch.training.predator import PredatorTrainer
from apr_torch.training.trainer import FCGFTrainer
from test_torch_kpfcnn import FIELDS as KP_FIELDS
from test_torch_kpfcnn import reference_predator
from test_torch_predator_slice import PAIRS as KP_PAIRS
from test_torch_rank_bodies import module_states, sharded_eval
from test_torch_train import _randomize

FCGF_FIELDS = dict(
    trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=16,
    conv1_kernel_size=3, generator_model="GenerativeMLP_54",
    point_generation_ratio=2, voxel_size=1.0, point_capacity=2048,
    capacities=(1024, 512, 256, 128), apc_capacity=8,
    compute_dtype="float32", test_num_ransac_hypotheses=1024,
    test_subsample=256, test_capacity_buckets=2)
SIZES = [250, 250, 1800, 250]
PREDATOR_FIELDS = dict(trainer="PredatorTrainer", **KP_FIELDS)
D = 2


def _group_keys(seed, groups):
    """Each real pair's key, split per group as the sharded testers do."""
    key, out = jax.random.PRNGKey(seed), []
    for group in groups:
        key, k = jax.random.split(key)
        out.extend(jax.random.split(k, D)[:len(group)])
    return out


def _fcgf_draws(tester, groups, keys):
    """Per pair (keyed by its ground truth): the subsample's uniforms and
    RANSAC's first-stage draws from the pair's key (tester.py:111-116,
    ransac.py:184-195)."""
    c, draws = tester.config, {}
    pairs_kw = [(kw, p) for kw, group in groups for p in group]
    for (kw, pair), key in zip(pairs_kw, keys):
        batch = tester._pair_to_batch(pair, **kw)
        n_valid = min(c.test_subsample,
                      int(batch.pyramid0.levels[0].mask.sum()))
        k_sub, k_ransac = jax.random.split(key)
        u = np.asarray(jax.random.uniform(
            k_sub, batch.pyramid0.levels[0].mask.shape[1:]))
        stage = np.asarray(jax.random.randint(
            jax.random.split(k_ransac)[0],
            (c.test_num_ransac_hypotheses, 4), 0, max(n_valid, 1)))
        draws[pair["t_gt"].astype(np.float32).tobytes()] = (u, [stage])
    return draws


def _predator_draws(tester, pairs, keys):
    """(u0, u1) and RANSAC's first-stage draws (predator_tester.py:51-64)."""
    c, draws = tester.config, {}
    for pair, key in zip(pairs, keys):
        batch = tester._pair_to_batch(pair)
        m0, m1 = batch.pyr0.levels[0].mask, batch.pyr1.levels[0].mask
        n_valid = min(c.test_subsample, int(m0.sum()))
        k0, k1, kr = jax.random.split(key, 3)
        u = [np.asarray(jax.random.uniform(k, m.shape, minval=1e-12,
                                           maxval=1.0))
             for k, m in ((k0, m0), (k1, m1))]
        stage = np.asarray(jax.random.randint(
            jax.random.split(kr)[0], (c.test_num_ransac_hypotheses, 4), 0,
            max(n_valid, 1)))
        draws[pair["t_gt"].astype(np.float32).tobytes()] = (u, [stage])
    return draws


def _one_process(tester, groups, draws, kind):
    """Each real pair through the tester's one-process ``step`` with its
    draws: [(rte, rre, fitness)]."""
    out = []
    for kw, group in groups:
        for pair in group:
            u, stage = draws[pair["t_gt"].astype(np.float32).tobytes()]
            stage = [torch.from_numpy(x.copy()) for x in stage]
            batch = tester._pair_to_batch(pair, **kw)
            if kind == "fcgf":
                m0 = batch.pyramid0.levels[0].mask[0]
                got = tester.step(batch, scores=torch.where(
                    m0, torch.from_numpy(u.copy()), -1.0),
                    stage_draws=stage)
            else:
                got = tester.step(batch, uniforms=tuple(
                    torch.from_numpy(x.copy()) for x in u),
                    stage_draws=stage)
            out.append([float(v) for v in got[1:]])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    pairs = [synthetic_pair(s, n_points=n, apc_points=4, distance=5.0,
                            extent=25.0) for s, n in enumerate(SIZES)]
    ref_cfg, cfg = RefConfig(**FCGF_FIELDS), APRConfig(**FCGF_FIELDS)
    ref_trainer = get_trainer(ref_cfg)
    ref_tester = RefTester(ref_cfg, ref_trainer, None)
    state = ref_trainer.init_state(jax.random.PRNGKey(0),
                                   ref_tester._pair_to_batch(pairs[2]))
    state = state._replace(params=_randomize(state.params, 1),
                           batch_stats=_randomize(state.batch_stats, 2))
    ref_tester.state = state
    ref = ref_tester.test_sharded(pairs, mesh=ref_make_mesh(
        jax.devices()[:D]), seed=0)

    trainer = FCGFTrainer(cfg, device="cpu")
    load_flax_train_state_(trainer, state.params, state.batch_stats)
    tester = FeatureTester(cfg, trainer, device="cpu")
    groups = tester._sharded_groups(pairs, D)
    draws = _fcgf_draws(tester, groups, _group_keys(0, [g for _, g in
                                                        groups]))
    kp_pairs = [synthetic_pair(**kw) for kw in KP_PAIRS]
    _, kp_ref_tester, _, kp_params, kp_stats = reference_predator(
        KP_FIELDS, kp_pairs[0])
    kp_trainer = load_flax_predator_(
        PredatorTrainer(APRConfig(**PREDATOR_FIELDS), device="cpu"),
        kp_params, kp_stats)
    kp_tester = PredatorTester(kp_trainer.config, kp_trainer, device="cpu")
    kp_groups = kp_tester._sharded_groups(kp_pairs, D)
    kp_keys = _group_keys(3, [g for _, g in kp_groups])
    kp_draws = _predator_draws(kp_tester, kp_pairs, kp_keys)
    kp_ref = [[float(v) for v in kp_ref_tester._step(
        kp_params, kp_ref_tester._pair_to_batch(p), k)[1:]]
        for p, k in zip(kp_pairs, kp_keys)]

    jobs = [("fcgf", FCGF_FIELDS, module_states(trainer), pairs, 0, draws),
            ("predator", PREDATOR_FIELDS, module_states(kp_trainer),
             kp_pairs, 3, kp_draws)]
    ranks = spawn(sharded_eval, D, args=(jobs,), devices="cpu", timeout=60,
                  deadline=600,
                  init_file=str(tmp_path_factory.mktemp("se") / "rdzv"))
    return dict(
        pairs=pairs, ref=ref, groups=groups, ranks=ranks,
        one=[_one_process(tester, groups, draws, "fcgf"),
             _one_process(kp_tester, kp_groups, kp_draws, "predator")],
        kp_pairs=kp_pairs, kp_ref=kp_ref)


def test_tier_groups_keep_the_input_order(run):
    sizes = [[len(p["points0"]) for p in g] for _, g in run["groups"]]
    assert [len(g) for g in sizes] == [2, 1, 1]
    assert sizes[1][0] > max(sizes[0] + sizes[2])
    caps = [kw["capacities"][0] for kw, _ in run["groups"]]
    assert caps[0] == caps[2] < caps[1]


def test_fcgf_sharded_matches_the_reference_mesh(run):
    ref = run["ref"]
    for got in run["ranks"]:
        got = got[0]
        assert len(got["rte"]) == len(run["pairs"])
        np.testing.assert_allclose(got["pair_dist"], ref.pair_dist,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["rte"], ref.rte, rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(got["rre"], ref.rre, rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(got["fitness"], ref.fitness, rtol=1e-4)
        assert got["success"] == ref.success
        assert len(got["sec_per_pair"]) == len(run["pairs"]) - 2


@pytest.mark.parametrize("job", [0, 1])
def test_each_pair_equals_the_one_process_step(run, job):
    a, b = (r[job] for r in run["ranks"])
    assert {k: a[k] for k in a if k not in ("seen", "sec_per_pair")} == \
        {k: b[k] for k in b if k not in ("seen", "sec_per_pair")}
    want = np.asarray(run["one"][job])
    want[:, 1] = np.where(np.isfinite(want[:, 1]), want[:, 1], 180.0)
    got = np.stack([a["rte"], a["rre"], a["fitness"]], 1)
    np.testing.assert_array_equal(got, want)
    # each rank evaluated its own pair of each group (rank 1 the padding
    # repeat of a tail group)
    n_groups = 3 if job == 0 else 2
    assert len(a["seen"]) == len(b["seen"]) == n_groups
    assert a["seen"][-1] == b["seen"][-1]
    # the first group (two pairs here) pays the warm-up and is not timed
    assert len(a["sec_per_pair"]) == len(a["rte"]) - 2


def test_predator_sharded_matches_the_reference_program(run):
    got = run["ranks"][0][1]
    want = np.asarray(run["kp_ref"])
    np.testing.assert_allclose(got["rte"], want[:, 0], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["rre"], want[:, 1], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["fitness"], want[:, 2], rtol=1e-5)
    c = APRConfig()
    assert got["success"] == [bool(r < c.rte_thresh and e < c.rre_thresh)
                              for r, e, _ in want]
    np.testing.assert_allclose(got["pair_dist"], [float(np.linalg.norm(
        p["t_gt"][:3, 3])) for p in run["kp_pairs"]], rtol=1e-6)
