"""The Predator-APR eval slice end to end: apr_torch's PredatorTester
against apr_tpu's, on a few synthetic pairs, from a bridged flax tree, fed
the reference's random numbers (its sampling uniforms and RANSAC draws).

- the KP batch (pyramids, GT correspondences): integers exact, points
  within 1e-6;
- the sampled masks: equal (the port's own forward, within ~1e-6 of the
  reference's, feeds its own sampling);
- transform within 1e-4, RTE / RRE within 1e-3 (relative and absolute),
  fitness within 1e-5 and the same success flag, on random weights and on
  oracle features under which RANSAC recovers the pose;
- ``test`` pipelined and not; calibrate_neighbors; the training entry
  points run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.synthetic import synthetic_pair
from apr_tpu.eval.predator_tester import PredatorTester as RefTester
from apr_tpu.eval.predator_tester import \
    calibrate_neighbors as ref_calibrate
from apr_tpu.models.kpfcnn import KPFCNNOutputs as RefOutputs
from apr_torch.bridge import load_flax_predator_
from apr_torch.config import APRConfig
from apr_torch.eval.predator_tester import PredatorTester, \
    calibrate_neighbors, weighted_sample
from apr_torch.models.kpfcnn import KPFCNNOutputs
from apr_torch.training.predator import PredatorTrainer
from test_torch_kpfcnn import FIELDS, reference_predator

T = torch.from_numpy
PAIRS = [dict(seed=s, n_points=2500, apc_points=4, distance=d, extent=30.0)
         for s, d in ((7, 6.0), (8, 4.0), (9, 8.0))]


@pytest.fixture(scope="module")
def slice_run():
    pairs = [synthetic_pair(**kw) for kw in PAIRS]
    ref_trainer, ref_tester, _, params, stats = reference_predator(
        FIELDS, pairs[0])
    cfg = APRConfig(**FIELDS)
    trainer = load_flax_predator_(PredatorTrainer(cfg, device="cpu"), params,
                                  stats)
    return dict(pairs=pairs, ref_tester=ref_tester, params=params,
                tester=PredatorTester(cfg, trainer, device="cpu"))


def _reference_random(key, m0, m1, n_valid, n_hyp):
    """The reference step's random numbers from its key
    (predator_tester.py:51-64, ransac.py:184, 195)."""
    k0, k1, kr = jax.random.split(key, 3)
    u = [jax.random.uniform(k, m.shape, minval=1e-12, maxval=1.0)
         for k, m in ((k0, m0), (k1, m1))]
    k_stage1, _ = jax.random.split(kr)
    draws = jax.random.randint(k_stage1, (n_hyp, 4), 0, max(n_valid, 1))
    return [T(np.array(x)) for x in u], [T(np.array(draws))]


def _reference_mask(scores, mask, n, u):
    """The reference's Gumbel top-k (predator_tester.py:53-64)."""
    w = jnp.where(mask, scores, 0.0)
    keys = jnp.where(mask, jnp.log(jnp.maximum(w, 1e-12))
                     - jnp.log(-jnp.log(u)), -jnp.inf)
    _, sel = jax.lax.top_k(keys, min(n, keys.shape[0]))
    return np.asarray(jnp.zeros_like(mask).at[sel].set(True) & mask)


def test_predator_config_loads_the_reference_config():
    ref = RefConfig(trainer="PredatorTrainer", **FIELDS)
    assert APRConfig.from_dict(ref.to_dict()) == APRConfig(
        trainer="PredatorTrainer", **FIELDS)


def test_kp_batch_matches_exactly(slice_run):
    tester, ref_tester = slice_run["tester"], slice_run["ref_tester"]
    for pair in slice_run["pairs"]:
        got = tester._pair_to_batch(pair)
        want = ref_tester._pair_to_batch(pair)
        g_leaves = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), tuple(got)))
        w_leaves = jax.tree_util.tree_leaves(tuple(want))
        assert len(g_leaves) == len(w_leaves) == 2 * 4 * 5 + 8
        for g, w in zip(g_leaves, w_leaves):
            w = np.asarray(w)
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)
        assert int(got.corr_mask.sum()) > 100


def _compare(got, want):
    t_est, rte, rre, fitness = got
    np.testing.assert_allclose(t_est.numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose([float(rte), float(rre)],
                               [float(want[1]), float(want[2])],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(fitness), float(want[3]), rtol=1e-5)
    c = APRConfig()
    assert ((float(rte) < c.rte_thresh and float(rre) < c.rre_thresh)
            == (float(want[1]) < c.rte_thresh
                and float(want[2]) < c.rre_thresh))


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_step_matches_reference(slice_run, i):
    tester, ref_tester = slice_run["tester"], slice_run["ref_tester"]
    cfg = tester.config
    pair = slice_run["pairs"][i]
    batch, ref_batch = tester._pair_to_batch(pair), \
        ref_tester._pair_to_batch(pair)
    key = jax.random.PRNGKey(100 + i)
    want = ref_tester._step(slice_run["params"], ref_batch, key)

    ref_out = jax.jit(ref_tester.trainer.model.apply)(
        {"params": slice_run["params"]["model"]}, ref_batch.pyr0,
        ref_batch.pyr1)
    out = tester.forward(batch)
    m0, m1 = batch.pyr0.levels[0].mask, batch.pyr1.levels[0].mask
    n = cfg.test_subsample
    ref_s0 = _reference_mask(ref_out.overlap0 * ref_out.saliency0,
                             ref_batch.pyr0.levels[0].mask, n,
                             jax.random.uniform(jax.random.split(key, 3)[0],
                                                m0.shape, minval=1e-12))
    uniforms, draws = _reference_random(key, m0.numpy(), m1.numpy(),
                                        int(ref_s0.sum()),
                                        cfg.test_num_ransac_hypotheses)
    s0 = weighted_sample(out.overlap0 * out.saliency0, m0, n, uniforms[0])
    np.testing.assert_array_equal(s0.numpy(), ref_s0)
    ref_s1 = _reference_mask(ref_out.overlap1 * ref_out.saliency1,
                             ref_batch.pyr1.levels[0].mask, n,
                             jnp.asarray(uniforms[1].numpy()))
    s1 = weighted_sample(out.overlap1 * out.saliency1, m1, n, uniforms[1])
    np.testing.assert_array_equal(s1.numpy(), ref_s1)
    assert int(s0.sum()) == n

    _compare(tester.step(batch, uniforms=uniforms, stage_draws=draws), want)


class _OracleModel:
    """Stands in for the reference model: returns fixed outputs."""

    def __init__(self, out):
        self.out = out

    def apply(self, variables, pyr0, pyr1):
        return self.out


def test_eval_recovers_the_pose_with_oracle_features(slice_run):
    """Features that encode each point's position in cloud 1's frame make
    the feature NN the GT match: both sides register the pair, with the
    same transform, RTE and RRE."""
    tester, ref_tester = slice_run["tester"], slice_run["ref_tester"]
    cfg = tester.config
    pair = slice_run["pairs"][0]
    batch = tester._pair_to_batch(pair)
    ref_batch = ref_tester._pair_to_batch(pair)
    t_gt = batch.t_gt.numpy()
    rng = np.random.default_rng(0)
    freqs = rng.normal(size=(3, cfg.final_feats_dim // 2)) * 0.7

    def encode(xyz, mask):
        z = xyz @ freqs
        f = np.concatenate([np.sin(z), np.cos(z)], -1)
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
        return np.where(mask[:, None], f, 0.0).astype(np.float32)

    xyz0 = batch.pyr0.levels[0].points.numpy()
    xyz1 = batch.pyr1.levels[0].points.numpy()
    m0 = batch.pyr0.levels[0].mask.numpy()
    m1 = batch.pyr1.levels[0].mask.numpy()
    score = [rng.uniform(0.2, 1.0, m.shape).astype(np.float32) * m
             for m in (m0, m1)]
    arrays = dict(feats0=encode(xyz0 @ t_gt[:3, :3].T + t_gt[:3, 3], m0),
                  feats1=encode(xyz1, m1), overlap0=score[0],
                  overlap1=score[1], saliency0=np.ones_like(score[0]),
                  saliency1=np.ones_like(score[1]))
    oracle = type("Oracle", (), dict(model=_OracleModel(RefOutputs(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))))()
    key = jax.random.PRNGKey(5)
    want = RefTester(ref_tester.config, oracle, None)._step(
        {"model": None}, ref_batch, key)
    out = KPFCNNOutputs(**{k: T(v) for k, v in arrays.items()})
    s0 = _reference_mask(jnp.asarray(score[0]), jnp.asarray(m0),
                         cfg.test_subsample,
                         jax.random.uniform(jax.random.split(key, 3)[0],
                                            m0.shape, minval=1e-12))
    uniforms, draws = _reference_random(key, m0, m1, int(s0.sum()),
                                        cfg.test_num_ransac_hypotheses)
    got = tester.eval_one(out, batch, uniforms=uniforms, stage_draws=draws)
    _compare(got, want)
    assert float(got[1]) < 0.5 and float(got[2]) < 1.0


def test_test_pipelined_and_not(slice_run):
    tester, pairs = slice_run["tester"], slice_run["pairs"][:2]
    stats = tester.test(pairs, seed=0)
    assert len(stats.rte) == 2 and np.isfinite(stats.rte).all()
    assert np.isfinite(stats.rre).all() and np.isfinite(stats.fitness).all()
    again = tester.test(pairs, seed=0, pipelined=False)
    np.testing.assert_allclose(again.rte, stats.rte, rtol=1e-5)
    assert len(stats.sec_per_pair) == 1


class _Pairs:
    def __init__(self, pairs):
        self.pairs = pairs

    def __len__(self):
        return len(self.pairs)

    def get_pair(self, i):
        return self.pairs[i]


def test_calibrate_neighbors_matches(slice_run):
    data = _Pairs(slice_run["pairs"][:2])
    want = ref_calibrate(data, RefConfig(**FIELDS), samples_threshold=500)
    got = calibrate_neighbors(data, APRConfig(**FIELDS),
                              samples_threshold=500, device="cpu")
    assert got == want
    assert len(got) == 4 and min(got) > 0


def test_training_entry_points_run(slice_run):
    """The trainer of the eval slice trains: loss_fn, train_step and
    valid_step run on a pair with APC targets (their parity with the
    reference is held in tests/test_torch_predator_train.py), a symmetric
    trainer builds its KPFCNNDecoder, and an iter_size=2 trainer its
    gradient accumulation (held to the reference in
    tests/test_torch_predator_iter_size.py)."""
    from dataclasses import replace

    from apr_torch.data.synthetic import pad_points
    from apr_torch.models.kpfcnn import KPFCNNDecoder

    cfg = replace(slice_run["tester"].config, pos_radius=1.0,
                  safe_radius=2.5, matchability_radius=1.2, max_points=128)
    trainer = PredatorTrainer(cfg, device="cpu", seed=1)
    pair = synthetic_pair(7, n_points=2500, apc_points=1500, distance=6.0,
                          extent=30.0)
    p0, m0 = pad_points(pair["points0"], cfg.point_capacity)
    p1, m1 = pad_points(pair["points1"], cfg.point_capacity)
    a0, am0 = pad_points(pair["apc0"], 2048)
    a1, am1 = pad_points(pair["apc1"], 2048)
    batch = trainer.build_batch((p0, m0, p1, m1, a0, am0, a1, am1,
                                 pair["t_gt"]))
    gen = torch.Generator().manual_seed(0)
    loss, metrics = trainer.loss_fn(batch, gen)
    assert loss.requires_grad and np.isfinite(float(loss.detach()))
    before = [p.detach().clone() for p in trainer.parameters()]
    metrics = trainer.train_step(batch, gen)
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in
               zip(before, trainer.parameters()))
    valid = trainer.valid_step(batch, gen, w_saliency=1.0)
    assert all(np.isfinite(float(v)) for v in valid.values())
    sym = PredatorTrainer(APRConfig(**FIELDS, symmetric=True), device="cpu")
    assert isinstance(sym.generator, KPFCNNDecoder)
    accumulating = PredatorTrainer(APRConfig(**FIELDS, iter_size=2),
                                   device="cpu")
    assert accumulating.accumulation.every_k == 2
