"""The registration-eval slice end to end: apr_torch against apr_tpu on one
synthetic pair, stage by stage, each stage fed the reference's own output
of the stage before.

- synthetic pair, batch (keys, masks, maps, representative points): exact;
- features from the same (bridged) weights: float32 within 1e-4;
- subsample order and feature-NN correspondences, given the same features
  and the reference's random scores: exact;
- transform within 1e-4 and RTE/RRE within 1e-3, given the same
  correspondences and the reference's RANSAC draws.
Then the port's own chained path runs once and must give finite outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.synthetic import synthetic_pair as ref_synthetic_pair
from apr_tpu.eval import FeatureTester as RefTester
from apr_tpu.registration.matching import feature_nn_correspondences as \
    ref_feature_nn
from apr_tpu.training import get_trainer
from apr_torch.bridge import load_flax_resunet_
from apr_torch.config import APRConfig
from apr_torch.data.synthetic import synthetic_pair
from apr_torch.eval import FeatureTester
from apr_torch.registration.matching import feature_nn_correspondences
from apr_torch.training.trainer import FCGFTrainer
from test_torch_resunet import random_variables

FIELDS = dict(
    trainer="HardestContrastiveLossTrainer", model="ResUNetFatBN",
    model_n_out=32, conv1_kernel_size=5, voxel_size=0.6,
    point_capacity=4096, capacities=(2048, 1024, 512, 256),
    compute_dtype="float32", test_subsample=500,
    test_num_ransac_hypotheses=1024,
)
PAIR = dict(seed=3, n_points=4000, apc_points=4, distance=8.0, extent=30.0)


@pytest.fixture(scope="module")
def slice_run():
    pair = synthetic_pair(**PAIR)
    ref_pair = ref_synthetic_pair(**PAIR)
    for k in ("points0", "points1", "t_gt"):
        np.testing.assert_array_equal(pair[k], ref_pair[k])

    ref_cfg = RefConfig(**FIELDS)
    ref_trainer = get_trainer(ref_cfg)
    ref_tester = RefTester(ref_cfg, ref_trainer, None)
    ref_batch = ref_tester._pair_to_batch(pair)
    enc_params, enc_stats = random_variables(
        ref_trainer.encoder, ref_batch.feats0, ref_batch.pyramid0)
    params, stats = {"encoder": enc_params}, {"encoder": enc_stats}
    ref_f0, ref_f1, _ = jax.jit(
        lambda p, s, b: ref_trainer._encode_pair(p, s, b, False))(
            params, stats, ref_batch)

    cfg = APRConfig(**FIELDS)
    trainer = FCGFTrainer(cfg, device="cpu")
    load_flax_resunet_(trainer.encoder, params["encoder"], stats["encoder"])
    tester = FeatureTester(cfg, trainer, device="cpu")
    batch = tester._pair_to_batch(pair)
    f0, f1 = trainer._encode_pair(batch)
    return dict(pair=pair, ref_tester=ref_tester, ref_batch=ref_batch,
                params=params, stats=stats, ref_f=(ref_f0, ref_f1),
                tester=tester, batch=batch, f=(f0, f1))


def test_config_loads_the_reference_config():
    """A reference config dict loads into the port's config: the fields the
    slice reads keep their values, the rest are dropped."""
    cfg = APRConfig.from_dict(RefConfig(**FIELDS).to_dict())
    assert cfg == APRConfig(**FIELDS)
    ref = RefConfig()
    for name, value in APRConfig().__dict__.items():
        assert getattr(ref, name) == value, name


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_matches_exactly(slice_run):
    batch, ref = slice_run["batch"], slice_run["ref_batch"]
    for side in ("pyramid0", "pyramid1"):
        got = jax.tree_util.tree_leaves(getattr(batch, side))
        want = jax.tree_util.tree_leaves(getattr(ref, side))
        assert len(got) == len(want) == 4 * 3 + 4 + 3 + 3 + 1
        for g, w in zip(got, want):
            _eq(g, w)
    for name in ("feats0", "feats1", "xyz0", "xyz1", "t_gt"):
        _eq(getattr(batch, name), getattr(ref, name))
    assert int(batch.pyramid0.levels[0].mask.sum()) > 500


def test_features_match(slice_run):
    for g, w in zip(slice_run["f"], slice_run["ref_f"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_eval_matches_given_reference_features_and_draws(slice_run):
    ref_tester, ref_batch = slice_run["ref_tester"], slice_run["ref_batch"]
    tester, cfg = slice_run["tester"], slice_run["tester"].config
    rf0, rf1 = (np.array(f[0]) for f in slice_run["ref_f"])
    m0 = np.array(ref_batch.pyramid0.levels[0].mask[0])
    m1 = np.array(ref_batch.pyramid1.levels[0].mask[0])
    xyz0, xyz1 = np.array(ref_batch.xyz0[0]), np.array(ref_batch.xyz1[0])
    t_gt = np.array(ref_batch.t_gt[0])
    key = jax.random.PRNGKey(7)
    want = ref_tester._eval_one(
        slice_run["params"], slice_run["stats"], jnp.asarray(rf0),
        jnp.asarray(rf1), jnp.asarray(xyz0), jnp.asarray(xyz1),
        jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(t_gt), key)

    # the reference's random numbers (tester.py:111-116, ransac.py:184-195)
    k_sub, k_ransac = jax.random.split(key)
    scores = jnp.where(m0, jax.random.uniform(k_sub, m0.shape), -1.0)
    top, sel = jax.lax.approx_max_k(scores, cfg.test_subsample)
    ref_corr = ref_feature_nn(jnp.asarray(rf0)[sel], jnp.asarray(rf1),
                              top >= 0.0, jnp.asarray(m1))
    k_stage1, _ = jax.random.split(k_ransac)
    draws = [torch.from_numpy(np.array(jax.random.randint(
        k_stage1, (cfg.test_num_ransac_hypotheses, 4), 0,
        max(int(ref_corr.mask.sum()), 1))))]

    t_scores = torch.from_numpy(np.array(scores))
    order = torch.sort(t_scores, descending=True, stable=True).indices
    _eq(order[:cfg.test_subsample], sel)
    corr = feature_nn_correspondences(
        torch.from_numpy(rf0)[order[:cfg.test_subsample]],
        torch.from_numpy(rf1),
        t_scores[order[:cfg.test_subsample]] >= 0.0, torch.from_numpy(m1))
    for g, w in zip(corr, ref_corr):
        _eq(g, w)

    t_est, rte, rre, fitness = tester.eval_one(
        torch.from_numpy(rf0), torch.from_numpy(rf1), torch.from_numpy(xyz0),
        torch.from_numpy(xyz1), torch.from_numpy(m0), torch.from_numpy(m1),
        torch.from_numpy(t_gt), scores=t_scores, stage_draws=draws)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose([float(rte), float(rre)],
                               [float(want[1]), float(want[2])],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(fitness), float(want[3]), rtol=1e-6)


def test_bucketed_batch_matches_reference_tiers(slice_run):
    from apr_tpu.eval.bucketing import bucket_for_pair as ref_bucket
    from apr_torch.eval.bucketing import bucket_for_pair

    pair, tester = slice_run["pair"], slice_run["tester"]
    for tiers in (1, 2, 3):
        got = bucket_for_pair(pair, 0.6, FIELDS["capacities"], 4096, tiers)
        assert got == ref_bucket(pair, 0.6, FIELDS["capacities"], 4096,
                                 tiers)
    tester.config.test_capacity_buckets = 2
    try:
        batch = tester._bucketed_batch(pair)
    finally:
        tester.config.test_capacity_buckets = None
    pc, caps = bucket_for_pair(pair, 0.6, FIELDS["capacities"], 4096, 2)
    assert [lv.keys.shape[1] for lv in batch.pyramid0.levels] == list(caps)


def test_chained_port_path_is_finite(slice_run):
    tester = slice_run["tester"]
    stats = tester.test([slice_run["pair"]] * 2, seed=0)
    assert len(stats.rte) == 2 and np.isfinite(stats.rte).all()
    assert np.isfinite(stats.rre).all() and np.isfinite(stats.fitness).all()
    s2 = tester.test([slice_run["pair"]] * 2, seed=0, pipelined=False)
    np.testing.assert_allclose(s2.rte, stats.rte, rtol=1e-5)
