"""apr_torch NN search, correspondences, Kabsch fits, RANSAC and metrics
against apr_tpu.

Indices match exactly.  Transforms within 1e-4 (float32 fits; the sums run
in another order); RTE/RRE within 1e-3.  RANSAC gets the reference's own
random draws, rebuilt from its key, so the two solve the same problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.geometry.kabsch import kabsch as ref_kabsch
from apr_tpu.geometry.kabsch import kabsch_fast as ref_kabsch_fast
from apr_tpu.geometry.se3 import rotation_from_euler
from apr_tpu.ops.chamfer import nn_distances as ref_nn
from apr_tpu.registration import matching as ref_matching
from apr_tpu.registration import metrics as ref_metrics
from apr_tpu.registration import ransac as ref_ransac
from apr_torch.geometry.kabsch import kabsch, kabsch_fast
from apr_torch.ops.chamfer import nn_distances
from apr_torch.registration.matching import feature_nn_correspondences
from apr_torch.registration.metrics import registration_errors, \
    registration_success
from apr_torch.registration.ransac import ransac_from_draws, ransac_pose, \
    stage_sizes, trials_needed

T = torch.from_numpy


def _rigid(rng, angle=0.5, trans=10.0):
    r = np.asarray(rotation_from_euler(
        jnp.asarray(rng.uniform(-angle, angle, 3), jnp.float32)))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = r
    t[:3, 3] = rng.uniform(-trans, trans, 3)
    return t


@pytest.mark.parametrize("dim,ns,block", [(3, 3000, 512), (128, 1500, 2048)])
def test_nn_distances_matches(rng, dim, ns, block):
    q = (rng.normal(size=(700, dim)) * (40 if dim == 3 else 1)).astype(
        np.float32)
    s = (rng.normal(size=(ns, dim)) * (40 if dim == 3 else 1)).astype(
        np.float32)
    s[5] = s[9]                      # a duplicate support: lowest wins
    q[:3] = s[9]
    mask = rng.random(ns) > 0.3
    mask[5] = mask[9] = True
    d2, idx = nn_distances(T(q), T(s), T(mask), block=block)
    rd2, ridx = ref_nn(jnp.asarray(q), jnp.asarray(s), jnp.asarray(mask),
                       block=block)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert (idx[:3] == 5).all()
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=1e-5,
                               atol=1e-4)


def test_nn_distances_no_valid_support(rng):
    q = rng.normal(size=(10, 3)).astype(np.float32)
    d2, idx = nn_distances(T(q), T(q), torch.zeros(10, dtype=torch.bool))
    assert torch.isinf(d2).all() and (idx == 10).all()


def test_feature_nn_correspondences_match(rng):
    f0 = rng.normal(size=(400, 32)).astype(np.float32)
    f1 = rng.normal(size=(900, 32)).astype(np.float32)
    m0, m1 = rng.random(400) > 0.2, rng.random(900) > 0.2
    got = feature_nn_correspondences(T(f0), T(f1), T(m0), T(m1))
    want = ref_matching.feature_nn_correspondences(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(m0), jnp.asarray(m1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kabsch_and_kabsch_fast_match(rng):
    t_gt = _rigid(rng)
    src = rng.uniform(-20, 20, (200, 3)).astype(np.float32)
    tgt = (src @ t_gt[:3, :3].T + t_gt[:3, 3]
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = (rng.random(200) > 0.3).astype(np.float32)
    got = kabsch(T(src), T(tgt), T(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_kabsch(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.asarray(w))), atol=1e-4)
    np.testing.assert_allclose(got, t_gt, atol=1e-2)
    # a batch of 4-point tuples of distinct points, as RANSAC scores them
    # (tuples with a repeated point are degenerate and gated out)
    tup = np.stack([rng.choice(200, 4, replace=False) for _ in range(64)])
    fast = kabsch_fast(T(src[tup]), T(tgt[tup])).numpy()
    want = np.asarray(jax.vmap(ref_kabsch_fast)(jnp.asarray(src[tup]),
                                                jnp.asarray(tgt[tup])))
    np.testing.assert_allclose(fast, want, atol=1e-4)


def test_trials_needed_matches():
    w = np.array([0.0, 0.01, 0.05, 0.3, 1.0], np.float32)
    got = trials_needed(T(w), 4, 0.999).numpy()
    want = np.asarray(ref_ransac.trials_needed(jnp.asarray(w), 4, 0.999))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _corr_set(rng, m=600, outlier_frac=0.5):
    t_gt = _rigid(rng)
    src = rng.uniform(-30, 30, (m, 3)).astype(np.float32)
    tgt = (src @ t_gt[:3, :3].T + t_gt[:3, 3]).astype(np.float32)
    bad = rng.random(m) < outlier_frac
    tgt[bad] = rng.uniform(-30, 30, (bad.sum(), 3))
    mask = rng.random(m) > 0.1
    return src, tgt, mask, t_gt


def _reference_draws(key, n_valid, sizes):
    """The reference's stage draws from its key (ransac.py:184, 195, 216)."""
    k_stage1, key = jax.random.split(key)
    hi = max(n_valid, 1)
    draws = [jax.random.randint(k_stage1, (sizes[0], 4), 0, hi)]
    for h in sizes[1:]:
        key, k_rung = jax.random.split(key)
        draws.append(jax.random.randint(k_rung, (h, 4), 0, hi))
    return [T(np.array(d)) for d in draws]


@pytest.mark.parametrize("esc", [
    dict(),                                              # escalation off
    dict(escalation_factor=2, escalation_rungs=2,        # two rungs fire
         escalation_min_inliers=10_000),
])
def test_ransac_from_draws_matches_reference(rng, esc):
    src, tgt, mask, t_gt = _corr_set(rng)
    key = jax.random.PRNGKey(11)
    h = 1024
    want = ref_ransac.ransac_pose(
        key, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        distance_threshold=0.3, num_hypotheses=h, hypothesis_chunk=256,
        **esc)
    sizes = stage_sizes(h, 256, esc.get("escalation_factor", 0),
                        esc.get("escalation_rungs", 1))
    assert len(sizes) == 1 + (2 if esc else 0)
    draws = _reference_draws(key, int(mask.sum()), sizes)
    got = ransac_from_draws(
        T(src), T(tgt), T(mask), draws, distance_threshold=0.3,
        hypothesis_chunk=256,
        escalation_min_inliers=esc.get("escalation_min_inliers", 30))
    np.testing.assert_allclose(got.transform.numpy(),
                               np.asarray(want.transform), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               rtol=1e-6)
    rte, rre = registration_errors(got.transform, T(t_gt))
    assert rte < 0.05 and rre < 0.5


def test_ransac_pose_draws_and_recovers(rng):
    src, tgt, mask, t_gt = _corr_set(rng, outlier_frac=0.6)
    res = ransac_pose(torch.Generator().manual_seed(0), T(src), T(tgt),
                      T(mask), distance_threshold=0.3, num_hypotheses=2048)
    assert bool(registration_success(res.transform, T(t_gt)))
    rte, rre = registration_errors(res.transform, T(t_gt))
    assert rte < 0.05 and rre < 0.5


def test_registration_errors_match(rng):
    a, b = _rigid(rng), _rigid(rng)
    rte, rre = registration_errors(T(a), T(b))
    wrte, wrre = ref_metrics.registration_errors(jnp.asarray(a),
                                                 jnp.asarray(b))
    np.testing.assert_allclose([float(rte), float(rre)],
                               [float(wrte), float(wrre)], rtol=1e-3)
    assert bool(registration_success(T(a), T(a)))
