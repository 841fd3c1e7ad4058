"""The port's small public functions that no ported path calls
(ROADMAP D2): ``registration/matching.py::{mutual_nn_correspondences,
find_nn, pose_estimation}``, ``registration/metrics.py::corr_dist`` and
``geometry/se3.py::{compose, inverse, random_rigid_transform}``, against
apr_tpu's on the CPU from the same seeded numpy inputs.

Tolerances: indices and masks exact (the same float32 feature search on
both sides); squared feature distances 1e-5 relative; the IRLS pose 1e-4
(20 float32 solves, as tests/test_torch_registration.py holds
``est_rigid_robust``); corr_dist, compose and inverse 1e-6;
random_rigid_transform 1e-6, both sides fed the same three uniforms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.geometry import se3 as ref_se3
from apr_tpu.registration import matching as ref_matching
from apr_tpu.registration import metrics as ref_metrics

from apr_torch.geometry import se3
from apr_torch.registration import matching, metrics


def _features(seed, n0=300, n1=350, c=32):
    rng = np.random.default_rng(seed)
    f0 = rng.normal(size=(n0, c)).astype(np.float32)
    f1 = np.concatenate([f0, rng.normal(size=(n1 - n0, c))])
    f1 = (f1 + rng.normal(0, 1.5, f1.shape)).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    m0 = rng.random(n0) < 0.9
    m1 = rng.random(n1) < 0.9
    return f0, f1, m0, m1, rng


@pytest.mark.parametrize("masked", [False, True])
def test_mutual_nn_and_find_nn_match(masked):
    f0, f1, m0, m1, _ = _features(0)
    m0, m1 = (m0, m1) if masked else (None, None)
    j = (lambda x: None if x is None else jnp.asarray(x))
    t = (lambda x: None if x is None else torch.from_numpy(x))
    want = ref_matching.mutual_nn_correspondences(j(f0), j(f1), j(m0), j(m1))
    got = matching.mutual_nn_correspondences(t(f0), t(f1), t(m0), t(m1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got.mask.sum()) < len(f0)
    want_idx, want_d2 = ref_matching.find_nn(j(f0), j(f1), j(m1))
    got_idx, got_d2 = matching.find_nn(t(f0), t(f1), t(m1))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_d2.numpy(), np.asarray(want_d2),
                               rtol=1e-5, atol=1e-6)


def test_pose_estimation_matches():
    f0, f1, m0, m1, rng = _features(1, 300, 300)
    xyz0 = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    a = 0.2
    t_gt = np.array([[np.cos(a), -np.sin(a), 0, 0.5],
                     [np.sin(a), np.cos(a), 0, -0.3], [0, 0, 1, 0.1],
                     [0, 0, 0, 1]], np.float32)
    xyz1 = (xyz0 @ t_gt[:3, :3].T + t_gt[:3, 3]).astype(np.float32)
    want_t, want_w = ref_matching.pose_estimation(
        jnp.asarray(xyz0), jnp.asarray(xyz1), jnp.asarray(f0),
        jnp.asarray(f1), jnp.asarray(m0), jnp.asarray(m1))
    th = torch.from_numpy
    got_t, got_w = matching.pose_estimation(th(xyz0), th(xyz1), th(f0),
                                            th(f1), th(m0), th(m1))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_corr_dist_matches(weighted):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    t_gt = np.eye(4, dtype=np.float32)
    t_est = np.eye(4, dtype=np.float32)
    t_est[:3, 3] = [0.3, 0.9, -0.2]
    w = rng.random(500).astype(np.float32) if weighted else None
    want = ref_metrics.corr_dist(jnp.asarray(t_est), jnp.asarray(t_gt),
                                 jnp.asarray(xyz),
                                 None if w is None else jnp.asarray(w))
    got = metrics.corr_dist(torch.from_numpy(t_est), torch.from_numpy(t_gt),
                            torch.from_numpy(xyz),
                            None if w is None else torch.from_numpy(w))
    assert abs(float(got) - float(want)) <= 1e-6


def test_compose_inverse_and_random_rigid_transform(monkeypatch):
    key = jax.random.PRNGKey(3)
    a = np.array(ref_se3.random_rigid_transform(key, 90.0))
    b = np.array(ref_se3.random_rigid_transform(jax.random.PRNGKey(4)))
    a[:3, 3] = [1.0, -2.0, 0.5]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(se3.compose(ta, tb).numpy(),
                               np.asarray(ref_se3.compose(a, b)), atol=1e-6)
    np.testing.assert_allclose(se3.inverse(ta).numpy(),
                               np.asarray(ref_se3.inverse(jnp.asarray(a))),
                               atol=1e-6)
    np.testing.assert_allclose((se3.inverse(ta) @ ta).numpy(), np.eye(4),
                               atol=1e-6)
    # the same three uniforms on both sides
    for k, deg in ((key, 90.0), (jax.random.PRNGKey(5), 360.0)):
        u = torch.from_numpy(np.array(jax.random.uniform(k, (3,))))
        monkeypatch.setattr(se3.torch, "rand",
                            lambda *a, _u=u, **kw: _u.clone())
        got = se3.random_rigid_transform(torch.Generator(), deg)
        monkeypatch.undo()
        want = np.asarray(ref_se3.random_rigid_transform(k, deg))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert got.dtype == torch.float32
    g = torch.Generator().manual_seed(0)
    r = se3.random_rigid_transform(g, 360.0)
    np.testing.assert_allclose((r[:3, :3].T @ r[:3, :3]).numpy(), np.eye(3),
                               atol=1e-6)
    assert not torch.equal(r, se3.random_rigid_transform(g, 360.0))
