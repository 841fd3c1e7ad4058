"""Kernel K2's plain version (the CPU path of apr_torch's nn_min) against the
Pallas kernel in interpret mode, and the Chamfer built on it against the
Pallas custom VJP.

Tolerances: on grid inputs (multiples of 1/8) every product and sum is
exact, so d2 and idx agree exactly; on random floats d2 agrees within 1e-6
relative (the Pallas body may contract a product and a sum), and idx
wherever the two nearest distances are further apart than that.  Values and
gradients of the mean-squared-NN losses: 1e-5 (float32 sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.ops.pallas.distance import chamfer_distance_pallas as \
    ref_chamfer_pallas
from apr_tpu.ops.pallas.distance import directed_mean_sq_nn_pallas as \
    ref_directed
from apr_tpu.ops.pallas.distance import nn_min_pallas
from apr_torch.ops.distance import chamfer_distance_pallas, \
    directed_mean_sq_nn_pallas, nn_min, nn_min_plain

TOL = 1e-5


def _ref(q, s, m):
    d2, idx = nn_min_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(m),
                            tq=128, ts=256, interpret=True)
    return np.asarray(d2), np.asarray(idx)


def _port(q, s, m):
    d2, idx = nn_min(torch.from_numpy(q)[None], torch.from_numpy(s)[None],
                     torch.from_numpy(m)[None])
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    return d2[0].numpy(), idx[0].numpy()


def _grid(rng, n, scale):
    return (rng.integers(-8 * scale, 8 * scale, (n, 3)) / 8.0).astype(
        np.float32)


@pytest.mark.parametrize("nq,ns", [(300, 700), (129, 257), (512, 2048)])
def test_grid_inputs_exact(rng, nq, ns):
    """Multiples of 1/8: exact products, many ties (lowest index wins)."""
    q, s = _grid(rng, nq, 4), _grid(rng, ns, 4)
    m = rng.random(ns) > 0.2
    got, want = _port(q, s, m), _ref(q, s, m)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_random_lidar_scale(rng):
    q = rng.uniform(-80, 80, (700, 3)).astype(np.float32)
    s = rng.uniform(-80, 80, (1500, 3)).astype(np.float32)
    m = np.ones(1500, bool)
    (d2, idx), (rd2, ridx) = _port(q, s, m), _ref(q, s, m)
    np.testing.assert_allclose(d2, rd2, rtol=1e-6)
    full = ((q[:, None, :].astype(np.float64) - s[None]) ** 2).sum(-1)
    two = np.sort(full, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-6 * two[:, 1]
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(idx[clear], ridx[clear])


def test_masked_and_all_masked(rng):
    q = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    s = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    m = np.zeros(300, bool)
    m[:50] = True
    (d2, idx), (rd2, ridx) = _port(q, s, m), _ref(q, s, m)
    assert (idx < 50).all()
    np.testing.assert_allclose(d2, rd2, rtol=1e-6)
    np.testing.assert_array_equal(idx, ridx)
    (d2, idx), (rd2, ridx) = _port(q, s, np.zeros(300, bool)), _ref(
        q, s, np.zeros(300, bool))
    assert np.isinf(d2).all() and np.isinf(rd2).all()
    assert (idx == 300).all() and (ridx == 300).all()


def test_batched_clouds_with_their_own_masks(rng):
    """One call over B clouds equals B single-cloud calls."""
    q = _grid(rng, 3 * 200, 2).reshape(3, 200, 3)
    s = _grid(rng, 3 * 333, 2).reshape(3, 333, 3)
    m = rng.random((3, 333)) > np.array([[0.0], [0.5], [1.0]])
    d2, idx = nn_min(torch.from_numpy(q), torch.from_numpy(s),
                     torch.from_numpy(m))
    for i in range(3):
        rd2, ridx = _ref(q[i], s[i], m[i])
        np.testing.assert_array_equal(d2[i].numpy(), rd2)
        np.testing.assert_array_equal(idx[i].numpy(), ridx)


def test_wrapper_checks_and_counts_no_cpu_launch(rng):
    q = torch.from_numpy(_grid(rng, 40, 2))[None]
    s = torch.from_numpy(_grid(rng, 50, 2))[None]
    before = nn_min.launches
    d2, idx = nn_min(q, s)
    want = nn_min_plain(q, s, torch.ones((1, 50), dtype=torch.bool))
    assert torch.equal(d2, want[0]) and torch.equal(idx, want[1])
    assert nn_min.launches == before
    with pytest.raises(TypeError):
        nn_min(q.double(), s.double())
    with pytest.raises(ValueError):
        nn_min(q[0], s[0])


def _clouds(rng, b=2):
    a = rng.uniform(-20, 20, (b, 300, 3)).astype(np.float32)
    c = rng.uniform(-20, 20, (b, 500, 3)).astype(np.float32)
    am = np.ones((b, 300), bool)
    am[0, 250:] = False
    cm = np.ones((b, 500), bool)
    cm[1, 420:] = False
    return a, c, am, cm


def test_directed_mean_value_and_grad_match_pallas_vjp(rng):
    a, c, am, cm = _clouds(rng)
    ta, tc = (torch.from_numpy(x).requires_grad_() for x in (a, c))
    val = directed_mean_sq_nn_pallas(ta, tc, torch.from_numpy(am),
                                     torch.from_numpy(cm))
    val.sum().backward()
    for i in range(a.shape[0]):
        rv, (ga, gc) = jax.value_and_grad(ref_directed, argnums=(0, 1))(
            jnp.asarray(a[i]), jnp.asarray(c[i]), jnp.asarray(am[i]),
            jnp.asarray(cm[i]))
        np.testing.assert_allclose(float(val[i].detach()), float(rv), rtol=TOL)
        np.testing.assert_allclose(ta.grad[i].numpy(), np.asarray(ga),
                                   rtol=TOL, atol=1e-7)
        np.testing.assert_allclose(tc.grad[i].numpy(), np.asarray(gc),
                                   rtol=TOL, atol=1e-7)


def test_chamfer_pallas_value_and_grad_match(rng):
    a, c, am, cm = _clouds(rng)
    ta, tc = (torch.from_numpy(x).requires_grad_() for x in (a, c))
    val = chamfer_distance_pallas(ta, tc, torch.from_numpy(am),
                                  torch.from_numpy(cm))
    (val * torch.tensor([1.0, 2.0])).sum().backward()
    for i in range(a.shape[0]):
        rv, (ga, gc) = jax.value_and_grad(
            lambda x, y: (1.0 + i) * ref_chamfer_pallas(
                x, y, jnp.asarray(am[i]), jnp.asarray(cm[i])),
            argnums=(0, 1))(jnp.asarray(a[i]), jnp.asarray(c[i]))
        np.testing.assert_allclose((1.0 + i) * float(val[i].detach()),
                                   float(rv), rtol=TOL)
        np.testing.assert_allclose(ta.grad[i].numpy(), np.asarray(ga),
                                   rtol=TOL, atol=1e-7)
        np.testing.assert_allclose(tc.grad[i].numpy(), np.asarray(gc),
                                   rtol=TOL, atol=1e-7)
