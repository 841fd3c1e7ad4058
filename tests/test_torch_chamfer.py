"""apr_torch's exact and windowed Chamfer, the windowed NN search and the
APC dedup against apr_tpu on the same numpy inputs.

Tolerances: Chamfer values and gradients within 1e-5 relative (float32
sums in another order; the nearest neighbours chosen are the same, which
the index tests check exactly); the clamp fraction and every index and mask
exactly; the window functions are compared with the reference jitted, as
the train step runs them (XLA turns the division by the cell size into a
multiplication by its float32 reciprocal, which the port copies).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.ops.chamfer import chamfer_distance as ref_chamfer
from apr_tpu.ops.chamfer_window import chamfer_distance_window_stats as \
    ref_window_stats
from apr_tpu.ops.chamfer_window import windowed_nn_distances as ref_windowed
from apr_tpu.ops.voxelize import dedup_points as ref_dedup
from apr_torch.ops.chamfer import chamfer_distance
from apr_torch.ops.chamfer_window import chamfer_distance_window, \
    chamfer_distance_window_stats, windowed_nn_distances
from apr_torch.ops.voxelize import dedup_points

TOL = 1e-5


def _lidarish(rng, n, extent=20.0):
    """A dense ground layer and sparse structure above it."""
    ground = rng.uniform(-extent, extent, (n // 2, 3))
    ground[:, 2] = rng.normal(0, 0.2, n // 2)
    walls = rng.uniform(-extent, extent, (n - n // 2, 3))
    walls[:, 2] = np.abs(rng.normal(2.0, 1.5, n - n // 2))
    return np.concatenate([ground, walls]).astype(np.float32)


@pytest.fixture(scope="module")
def clouds():
    """Two pairs of clouds [2, N, 3] with masks, a few strays planted far
    from the other cloud so that the window clamp fires."""
    rng = np.random.default_rng(3)
    a = np.stack([_lidarish(rng, 900) for _ in range(2)])
    b = a[:, :700] + rng.normal(0, 0.15, (2, 700, 3)).astype(np.float32)
    a[0, :6] += 300.0
    b[1, :4] -= 300.0
    am = np.ones((2, 900), bool)
    am[1, 800:] = False
    bm = np.ones((2, 700), bool)
    bm[0, 650:] = False
    return a, b, am, bm


def _value_and_grad(fn, a, b, am, bm, weights=(1.0, 2.0)):
    """Port: value [B] and the gradients of sum_i weights[i] * value[i]."""
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    out = fn(ta, tb, torch.from_numpy(am), torch.from_numpy(bm))
    val = out[0] if isinstance(out, tuple) else out
    (val * torch.tensor(weights)).sum().backward()
    out = (tuple(o.detach() for o in out) if isinstance(out, tuple)
           else out.detach())
    return out, ta.grad.numpy(), tb.grad.numpy()


def test_exact_chamfer_value_and_grad(clouds):
    a, b, am, bm = clouds
    val, ga, gb = _value_and_grad(chamfer_distance, a, b, am, bm)
    for i, w in enumerate((1.0, 2.0)):
        rv, (rga, rgb) = jax.value_and_grad(
            lambda x, y: w * ref_chamfer(x, y, jnp.asarray(am[i]),
                                         jnp.asarray(bm[i])),
            argnums=(0, 1))(jnp.asarray(a[i]), jnp.asarray(b[i]))
        np.testing.assert_allclose(w * float(val[i]), float(rv), rtol=TOL)
        np.testing.assert_allclose(ga[i], np.asarray(rga), rtol=TOL,
                                   atol=1e-8)
        np.testing.assert_allclose(gb[i], np.asarray(rgb), rtol=TOL,
                                   atol=1e-8)
        # the exact backward masks with q_mask only: padded rows of b
        # still receive the scatter of a's queries that chose them
        assert (ga[i][~am[i]] == 0).all()


@pytest.mark.parametrize("cell,tile,window", [(1.2, 128, 1024),
                                              (2.0, 256, 512)])
def test_window_chamfer_value_grad_and_clamp_fraction(clouds, cell, tile,
                                                      window):
    a, b, am, bm = clouds
    (val, frac), ga, gb = _value_and_grad(
        partial(chamfer_distance_window_stats, cell_size=cell, tile=tile,
                window=window), a, b, am, bm)
    for i, w in enumerate((1.0, 2.0)):
        def ref(x, y):
            v, f = ref_window_stats(x, y, jnp.asarray(am[i]),
                                    jnp.asarray(bm[i]), cell, tile, window)
            return w * v, f

        (rv, rf), (rga, rgb) = jax.jit(jax.value_and_grad(
            ref, argnums=(0, 1), has_aux=True))(jnp.asarray(a[i]),
                                                jnp.asarray(b[i]))
        np.testing.assert_allclose(w * float(val[i]), float(rv), rtol=TOL)
        assert float(frac[i]) == float(rf)
        np.testing.assert_allclose(ga[i], np.asarray(rga), rtol=TOL,
                                   atol=1e-8)
        np.testing.assert_allclose(gb[i], np.asarray(rgb), rtol=TOL,
                                   atol=1e-8)
    assert float(frac[0]) > 0 and float(frac[1]) > 0    # the strays
    plain = chamfer_distance_window(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(am),
        torch.from_numpy(bm), cell_size=cell, tile=tile, window=window)
    torch.testing.assert_close(plain, val, rtol=0, atol=0)


def test_windowed_nn_indices_exact(clouds):
    """The GT-branch search: the same supports chosen, the same clamps."""
    a, b, am, bm = clouds
    d2, idx = windowed_nn_distances(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(am),
        torch.from_numpy(bm), cell_size=0.9, tile=64, window=512)
    assert idx.dtype == torch.int32
    for i in range(2):
        rd2, ridx = jax.jit(partial(ref_windowed, cell_size=0.9, tile=64,
                                    window=512))(
            jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(am[i]),
            jnp.asarray(bm[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ridx))
        np.testing.assert_allclose(d2[i].numpy(), np.asarray(rd2), rtol=TOL)
        assert (idx[i].numpy()[~am[i]] == 700).all()
        assert (idx[i].numpy() < 700).mean() > 0.5


def test_dedup_points_exact(rng):
    pts = rng.uniform(-6, 6, (3, 2000, 3)).astype(np.float32)
    pts[..., 2] *= 0.2
    pts[1, 1000:] = pts[1, :1000]             # exact duplicates
    pts[2, :50] = np.float32(0.3) * 7          # on a voxel face
    mask = rng.random((3, 2000)) > 0.1
    got_p, got_m = dedup_points(torch.from_numpy(pts), 0.3,
                                torch.from_numpy(mask))
    for i in range(3):
        want_p, want_m = jax.jit(partial(ref_dedup, voxel_size=0.3))(
            jnp.asarray(pts[i]), mask=jnp.asarray(mask[i]))
        np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_p[i].numpy(), np.asarray(want_p))
    assert int(got_m[1].sum()) < int(got_m[0].sum())
