"""Morton keys, voxelization, neighbour searches, pooling and GT
correspondences with cap > 1: apr_torch against the jitted apr_tpu
functions from the same numpy inputs.

Integers (keys, masks, rep, point_voxel, neighbour / pool / upsample
tables, correspondences) and barycenters must match exactly; pooled
features within 1e-6.  The reference runs jitted with its radii and
voxel sizes as compile-time constants, as ``build_kp_pyramid`` calls them.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.data.synthetic import pad_points as ref_pad_points
from apr_tpu.data.synthetic import synthetic_pair
from apr_tpu.registration.matching import gt_correspondences as ref_gt
from apr_torch.registration.matching import gt_correspondences

# the modules (both packages' ops re-export functions under some of these
# names)
ref_hashing, ref_nb, ref_pool, ref_vox = (
    importlib.import_module(f"apr_tpu.ops.{m}")
    for m in ("hashing", "neighbors", "pooling", "voxelize"))
hashing, neighbors, pooling, voxelize = (
    importlib.import_module(f"apr_torch.ops.{m}")
    for m in ("hashing", "neighbors", "pooling", "voxelize"))

T = torch.from_numpy
DL = 0.6
CAPS = (4096, 1024, 512, 256)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def clouds():
    """Two padded synthetic clouds and their level-0 and level-1
    barycenters (the reference's, the searches' inputs)."""
    d = synthetic_pair(5, n_points=4000, apc_points=4, distance=6.0,
                       extent=30.0)
    pts, msk = zip(*(ref_pad_points(d[k], 4608)
                     for k in ("points0", "points1")))
    build = jax.jit(partial(ref_vox.voxelize_pyramid, base_voxel=DL,
                            capacities=CAPS))
    grids = [build(jnp.asarray(p), mask=jnp.asarray(m))
             for p, m in zip(pts, msk)]
    lv = [(np.stack([np.asarray(g[l].barycenter) for g in grids]),
           np.stack([np.asarray(g[l].mask) for g in grids])) for l in (0, 1)]
    return dict(points=np.stack(pts), mask=np.stack(msk), grids=grids,
                levels=lv, t_gt=d["t_gt"])


def test_morton_pack_unpack_match(rng):
    coords = rng.integers(-600, 600, (5000, 3)).astype(np.int32)
    keys = hashing.morton_pack(T(coords))
    _eq(keys, ref_hashing.morton_pack(jnp.asarray(coords)))
    for level in range(4):
        k = keys >> (3 * level)
        _eq(hashing.morton_unpack(k, level),
            ref_hashing.morton_unpack(jnp.asarray(k.numpy()), level))
    inside = np.clip(coords, -512, 511)
    _eq(hashing.morton_unpack(hashing.morton_pack(T(inside))), inside)


@pytest.mark.parametrize("fn", ["voxelize", "voxelize_pyramid"])
def test_voxelize_matches(clouds, fn):
    pts, msk = clouds["points"], clouds["mask"]
    if fn == "voxelize":
        got = [voxelize.voxelize(T(pts), DL, CAPS[0], T(msk))]
        want = [[jax.jit(partial(ref_vox.voxelize, voxel_size=DL,
                                 capacity=CAPS[0]))(jnp.asarray(p),
                                                    mask=jnp.asarray(m))
                 for p, m in zip(pts, msk)]]
    else:
        got = voxelize.voxelize_pyramid(T(pts), DL, CAPS, T(msk))
        want = list(zip(*clouds["grids"]))
    assert len(got) == len(want)
    for g, ws in zip(got, want):
        for name in g._fields:
            w = np.stack([np.asarray(getattr(x, name)) for x in ws])
            # barycenters too: each run sums in the reference's order
            np.testing.assert_array_equal(getattr(g, name).numpy(), w,
                                          err_msg=name)
    assert 500 < int(got[0].mask.sum()) < 2 * CAPS[0]


@pytest.mark.parametrize("dim,k,masked", [(3, 1, False), (3, 8, True),
                                          (8, 5, True)])
def test_knn_matches(clouds, rng, dim, k, masked):
    (p0, m0), (p1, m1) = clouds["levels"]
    if dim == 3:
        q, s = p0, p1
    else:  # features: the matmul expansion at full float32
        q = rng.normal(size=p0.shape[:2] + (dim,)).astype(np.float32)
        s = rng.normal(size=p1.shape[:2] + (dim,)).astype(np.float32)
    qm, sm = (m0, m1) if masked else (None, None)
    idx, d2 = neighbors.knn(T(q), T(s), k,
                            None if qm is None else T(qm),
                            None if sm is None else T(sm), chunk=300)
    for b in range(2):
        want = jax.jit(partial(ref_nb.knn, k=k))(
            jnp.asarray(q[b]), jnp.asarray(s[b]),
            q_mask=None if qm is None else jnp.asarray(qm[b]),
            s_mask=None if sm is None else jnp.asarray(sm[b]))
        _eq(idx[b], want[0])
        np.testing.assert_allclose(d2[b].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius,cap", [(1.5, 16), (2.5, 40)])
def test_radius_neighbors_matches(clouds, radius, cap):
    (p0, m0), (p1, m1) = clouds["levels"]
    for q, qm in ((p0, m0), (p1, m1)):   # the conv and the pool table
        got = neighbors.radius_neighbors(T(q), T(p0), radius, cap, T(qm),
                                         T(m0))
        for b in range(2):
            want = jax.jit(lambda q, s, qm, sm: ref_nb.radius_neighbors(
                q, s, radius, cap, q_mask=qm, s_mask=sm))(
                    q[b], p0[b], qm[b], m0[b])
            _eq(got[b], want)
        assert int((got < p0.shape[1]).sum()) > 10 * q.shape[1]


def _ref_windowed(q, s, qm, sm, radius, cap, **kw):
    return jax.jit(lambda q, s, qm, sm: ref_nb.windowed_radius_neighbors(
        q, s, radius, cap, q_mask=qm, s_mask=sm, with_overflow=True,
        **kw))(q, s, qm, sm)


# the reference's k-smallest strategies; the port's one gives their table
@pytest.mark.parametrize("ref_select", ["topk", "tournament", "itermin"])
@pytest.mark.parametrize("masked_rows", [False, True])
def test_windowed_radius_neighbors_matches(clouds, rng, ref_select,
                                           masked_rows):
    (p0, m0), _ = clouds["levels"]
    qm = m0 & (rng.random(m0.shape) > 0.3) if masked_rows else m0
    kw = dict(tile=64, window=768)
    got, ovf = neighbors.windowed_radius_neighbors(
        T(p0), T(p0), 2.5, 24, T(qm), T(m0), with_overflow=True, **kw)
    for b in range(2):
        want, want_ovf = _ref_windowed(p0[b], p0[b], qm[b], m0[b], 2.5, 24,
                                       select_method=ref_select, **kw)
        _eq(got[b], want)
        assert float(ovf[b]) == float(want_ovf)
    assert bool((got[torch.from_numpy(~qm)] == p0.shape[1]).all())
    # at this density the windows hold every slab: exact radius neighbours
    assert float(ovf.max()) == 0.0
    _eq(got, neighbors.radius_neighbors(T(p0), T(p0), 2.5, 24, T(qm),
                                        T(m0)))


@pytest.mark.parametrize("site", ["pairwise", "window"])
def test_reference_contraction_order(rng, site):
    """``sq_norm`` emulates the fused multiply-adds that XLA's CPU compiler
    (jax / jaxlib 0.9.0) makes of the reference's squared distances: its
    ``sum(diff * diff, -1)`` (``_pairwise_sqdist``) and its window body's
    ``dx * dx + dy * dy + dz * dz``.  If a jax upgrade contracts them
    otherwise, this test names the cause before the exact-table tests fail
    without one."""
    q = rng.uniform(-60, 60, (512, 3)).astype(np.float32)
    s = (q[:128] + rng.normal(0, 0.3, (128, 3))).astype(np.float32)
    d = [q[:, None, c] - s[None, :, c] for c in range(3)]
    if site == "pairwise":
        want = np.asarray(jax.jit(ref_nb._pairwise_sqdist)(q, s))
        got = neighbors.sq_norm(*map(T, d)).numpy()
        order = "fma(dz, dz, fma(dy, dy, dx * dx))"
    else:
        want = np.asarray(jax.jit(
            lambda dx, dy, dz: dx * dx + dy * dy + dz * dz)(*d))
        got = neighbors.sq_norm(T(d[1]), T(d[0]), T(d[2])).numpy()
        order = "fma(dz, dz, fma(dx, dx, dy * dy))"
    unfused = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    assert (unfused != want).any(), "the inputs cannot tell orders apart"
    assert np.array_equal(got, want), (
        f"XLA's CPU build (jax {jax.__version__}) no longer computes the "
        f"reference's {site} squared distance as {order}: update "
        f"apr_torch.ops.neighbors.sq_norm and its callers")


def test_windowed_overflow_telemetry(clouds):
    """A window narrower than the slabs truncates, and the overflow
    fraction per cloud says so, as the reference's does."""
    (p0, m0), _ = clouds["levels"]
    got, ovf = neighbors.windowed_radius_neighbors(
        T(p0), T(p0), 2.5, 24, T(m0), T(m0), tile=64, window=96,
        with_overflow=True)
    for b in range(2):
        want, want_ovf = _ref_windowed(p0[b], p0[b], m0[b], m0[b], 2.5, 24,
                                       tile=64, window=96)
        _eq(got[b], want)
        assert float(ovf[b]) == float(want_ovf) > 0.1


def test_pooling_matches(clouds, rng):
    (p0, m0), (p1, m1) = clouds["levels"]
    feats = rng.normal(size=p0.shape[:2] + (6,)).astype(np.float32)
    table = neighbors.radius_neighbors(T(p1), T(p0), 2.5, 16, T(m1), T(m0))
    seg = rng.integers(0, 41, p0.shape[:2]).astype(np.int32)
    got = (pooling.gather_neighbors(T(feats), table),
           pooling.max_pool_neighbors(T(feats), table),
           pooling.segment_mean_capped(T(feats), T(seg), 40))
    want = (ref_pool.gather_neighbors(jnp.asarray(feats),
                                      jnp.asarray(table.numpy())),
            ref_pool.max_pool_neighbors(jnp.asarray(feats),
                                        jnp.asarray(table.numpy())),
            np.stack([ref_pool.segment_mean_capped(
                jnp.asarray(feats[b]), jnp.asarray(seg[b]), 40)
                for b in range(2)]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_gt_correspondences_cap2_matches(clouds):
    (p0, m0), _ = clouds["levels"]
    t_gt = clouds["t_gt"].astype(np.float32)
    got = gt_correspondences(T(p0[:1]), T(p0[1:]), T(t_gt[None]), 1.2,
                             cap_per_point=2, mask0=T(m0[:1]),
                             mask1=T(m0[1:]))
    want = jax.jit(lambda a, b, t, ma, mb: ref_gt(
        a, b, t, radius=1.2, cap_per_point=2, mask0=ma, mask1=mb))(
            p0[0], p0[1], t_gt, m0[0], m0[1])
    for g, w in zip(got, want):
        _eq(g[0], w)
    assert int(got.mask.sum()) > 500


def test_gt_correspondences_cap_above_one_no_longer_raises(clouds):
    """cap_per_point > 1 raised NotImplementedError before the radius
    search was ported; every cap now gives a [B, N0 * cap] table."""
    (p0, m0), _ = clouds["levels"]
    eye = torch.eye(4)[None]
    for cap in (2, 3):
        corr = gt_correspondences(T(p0[:1]), T(p0[:1]), eye, 0.5,
                                  cap_per_point=cap, mask0=T(m0[:1]),
                                  mask1=T(m0[:1]))
        assert corr.tgt_idx.shape == (1, p0.shape[1] * cap)
        # every valid point matches itself first
        first = corr.tgt_idx[0].reshape(-1, cap)[:, 0]
        valid = T(m0[0])
        _eq(first[valid], np.nonzero(m0[0])[0])
