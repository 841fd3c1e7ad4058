"""apr_torch sparse pyramid and sparse conv against apr_tpu.

Kernel maps are integer tables: exact.  sparse_conv_apply: float32 within
1e-5 (only the summation order differs); bf16 operands within 1e-2 of the
reference's bf16 dot (both round the operands to bf16 and sum in float32).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.models import sparse as ref_sparse
from apr_tpu.ops.voxelize import voxelize_lean as ref_voxelize_lean
from apr_torch.models import sparse
from apr_torch.ops.voxelize import voxelize_lean

CAPS = (1024, 512, 256, 128)


def _clouds(rng, b=2, n=3000, span=14.0, voxel=0.5):
    pts = rng.uniform(-span, span, (b, n, 3)).astype(np.float32)
    pts[:, :, 2] *= 0.3                      # flat-ish, like a LiDAR scene
    mask = rng.random((b, n)) > 0.1
    return pts, mask, voxel


def _port_level0(pts, mask, voxel):
    coords, keys, vmask, _ = voxelize_lean(
        torch.from_numpy(pts), voxel, CAPS[0], torch.from_numpy(mask))
    return sparse.SparseLevel(coords, keys, vmask)


@jax.jit
def _ref_pyramids(pts, mask):
    def one(p, m):
        coords, keys, vmask, _ = ref_voxelize_lean(p, 0.5, CAPS[0], m)
        return ref_sparse.build_pyramid_from_level(
            ref_sparse.SparseLevel(coords, keys, vmask), CAPS, 5)
    return jax.vmap(one)(pts, mask)


@pytest.fixture(scope="module")
def pyramids():
    pts, mask, voxel = _clouds(np.random.default_rng(0))
    port = sparse.build_pyramid_from_level(_port_level0(pts, mask, voxel),
                                           CAPS, 5)
    ref = _ref_pyramids(jnp.asarray(pts), jnp.asarray(mask))
    return port, ref


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pyramid_levels_match(pyramids):
    port, ref = pyramids
    for lp, lr in zip(port.levels, ref.levels):
        for g, w in zip(lp, lr):
            _eq(g, w)
    assert int(port.levels[1].mask.sum()) > 100   # real data, not padding


@pytest.mark.parametrize("field", ["conv1_map", "same_maps", "down_maps",
                                   "up_maps"])
def test_pyramid_maps_match_exactly(pyramids, field):
    port, ref = pyramids
    got, want = getattr(port, field), getattr(ref, field)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == torch.int32
        _eq(g, w)


def test_fast_maps_match_slow_oracles(pyramids):
    port, _ = pyramids
    lv0, lv1 = port.levels[0], port.levels[1]
    _eq(port.conv1_map, sparse.kernel_map_same(lv0, 5).numpy())
    _eq(port.same_maps[1], sparse.kernel_map_same(lv1, 3).numpy())
    _eq(port.down_maps[0], sparse.kernel_map_down(lv1, lv0, 3).numpy())
    # and the oracles match the reference's oracles
    ref_lv = ref_sparse.SparseLevel(*(jnp.asarray(x[0].numpy()) for x in lv0))
    _eq(sparse.kernel_map_same(lv0, 3)[0],
        ref_sparse.kernel_map_same(ref_lv, 3))


def test_downsample_level_matches(rng):
    pts, mask, voxel = _clouds(rng, b=2, n=2000)
    lv0 = _port_level0(pts, mask, voxel)
    ref_lv = ref_sparse.SparseLevel(*(jnp.asarray(x.numpy()) for x in lv0))
    for cap in (512, 64):                    # 64 overflows: smallest kept
        got = sparse.downsample_level(lv0, cap)
        want = jax.jit(jax.vmap(partial(ref_sparse.downsample_level,
                                        capacity=cap)))(ref_lv)
        for g, w in zip(got, want):
            _eq(g, w)


def test_transpose_kernel_map_matches(pyramids):
    port, _ = pyramids
    down = port.down_maps[0]
    got = sparse.transpose_kernel_map(down, CAPS[0], CAPS[1])
    for i in range(down.shape[0]):
        want = ref_sparse.transpose_kernel_map(
            jnp.asarray(down[i].numpy()), CAPS[0], CAPS[1])
        _eq(got[i], want)


@pytest.mark.parametrize("dtype,tol", [(None, 1e-5), ("bfloat16", 1e-2)])
def test_sparse_conv_apply_matches(pyramids, rng, dtype, tol):
    port, _ = pyramids
    table = port.same_maps[0][0]                       # [C0, 27]
    n = table.shape[0]
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    w = rng.normal(size=(27, 16, 8)).astype(np.float32) * 0.2
    mask = port.levels[0].mask[0]
    got = sparse.sparse_conv_apply(
        torch.from_numpy(feats), table, torch.from_numpy(w), mask,
        getattr(torch, dtype) if dtype else None)
    want = np.asarray(ref_sparse.sparse_conv_apply(
        jnp.asarray(feats), jnp.asarray(table.numpy()), jnp.asarray(w),
        jnp.asarray(mask.numpy()), jnp.dtype(dtype) if dtype else None))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("conv1,searches", [(5, 7), (1, 8)])
def test_pyramid_build_makes_one_grouped_search(pyramids, monkeypatch,
                                                conv1, searches):
    """Every map of a build comes from one searchsorted_left_many call (7
    searches; 8 when conv1 does not cover the level-0 3^3 map), and the
    maps equal the fixture's, which equal apr_tpu's."""
    port, _ = pyramids
    calls, grouped = [], sparse.searchsorted_left_many

    def spy(s):
        calls.append(len(s))
        return grouped(s)

    monkeypatch.setattr(sparse, "searchsorted_left_many", spy)
    again = sparse.build_pyramid_from_level(port.levels[0], CAPS, conv1)
    assert calls == [searches]
    for got, want in zip(again.same_maps + again.down_maps + again.up_maps,
                         port.same_maps + port.down_maps + port.up_maps):
        assert torch.equal(got, want)
    if conv1 == 5:
        assert torch.equal(again.conv1_map, port.conv1_map)
