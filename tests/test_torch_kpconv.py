"""The KP pyramid, the kernel points, KPConvLayer and the KPConv blocks:
apr_torch against apr_tpu from the same numpy inputs and bridged weights.

- ``build_kp_pyramid`` (jitted reference): every table and the
  barycenters exact, on a small pyramid, on one whose level 0 goes
  through the windowed search, and on a dense slab whose windows overflow
  (the exact fallback reruns);
- kernel dispositions: equal to the reference's;
- ``KPConvLayer`` (rigid, ones input, on a pool table, on sparse rows,
  deformable with zero offsets, modulated) and the blocks (unary,
  simple, bottleneck, strided): float32 within 1e-5 of the output's scale; bf16 within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.data.synthetic import pad_points, synthetic_pair
from apr_tpu.models import kpconv as ref
from apr_tpu.models.kernel_points import load_kernels as ref_load_kernels
from apr_tpu.models.kernel_points import \
    optimize_kernel_points as ref_optimize
from apr_torch.bridge import kpfcnn_state_dict
from apr_torch.models import kpconv
from apr_torch.models.kernel_points import load_kernels, \
    optimize_kernel_points

T = torch.from_numpy
SMALL = dict(first_subsampling_dl=1.0, conv_radius=2.5, num_levels=4,
             capacities=(1024, 512, 256, 128), neighbor_limits=(16,) * 4)
WINDOWED = dict(first_subsampling_dl=0.3, conv_radius=4.25, num_levels=4,
                capacities=(8192, 2048, 1024, 512), neighbor_limits=(40,) * 4)


def _clouds(kind):
    if kind == "slab":
        # every point in a 2 m x-slab: each tile's slab overflows the window
        rng = np.random.default_rng(0)
        n = 20000
        raw = [np.column_stack([rng.uniform(0, 2, n), rng.uniform(-40, 40, n),
                                rng.uniform(0, 3, n)]).astype(np.float32)
               for _ in range(2)]
    else:
        d = synthetic_pair(3, n_points=30000 if kind == "windowed" else 2500,
                           apc_points=4, extent=60.0 if kind == "windowed"
                           else 30.0, distance=8.0)
        raw = [d["points0"], d["points1"]]
    pts, msk = zip(*(pad_points(r, 32768 if kind != "small" else 3000)
                     for r in raw))
    return np.stack(pts), np.stack(msk)


@pytest.mark.parametrize("kind", ["small", "windowed", "slab"])
def test_build_kp_pyramid_matches(kind):
    cfg = SMALL if kind == "small" else WINDOWED
    pts, msk = _clouds(kind)
    fb = kpconv.build_kp_pyramid.fallbacks
    got = kpconv.build_kp_pyramid(T(pts), T(msk), **cfg)
    fallbacks = kpconv.build_kp_pyramid.fallbacks - fb
    build = jax.jit(lambda p, m: ref.build_kp_pyramid(p, m, **cfg))
    for b in range(2):
        want = build(pts[b], msk[b])
        for lv, rlv in zip(got.levels, want.levels):
            for name in lv._fields:
                np.testing.assert_array_equal(getattr(lv, name)[b].numpy(),
                                              np.asarray(getattr(rlv, name)),
                                              err_msg=name)
    # the slab overflows both windowed searches of level 0 in both clouds
    assert fallbacks == (4 if kind == "slab" else 0)
    assert int((got.levels[0].neighbors < got.levels[0].points.shape[1])
               .sum()) > 4 * int(got.levels[0].mask.sum())


def test_kernel_points_match():
    for k in (15, 7):
        np.testing.assert_array_equal(
            load_kernels(1.7, k, deterministic=True),
            ref_load_kernels(1.7, k, deterministic=True))
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(load_kernels(1.7, 15, rng=rng_a),
                                  ref_load_kernels(1.7, 15, rng=rng_b))
    np.testing.assert_array_equal(optimize_kernel_points(9, num_iter=300),
                                  ref_optimize(9, num_iter=300))


@pytest.fixture(scope="module")
def level():
    """Stacked level-0 and level-1 arrays of a small pair pyramid."""
    pts, msk = _clouds("small")
    pyr = kpconv.build_kp_pyramid(T(pts), T(msk), **SMALL)
    l0, l1 = pyr.levels[:2]
    return {k: v.numpy() for k, v in dict(
        p0=l0.points, m0=l0.mask, nb0=l0.neighbors, pools=l0.pools,
        p1=l1.points, m1=l1.mask).items()}


def _randomize(variables, seed, offset_scale=1.0, zero=()):
    """Every param leaf but the kernel points drawn from numpy (norm
    scales around 1, biases and kernels around 0; the offset conv's times
    ``offset_scale``), so that the bridge of each matters; leaves under a
    module named in ``zero`` are zero."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [k.key for k in path]
        if names[-1] == "kernel_points":
            return np.asarray(leaf)
        if any(n in zero for n in names):
            return np.zeros(leaf.shape, np.float32)
        if names[-1] == "scale":
            return rng.uniform(0.6, 1.4, leaf.shape).astype(np.float32)
        bound = np.sqrt(3.0 / max(np.prod(leaf.shape[:-1]), 1))
        scale = offset_scale if "offset_conv" in names else 1.0
        return (scale * rng.uniform(-bound, bound, leaf.shape)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables["params"])


def _run_both(ref_mod, mod, args, seed=0, offset_scale=1.0, zero=()):
    jargs = [jnp.asarray(a) for a in args]
    params = _randomize(jax.jit(ref_mod.init)(jax.random.PRNGKey(0), *jargs),
                        seed, offset_scale, zero)
    want = np.asarray(jax.jit(ref_mod.apply)({"params": params}, *jargs))
    mod.load_state_dict(kpfcnn_state_dict(jax.device_get(params)),
                        strict=True)
    with torch.no_grad():
        got = mod(*[T(np.asarray(a)) for a in args]).numpy()
    return got, want


LAYERS = {
    "rigid": dict(),
    "ones_input": dict(ones_input=True),
    "pool_table": dict(),     # coarse queries into the finer level
    "sparse_rows": dict(),    # most neighbour slots on the shadow row
    "deformable_zero_offsets": dict(deformable=True),
    "modulated": dict(deformable=True, modulated=True),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_kpconv_layer_matches(level, rng, name):
    kw = LAYERS[name]
    cin = 1 if kw.get("ones_input") else 8
    x = rng.normal(size=level["p0"].shape[:2] + (cin,)).astype(np.float32)
    if cin == 1:
        x = np.ones_like(x)
    x = np.where(level["m0"][..., None], x, 0.0).astype(np.float32)
    q, nb = level["p0"], level["nb0"]
    if name == "pool_table":
        q, nb = level["p1"], level["pools"]
    elif name == "sparse_rows":
        nb = np.where(rng.random(nb.shape) < 0.7, level["p0"].shape[1],
                      nb).astype(np.int32)
    args = (q, level["p0"], nb, x)
    # zero offsets: the offset conv and its bias are zero
    zero = (("offset_conv", "offset_bias") if name == "deformable_zero_offsets"
            else ())
    got, want = _run_both(ref.KPConvLayer(12, 1.2, 2.5, **kw),
                          kpconv.KPConvLayer(cin, 12, 1.2, 2.5, **kw), args,
                          offset_scale=0.2 if name == "modulated" else 1.0,
                          zero=zero)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert float(np.abs(want).max()) > 0.1


def test_kpconv_layer_bf16_within_tolerance(level, rng):
    """bf16 operands, float32 accumulation: within 2e-2 of the output's
    scale of the reference's bf16 layer (the two sum in other orders)."""
    x = rng.normal(size=level["p0"].shape[:2] + (16,)).astype(np.float32)
    x = np.where(level["m0"][..., None], x, 0.0).astype(np.float32)
    args = (level["p0"], level["p0"], level["nb0"], x)
    got, want = _run_both(ref.KPConvLayer(24, 1.2, 2.5,
                                          compute_dtype="bfloat16"),
                          kpconv.KPConvLayer(16, 24, 1.2, 2.5,
                                             compute_dtype="bfloat16"), args)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2e-2 * scale


BLOCKS = {
    "unary": lambda: (ref.UnaryBlock(24), kpconv.UnaryBlock(16, 24)),
    "unary_no_norm": lambda: (ref.UnaryBlock(24, use_norm=False),
                              kpconv.UnaryBlock(16, 24, use_norm=False)),
    "simple": lambda: (ref.SimpleBlock(32, 2.5, 1.2),
                       kpconv.SimpleBlock(16, 32, 2.5, 1.2)),
    "bottleneck": lambda: (ref.ResnetBottleneckBlock(32, 2.5, 1.2),
                           kpconv.ResnetBottleneckBlock(16, 32, 2.5, 1.2)),
    "strided": lambda: (ref.ResnetBottleneckBlock(16, 2.5, 1.2, strided=True),
                        kpconv.ResnetBottleneckBlock(16, 16, 2.5, 1.2,
                                                     strided=True)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_match(level, rng, name):
    x = rng.normal(size=level["p0"].shape[:2] + (16,)).astype(np.float32)
    x = np.where(level["m0"][..., None], x, 0.0).astype(np.float32)
    lv = level
    args = {
        "unary": (x, lv["m0"]), "unary_no_norm": (x, lv["m0"]),
        "simple": (lv["p0"], lv["p0"], lv["nb0"], x, lv["m0"]),
        "bottleneck": (lv["p0"], lv["p0"], lv["nb0"], x, lv["m0"], lv["m0"]),
        "strided": (lv["p1"], lv["p0"], lv["pools"], x, lv["m1"], lv["m0"]),
    }[name]
    ref_mod, mod = BLOCKS[name]()
    got, want = _run_both(ref_mod, mod, args)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_nearest_upsample_and_unstacked_call(level, rng):
    x = rng.normal(size=level["p1"].shape[:2] + (5,)).astype(np.float32)
    up = kpconv.build_kp_pyramid(
        T(level["p0"]), T(level["m0"]), 1.0, 2.5, 2, (1024, 512),
        (16, 16)).levels[0].upsamples
    got = kpconv.nearest_upsample(T(x), up)
    want = ref.nearest_upsample(jnp.asarray(x), jnp.asarray(up.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a single cloud without the pair axis gives the stacked call's row
    mod = kpconv.KPConvLayer(5, 7, 1.2, 2.5)
    torch.nn.init.normal_(mod.weights)
    xs = rng.normal(size=level["p0"].shape[:2] + (5,)).astype(np.float32)
    with torch.no_grad():
        both = mod(T(level["p0"]), T(level["p0"]), T(level["nb0"]), T(xs))
        one = mod(T(level["p0"][1]), T(level["p0"][1]), T(level["nb0"][1]),
                  T(xs[1]))
    np.testing.assert_allclose(one.numpy(), both[1].numpy(), rtol=1e-6,
                               atol=1e-6)
