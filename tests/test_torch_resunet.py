"""apr_torch ResUNet2 with bridged flax weights against apr_tpu's ResUNet2
in eval mode.

Tolerances: float32 features within 1e-4 (relative to the feature scale;
the sums run in another order); bf16 convs within 2e-2 (both sides round
the operands to bf16 and sum in float32, in different orders, and the
differences compound over the U-Net's depth).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.models import make_resunet as ref_make_resunet
from apr_tpu.models import sparse as ref_sparse
from apr_torch.bridge import resunet_from_flax, resunet_state_dict
from apr_torch.models import load_model
from apr_torch.models import sparse
from apr_torch.ops.voxelize import voxelize_lean

CAPS = (512, 256, 128, 64)


def _to_ref_pyramid(pyr):
    """The port's pyramid as the reference's (the two are held equal,
    exactly, by tests/test_torch_sparse.py)."""
    def j(x):
        return jnp.asarray(x.numpy())
    return ref_sparse.SparsePyramid(
        levels=tuple(ref_sparse.SparseLevel(*map(j, lv))
                     for lv in pyr.levels),
        same_maps=tuple(map(j, pyr.same_maps)),
        down_maps=tuple(map(j, pyr.down_maps)),
        up_maps=tuple(map(j, pyr.up_maps)), conv1_map=j(pyr.conv1_map))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-8, 8, (2, 1500, 3)).astype(np.float32)
    pts[..., 2] *= 0.3
    coords, keys, vmask, _ = voxelize_lean(torch.from_numpy(pts), 0.5,
                                           CAPS[0])
    pyr = sparse.build_pyramid_from_level(
        sparse.SparseLevel(coords, keys, vmask), CAPS, 5)
    feats = vmask[..., None].float()
    return pyr, feats


def random_variables(model, *args, seed=4):
    """flax variables of ``model`` with every leaf drawn from numpy: conv
    and dense kernels at the init's scale, random norm scales, biases and
    running stats, so that the bridge of every leaf matters.  Shapes come
    from ``jax.eval_shape``, which traces the init without compiling it."""
    shapes = jax.eval_shape(
        lambda k: model.init(k, *args, train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = np.sqrt(6.0 / np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)  # mean, bias

    fill_tree = partial(jax.tree_util.tree_map_with_path, fill)
    return fill_tree(shapes["params"]), fill_tree(
        shapes.get("batch_stats", {}))


@pytest.mark.parametrize("name,out,dtype,tol", [
    ("ResUNetBN2", 16, None, 1e-4),
    ("ResUNetIN2B", 16, None, 1e-4),
    ("ResUNetFatBN", 32, None, 1e-4),
    ("ResUNetFatBN", 32, "bfloat16", 2e-2),
])
def test_resunet_matches_reference(batch, name, out, dtype, tol):
    pyr, feats = batch
    ref_pyr, ref_feats = _to_ref_pyramid(pyr), jnp.asarray(feats.numpy())
    kw = dict(in_channels=1, out_channels=out, normalize_feature=True,
              conv1_kernel_size=5, ones_input=True, compute_dtype=dtype)
    ref_model = ref_make_resunet(name, **kw)
    params, stats = random_variables(ref_model, ref_feats, ref_pyr)
    want = np.asarray(jax.jit(lambda v, f, p: ref_model.apply(
        v, f, p, train=False))({"params": params, "batch_stats": stats},
                               ref_feats, ref_pyr))

    n_leaves = len(jax.tree_util.tree_leaves((params, stats)))
    state = resunet_state_dict(params, stats)
    model = resunet_from_flax(name, params, stats, device="cpu", **kw)
    # every flax leaf consumed exactly once, every model entry filled
    assert len(state) == n_leaves == len(model.state_dict())

    with torch.inference_mode():
        got = model(feats, pyr).numpy()
    m = pyr.levels[0].mask.numpy()
    assert (got[~m] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got[m], axis=-1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ones_input_equals_gather_conv(batch):
    """conv1 as a validity matmul equals the gathered conv on mask ones."""
    pyr, feats = batch
    make = load_model("ResUNetBN2")
    a = make(out_channels=8, conv1_kernel_size=5, ones_input=True,
             device="cpu", seed=5)
    b = make(out_channels=8, conv1_kernel_size=5, ones_input=False,
             device="cpu", seed=5)
    with torch.inference_mode():
        torch.testing.assert_close(a(feats, pyr), b(feats, pyr), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("axes", [(0, 1), (1,)])
def test_masked_moments_match(rng, axes):
    from apr_tpu.models.layers import masked_moments as ref_moments
    from apr_torch.models.layers import masked_moments

    x = rng.normal(size=(3, 50, 4)).astype(np.float32)
    m = rng.random((3, 50)) > 0.3
    m[2] = False                               # an empty cloud
    got = masked_moments(torch.from_numpy(x), torch.from_numpy(m), axes)
    want = ref_moments(jnp.asarray(x), jnp.asarray(m), axes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_batch_norm_train_mode_ignores_padding_rows():
    """A padding row, however large, moves neither the batch moments nor
    the running stats, and comes out zero (tests/test_torch_train_units.py
    holds train mode against the reference on random inputs)."""
    from apr_torch.models.layers import MaskedBatchNorm

    bn = MaskedBatchNorm(4, momentum=0.5)
    x = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    x[0, 2] = 1e6
    mask = torch.tensor([[True, True, False]])
    y = bn(x, mask)
    torch.testing.assert_close(y[0, :2], torch.tensor([[-1.0] * 4, [1.0] * 4]),
                               rtol=0, atol=1e-4)
    assert (y[0, 2] == 0).all()
    torch.testing.assert_close(bn.mean, torch.arange(2.0, 6.0) * 0.5)
    torch.testing.assert_close(bn.var, torch.full((4,), 0.5 + 0.5 * 4.0))


def test_bridge_rejects_a_leaf_mapped_twice():
    params = {"MaskedBatchNorm_0": {"scale": np.ones(2)},
              "norm1": {"scale": np.ones(2)}}
    with pytest.raises(ValueError):
        resunet_state_dict(params, {})
