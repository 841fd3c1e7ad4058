"""The SimpleNet family (apr_torch/models/simpleunet.py) with bridged flax
weights against apr_tpu's SimpleUNet, and the registry.

Tolerances: float32 features within 1e-4 (sums in another order), running
statistics within 1e-5; bf16 convs within 2e-2 (as
tests/test_torch_resunet.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.models import load_model as ref_load_model
from apr_tpu.models import model_names as ref_model_names
from apr_torch.bridge import load_flax_resunet_, resunet_state_dict
from apr_torch.models import load_model, model_names, sparse
from apr_torch.models.layers import MaskedBatchNorm, MaskedInstanceNorm, \
    get_norm
from apr_torch.ops.voxelize import voxelize_lean
from test_torch_resunet import _to_ref_pyramid, random_variables

CAPS = (512, 256, 128, 64, 32)      # five levels: the deepest variants


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-8, 8, (2, 1500, 3)).astype(np.float32)
    pts[..., 2] *= 0.3
    coords, keys, vmask, _ = voxelize_lean(torch.from_numpy(pts), 0.5,
                                           CAPS[0])
    pyr = sparse.build_pyramid_from_level(
        sparse.SparseLevel(coords, keys, vmask), CAPS, 3)
    return pyr, vmask[..., None].float()


def _models(name, dtype=None, **kw):
    kw = dict(in_channels=1, out_channels=16, normalize_feature=True,
              conv1_kernel_size=3, ones_input=True, compute_dtype=dtype,
              **kw)
    return ref_load_model(name)(**kw), load_model(name)(device="cpu", **kw)


@pytest.mark.parametrize("name,dtype,tol", [
    ("SimpleNetBN", None, 1e-4),
    ("SimpleNetIN2E", None, 1e-4),
    ("SimpleNetBN3E", None, 1e-4),
    ("SimpleNetBN2", "bfloat16", 2e-2),
])
def test_simplenet_matches_reference(batch, name, dtype, tol):
    pyr, feats = batch
    ref_pyr, ref_feats = _to_ref_pyramid(pyr), jnp.asarray(feats.numpy())
    ref_model, model = _models(name, dtype)
    params, stats = random_variables(ref_model, ref_feats, ref_pyr)
    want = np.asarray(jax.jit(lambda v, f, p: ref_model.apply(
        v, f, p, train=False))({"params": params, "batch_stats": stats},
                               ref_feats, ref_pyr))
    n_leaves = len(jax.tree_util.tree_leaves((params, stats)))
    assert len(resunet_state_dict(params, stats, model.levels)) == \
        n_leaves == len(model.state_dict())
    load_flax_resunet_(model, params, stats)
    with torch.inference_mode():
        got = model(feats, pyr).numpy()
    m = pyr.levels[0].mask.numpy()
    assert (got[~m] == 0).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_simplenet_train_mode(batch):
    """Batch statistics normalise and the running stats move as flax's."""
    pyr, feats = batch
    ref_pyr, ref_feats = _to_ref_pyramid(pyr), jnp.asarray(feats.numpy())
    ref_model, model = _models("SimpleNetBN2E", bn_momentum=0.05)
    params, stats = random_variables(ref_model, ref_feats, ref_pyr, seed=7)
    want, new = ref_model.apply({"params": params, "batch_stats": stats},
                                ref_feats, ref_pyr, train=True,
                                mutable=["batch_stats"])
    load_flax_resunet_(model, params, stats)
    model.train()
    with torch.no_grad():
        got = model(feats, pyr).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    moved = resunet_state_dict(params, jax.device_get(new["batch_stats"]),
                               model.levels)
    for k, v in model.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_registry_and_get_norm():
    assert model_names() == ref_model_names()
    for name in ("SimpleNetBN", "SimpleNetIN", "SimpleNetBNE", "SimpleNetBN2",
                 "SimpleNetIN3E"):
        ref = ref_load_model(name)()
        ours = load_model(name)(device="cpu")
        assert ours.levels == len(ref.channels)
        assert ours.conv2.kernel.shape[1:] == (ref.channels[0],
                                               ref.channels[1])
        norm_cls = MaskedInstanceNorm if ref.norm_type == "IN" else \
            MaskedBatchNorm
        assert isinstance(ours.norm1, norm_cls)
    bn = get_norm("BN", 8, momentum=0.3)
    assert isinstance(bn, MaskedBatchNorm) and bn.momentum == 0.3
    assert isinstance(get_norm("IN", 8), MaskedInstanceNorm)
    with pytest.raises(ValueError, match="not defined"):
        get_norm("GN", 8)
    with pytest.raises(ValueError, match="unknown model name"):
        load_model("NoSuchNet")


def test_trainer_builds_a_simplenet_encoder():
    from apr_torch.config import APRConfig
    from apr_torch.training.trainer import get_trainer

    cfg = APRConfig(trainer="HardestContrastiveLossTrainer",
                    model="SimpleNetBN2E", model_n_out=16,
                    conv1_kernel_size=3, capacities=(256, 128, 64, 32))
    trainer = get_trainer(cfg, device="cpu")
    assert trainer.generator is None and trainer.encoder.levels == 4
    assert trainer.encoder.final.kernel.shape == (16, 16)
