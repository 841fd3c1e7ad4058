"""The GCN and the whole KPFCNN: apr_torch against apr_tpu from the same
pyramids and a bridged flax tree (every leaf drawn at random).

- GCN (self / cross / self, and the coordinate-augmented cross block):
  within 1e-5 of the output's scale;
- KPFCNN in float32: features, overlap and saliency within 1e-4;
- KPFCNN in bf16 (bf16 operands, float32 accumulation on both sides, in
  other summation orders): within 5e-3 (measured: 6.6e-4 at most, on the
  first cloud's overlap; float32 1.5e-6);
- the bridge is strict: a missing or an extra leaf raises.
"""

import jax
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.synthetic import synthetic_pair
from apr_tpu.eval.predator_tester import PredatorTester as RefTester
from apr_tpu.models import gcn as ref_gcn
from apr_tpu.training.predator import PredatorTrainer as RefTrainer
from apr_torch.bridge import kpfcnn_state_dict, load_flax_predator_
from apr_torch.config import APRConfig
from apr_torch.eval.predator_tester import PredatorTester
from apr_torch.models import gcn
from apr_torch.training.predator import PredatorTrainer
from test_torch_kpconv import _randomize

T = torch.from_numpy
FIELDS = dict(
    final_feats_dim=16, first_feats_dim=32, gnn_feats_dim=32,
    generator_model="GenerativeMLP_54", point_generation_ratio=2,
    first_subsampling_dl=1.0, conv_radius=2.5,
    kp_capacities=(1024, 512, 256, 128), neighborhood_limits=(16,) * 4,
    point_capacity=3000, overlap_radius=1.2, compute_dtype="float32",
    test_subsample=500, test_num_ransac_hypotheses=1024,
)


def reference_predator(fields, pair, seed=0):
    """(reference trainer, tester, batch, randomized params, batch stats)
    for ``fields`` on ``pair``."""
    cfg = RefConfig(trainer="PredatorTrainer", **fields)
    trainer = RefTrainer(cfg)
    tester = RefTester(cfg, trainer, None)
    batch = tester._pair_to_batch(pair)
    state = trainer.init_state(jax.random.PRNGKey(seed), batch)
    params = dict(jax.device_get(state.params))
    params["model"] = _randomize({"params": params["model"]}, seed + 7)
    tester.state = state._replace(params=params)
    return trainer, tester, batch, params, jax.device_get(state.batch_stats)


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair(7, n_points=2500, apc_points=4, distance=6.0,
                          extent=30.0)


@pytest.mark.parametrize("nets", [("self", "cross", "self"), ("cross_cat",)])
def test_gcn_matches(pair, rng, nets):
    n, c = 96, 32
    coords = [rng.uniform(-20, 20, (n, 3)).astype(np.float32)
              for _ in range(2)]
    feats = [rng.normal(size=(n, c)).astype(np.float32) for _ in range(2)]
    masks = [rng.random(n) > 0.2 for _ in range(2)]
    feats = [np.where(m[:, None], f, 0.0).astype(np.float32)
             for f, m in zip(feats, masks)]
    args = (*coords, *feats, *masks)
    ref = ref_gcn.GCN(c, nets, k=10, num_heads=4)
    params = _randomize(jax.jit(ref.init)(jax.random.PRNGKey(0), *args), 3)
    want = jax.jit(ref.apply)({"params": params}, *args)
    mod = gcn.GCN(c, nets, k=10, num_heads=4)
    mod.load_state_dict(kpfcnn_state_dict(jax.device_get(params)),
                        strict=True)
    with torch.no_grad():
        got = mod(*(T(np.asarray(a)) for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-3)])
def test_kpfcnn_matches_bridged_reference(pair, dtype, tol):
    fields = dict(FIELDS, compute_dtype=dtype)
    trainer_r, tester_r, batch_r, params, stats = reference_predator(
        fields, pair)
    want = jax.jit(trainer_r.model.apply)({"params": params["model"]},
                                          batch_r.pyr0, batch_r.pyr1)
    cfg = APRConfig(**fields)
    trainer = load_flax_predator_(PredatorTrainer(cfg, device="cpu"), params,
                                  stats)
    batch = PredatorTester(cfg, trainer, device="cpu")._pair_to_batch(pair)
    got = PredatorTester(cfg, trainer, device="cpu").forward(batch)
    errs = {}
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        errs[name] = float(np.abs(g - w).max())
        assert np.isfinite(g).all()
    assert max(errs.values()) <= tol, errs
    # the heads are not trivially constant on random weights
    assert float(np.asarray(want.overlap0).std()) > 1e-3


def test_bridge_is_strict(pair):
    _, _, _, params, stats = reference_predator(FIELDS, pair)
    trainer = PredatorTrainer(APRConfig(**FIELDS), device="cpu")
    missing = dict(params, model=dict(params["model"]))
    del missing["model"]["proj_score"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_predator_(trainer, missing, stats)
    extra = dict(params, model=dict(params["model"],
                                    stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_predator_(trainer, extra, stats)
    with pytest.raises(ValueError, match="Predator tree"):
        load_flax_predator_(trainer, {"model": params["model"]}, stats)
