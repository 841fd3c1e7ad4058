"""The symmetric NPR decoder of the Predator trainer (``symmetric=True``):
apr_torch against apr_tpu at tests/test_symmetric.py's ``PRED_CFG`` in
float32, from the same numpy pair and a randomized flax tree bridged into
the port.  Its 7 kernel points reach the first KPConv block only, as in
the reference (the bottleneck blocks keep 15).

- ``KPFCNNDecoder`` forward: within 1e-5 of the output's scale;
- the symmetric ``loss_fn`` forward (the reference's jitted forward, draws
  replayed): loss terms within rtol 1e-4;
- the bridge is strict on a symmetric tree;
- one port train step is finite and moves the parameters.
The reference's symmetric step is not differentiated here: that compile
is the one tests/test_symmetric.py keeps out of the fast tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.synthetic import synthetic_pair
from apr_tpu.models.kpfcnn import KPFCNNDecoder as RefDecoder
from apr_tpu.training.predator import PredatorTrainer as RefTrainer
from apr_tpu.training.predator import make_kp_pair_batch
from apr_torch.bridge import kpfcnn_state_dict, load_flax_predator_
from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points
from apr_torch.models.kpfcnn import KPFCNNDecoder
from apr_torch.training.predator import PredatorTrainer
from test_torch_kpconv import _randomize
from test_torch_predator_train import _close, port_state, replay

FIELDS = dict(
    trainer="PredatorTrainer", final_feats_dim=16, first_feats_dim=16,
    gnn_feats_dim=16, symmetric=True, point_generation_ratio=2,
    num_kernel_points=7, dgcnn_k=4, num_head=2, first_subsampling_dl=1.0,
    conv_radius=2.5, kp_capacities=(512, 256, 128, 64),
    neighborhood_limits=(12,) * 4, point_capacity=1536, apc_capacity=1024,
    pos_radius=1.0, safe_radius=2.5, overlap_radius=1.2,
    matchability_radius=1.2, max_points=128, optimizer="SGD", lr=0.01,
    sgd_momentum=0.98, compute_dtype="float32", chamfer_mode="pallas")
LOSS_KEY = 5


def _raw(cfg):
    """tests/test_symmetric.py's pair, padded."""
    d = synthetic_pair(0, n_points=1300, apc_points=1000, distance=8.0,
                       extent=30.0)
    p0, m0 = pad_points(d["points0"], cfg.point_capacity)
    p1, m1 = pad_points(d["points1"], cfg.point_capacity)
    a0, am0 = pad_points(d["apc0"], cfg.apc_capacity)
    a1, am1 = pad_points(d["apc1"], cfg.apc_capacity)
    return p0, m0, p1, m1, a0, am0, a1, am1, d["t_gt"].astype(np.float32)


@pytest.fixture(scope="module")
def sym():
    """The reference's batch and randomized symmetric state; the port's
    trainer with the same weights, and its batch."""
    cfg = APRConfig(**FIELDS)
    raw = _raw(cfg)
    ref_trainer = RefTrainer(RefConfig(**FIELDS))
    ref_batch = make_kp_pair_batch(
        *map(jnp.asarray, raw), first_subsampling_dl=cfg.first_subsampling_dl,
        conv_radius=cfg.conv_radius, capacities=cfg.kp_capacities,
        neighbor_limits=cfg.neighborhood_limits,
        overlap_radius=cfg.overlap_radius)
    state = ref_trainer.init_state(jax.random.PRNGKey(0), ref_batch)
    params = {name: _randomize({"params": jax.device_get(tree)}, seed)
              for (name, tree), seed in zip(state.params.items(), (3, 4))}
    stats = jax.device_get(state.batch_stats)
    trainer = load_flax_predator_(PredatorTrainer(cfg, device="cpu"),
                                  params, stats)
    return dict(cfg=cfg, raw=raw, ref_trainer=ref_trainer,
                ref_batch=ref_batch, params=params, stats=stats,
                trainer=trainer, batch=trainer.build_batch(raw))


def test_kpfcnn_decoder_matches_reference(sym):
    """The decoder alone, fed the same unit-norm features."""
    rng = np.random.default_rng(0)
    rb, batch = sym["ref_batch"], sym["batch"]
    feats = []
    for lv in (batch.pyr0.levels[0], batch.pyr1.levels[0]):
        f = rng.normal(size=(lv.mask.shape[0], 16)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        feats.append(np.where(lv.mask.numpy()[:, None], f, 0.0)
                     .astype(np.float32))
    ref = RefDecoder(point_generation_ratio=2, first_feats_dim=16,
                     first_subsampling_dl=1.0, conv_radius=2.5,
                     num_kernel_points=7)
    params = sym["params"]["generator"]
    want = jax.jit(ref.apply)({"params": params}, *feats, rb.pyr0, rb.pyr1)
    dec = KPFCNNDecoder(16, 2, 16, 1.0, 2.5, num_kernel_points=7)
    dec.load_state_dict(kpfcnn_state_dict(params), strict=True)
    with torch.no_grad():
        got = dec(*map(torch.from_numpy, feats), batch.pyr0, batch.pyr1)
    for g, w, lv in zip(got, want, (batch.pyr0.levels[0],
                                    batch.pyr1.levels[0])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        norms = np.linalg.norm(w, axis=1)
        np.testing.assert_allclose(norms[lv.mask.numpy()], 1.0, atol=1e-5)
        assert (norms[~lv.mask.numpy()] == 0).all()


def test_symmetric_loss_matches_reference_forward(sym, monkeypatch):
    key = jax.random.PRNGKey(LOSS_KEY)
    ref = sym["ref_trainer"]
    params = {k: jax.tree.map(jnp.asarray, v) for k, v in
              sym["params"].items()}
    _, (_, want) = jax.jit(lambda p, b, k: ref.loss_fn(
        p, sym["stats"], b, k, jnp.asarray(1.0), True))(
        params, sym["ref_batch"], key)
    replay(monkeypatch, [key], int(sym["ref_batch"].corr_src.shape[0]))
    with torch.no_grad():
        _, got = sym["trainer"].loss_fn(sym["batch"], None, 1.0, True)
    assert set(got) == set(want)
    for name, value in want.items():
        _close(float(got[name]), float(value), floor=0, what=name)
    assert float(want["chamfer_loss"]) > 0 and float(want["circle_loss"]) > 0


def test_bridge_is_strict_on_a_symmetric_tree(sym):
    params, stats = sym["params"], sym["stats"]
    trainer = PredatorTrainer(sym["cfg"], device="cpu")
    assert isinstance(trainer.generator, KPFCNNDecoder)
    missing = dict(params, generator=dict(params["generator"]))
    del missing["generator"]["decoder"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_predator_(trainer, missing, stats)
    extra = dict(params, generator=dict(params["generator"],
                                        stray={"kernel": np.zeros((2, 2))}))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_predator_(trainer, extra, stats)
    with pytest.raises(ValueError, match="batch stats"):
        load_flax_predator_(trainer, params, dict(
            stats, generator={"MaskedBatchNorm_0": {"mean": np.zeros(2)}}))


def test_symmetric_step_is_finite_and_moves_the_parameters(sym):
    trainer = PredatorTrainer(sym["cfg"], device="cpu", seed=2)
    assert not list(trainer.generator.buffers())
    before = port_state(trainer)
    metrics = trainer.train_step(sym["batch"],
                                 torch.Generator().manual_seed(0), 1.0)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert float(metrics["skipped_nonfinite"]) == 0.0
    after = port_state(trainer)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    trainable = {f"{tag}.{n}" for tag, m in (("model", trainer.model),
                                            ("generator", trainer.generator))
                 for n, p in m.named_parameters() if p.requires_grad}
    assert moved <= trainable and len(moved) > 0.9 * len(trainable)
    assert any(k.startswith("generator.decoder") for k in moved)
