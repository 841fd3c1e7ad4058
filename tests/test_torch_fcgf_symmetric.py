"""One symmetric GenerativePairTrainer step of apr_torch against apr_tpu's
at tests/test_symmetric.py's config (ResUNetBN2-16 encoder, a ResUNetBN2B
decoder over the same pyramid with point_generation_ratio * 3 outputs,
batch 1), in float32 with the "pallas" Chamfer, from a randomized flax
tree bridged into the port (the decoder through the ResUNet names) and
the reference's draws replayed.

Tolerances are tests/test_torch_train.py's: loss terms rtol 1e-4;
parameters and running stats after the step rtol 1e-4 with a floor of
1e-4 of each tensor's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apr_torch.bridge import load_flax_train_state_, resunet_state_dict
from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.models.resunet import ResUNet2
from apr_torch.training.trainer import FCGFTrainer
from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.training import get_trainer as ref_get_trainer
from test_torch_train import _close, _randomize, _replay, _step_scores
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)

FIELDS = dict(
    trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=16,
    conv1_kernel_size=3, symmetric=True, generator_model="ResUNetBN2B",
    point_generation_ratio=2, batch_size=1, num_pos_per_batch=64,
    num_hn_samples_per_batch=32, voxel_size=1.0, point_capacity=1536,
    capacities=(768, 384, 192, 96), apc_capacity=1536, lr=0.05,
    compute_dtype="float32", chamfer_mode="pallas")
KEY = 17


def _raw(cfg):
    d = synthetic_pair(0, n_points=1400, apc_points=1400, distance=8.0,
                       extent=30.0)
    p0, m0 = pad_points(d["points0"], cfg.point_capacity)
    p1, m1 = pad_points(d["points1"], cfg.point_capacity)
    a0, am0 = pad_points(d["apc0"], cfg.apc_capacity)
    a1, am1 = pad_points(d["apc1"], cfg.apc_capacity)
    return tuple(x[None] for x in (p0, m0, p1, m1, a0, am0, a1, am1,
                                   d["t_gt"].astype(np.float32)))


def _named(params, stats):
    return {f"{tag}.{k}": v for tag in ("encoder", "generator")
            for k, v in resunet_state_dict(params[tag], stats[tag]).items()}


def test_symmetric_step_matches_reference(monkeypatch):
    ref_trainer = ref_get_trainer(RefConfig(**FIELDS))
    cfg = APRConfig(**FIELDS)
    raw = _raw(cfg)
    ref_batch = ref_trainer.build_batch(tuple(map(jnp.asarray, raw)))
    state = ref_trainer.init_state(jax.random.PRNGKey(0), ref_batch)
    state = state._replace(params=_randomize(state.params, 1),
                           batch_stats=_randomize(state.batch_stats, 2))
    key = jax.random.PRNGKey(KEY)
    state1, metrics = ref_trainer.train_step(state, ref_batch, key)

    trainer = FCGFTrainer(cfg, device="cpu")
    assert trainer.symmetric and isinstance(trainer.generator, ResUNet2)
    assert not trainer.generator.conv1.ones_input
    assert trainer.generator.final.kernel.shape == (64, 6)
    load_flax_train_state_(trainer, state.params, state.batch_stats)
    batch = trainer.build_batch(raw)
    _replay(monkeypatch, _step_scores(key, ref_batch))
    got = trainer.train_step(batch)
    for name, value in metrics.items():
        _close(float(got[name]), float(value), floor=0, what=name)
    assert float(got["skipped_nonfinite"]) == 0.0
    assert float(got["chamfer_loss"]) > 0.0

    want = _named(state1.params, state1.batch_stats)
    old = _named(state.params, state.batch_stats)
    port = {f"{tag}.{k}": v for tag, m in
            zip(("encoder", "generator"), trainer.modules())
            for k, v in m.state_dict().items()}
    assert set(port) == set(want)
    for name in want:
        _close(port[name], want[name], what=name)
    # the generator's running stats thread through both clouds' calls
    moved = [n for n in want if n.startswith("generator.")
             and not torch.equal(want[n], old[n])]
    assert len(moved) == sum(n.startswith("generator.") for n in want)
