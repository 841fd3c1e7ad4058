"""The Predator trainer's gradient accumulation (``iter_size=2``, the
reference's optax.MultiSteps around its masked SGD), apr_torch against
apr_tpu at tests/test_torch_predator_train.py's config, from the same
randomized flax tree with the correspondence draws replayed, over three
mini-steps: the parameters stay bit for bit on mini-steps 1 and 3 and
equal the reference's after mini-step 2, the generator's running stats
follow every mini-step, the frozen kernel points never move, the learning
rate reaches the inner optimizer, and a non-finite mini-step leaves the
counter and the running mean where the reference leaves them.

Tolerances are tests/test_torch_predator_train.py's: loss terms rtol 1e-4;
parameters rtol 1e-3 with a floor of 1e-3 of each tensor's largest entry
(the Predator backward is ill-conditioned at float32 rounding, see there);
running stats within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.training.predator import PredatorTrainer as RefTrainer
from apr_tpu.training.predator import make_kp_pair_batch
from apr_torch.config import APRConfig
from test_torch_predator_train import FIELDS, STEP_TOL, _close, named, \
    port_state, port_trainer, raw_pair, reference_state, replay
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)

KEYS = (41, 42, 43, 44)
W_SALIENCY = 1.0


@pytest.fixture(scope="module")
def run():
    fields = dict(FIELDS, iter_size=2)
    ref_cfg, cfg = RefConfig(**fields), APRConfig(**fields)
    raw = raw_pair(cfg)
    ref_trainer = RefTrainer(ref_cfg)
    ref_batch = make_kp_pair_batch(
        *map(jnp.asarray, raw), first_subsampling_dl=cfg.first_subsampling_dl,
        conv_radius=cfg.conv_radius, capacities=cfg.kp_capacities,
        neighbor_limits=cfg.neighborhood_limits,
        overlap_radius=cfg.overlap_radius)
    states, metrics = [reference_state(ref_trainer, ref_batch)], []
    w = jnp.asarray(W_SALIENCY)
    for k in KEYS[:3]:
        s, m = ref_trainer.train_step(states[-1], ref_batch,
                                      jax.random.PRNGKey(k), w)
        states.append(s)
        metrics.append(m)
    bad = ref_batch._replace(apc0=ref_batch.apc0.at[0].set(jnp.nan))
    bad_state, bad_metrics = ref_trainer.train_step(
        states[3], bad, jax.random.PRNGKey(KEYS[3]), w)
    trainer = port_trainer(cfg, states[0].params, states[0].batch_stats)
    return dict(cfg=cfg, ref_trainer=ref_trainer, states=states,
                metrics=metrics, bad_state=bad_state,
                bad_metrics=bad_metrics, trainer=trainer,
                batch=trainer.build_batch(raw),
                n_corr=int(ref_batch.corr_src.shape[0]))


def test_three_mini_steps_match_multisteps(run, monkeypatch):
    trainer, states = run["trainer"], run["states"]
    got = [port_state(trainer)]
    for i, k in enumerate(KEYS[:3]):
        replay(monkeypatch, [jax.random.PRNGKey(k)], run["n_corr"])
        m = trainer.train_step(run["batch"], None, W_SALIENCY)
        assert float(m["skipped_nonfinite"]) == 0.0
        for name, value in run["metrics"][i].items():
            _close(float(m[name]), float(value), floor=0, what=name)
        assert trainer.accumulation.mini_step == int(
            states[i + 1].opt_state.mini_step) == (i + 1) % 2
        got.append(port_state(trainer))
    for i in range(1, 4):
        want = named(states[i].params, states[i].batch_stats)
        for name, w in want.items():
            g = got[i][name]
            if name.endswith("kernel_points"):
                assert torch.equal(g, w) and torch.equal(g, got[0][name])
            elif name.endswith((".mean", ".var")):
                _close(g, w, rtol=1e-5, floor=1e-5, what=name)
                assert not torch.equal(g, got[i - 1][name]), name
            else:
                _close(g, w, what=f"mini-step {i} {name}", **STEP_TOL)
                # the parameters move on the second mini-step only
                assert torch.equal(g, got[i - 1][name]) == (i != 2), name
    assert trainer.step == 3


def test_lr_and_nonfinite_mini_step(run, monkeypatch):
    trainer = port_trainer(run["cfg"], run["states"][0].params,
                           run["states"][0].batch_stats)
    ref_lr = run["ref_trainer"].set_lr(run["states"][0], 6).opt_state \
        .inner_opt_state.hyperparams["learning_rate"]
    assert trainer.set_lr(6) == pytest.approx(float(ref_lr), rel=1e-7)
    trainer.set_lr(0)
    replay(monkeypatch, [jax.random.PRNGKey(KEYS[0])], run["n_corr"])
    trainer.train_step(run["batch"], None, W_SALIENCY)
    acc = [g.clone() for g in trainer.accumulation.grads]
    before = port_state(trainer)
    bad = run["batch"]._replace(apc0=run["batch"].apc0.clone())
    bad.apc0[0] = float("nan")
    replay(monkeypatch, [jax.random.PRNGKey(KEYS[3])], run["n_corr"])
    m = trainer.train_step(bad, None, W_SALIENCY)
    assert float(m["skipped_nonfinite"]) == float(
        run["bad_metrics"]["skipped_nonfinite"]) == 1.0
    assert trainer.accumulation.mini_step == int(
        run["bad_state"].opt_state.mini_step) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(acc, trainer.accumulation.grads))
    after = port_state(trainer)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert np.isfinite(float(run["metrics"][0]["loss"]))
