"""The FCGF trainer's modes beyond the generative step, apr_torch against
apr_tpu at tests/test_torch_train.py's small config (float32, the "pallas"
Chamfer), from a bridged randomized flax tree with the reference's draws
replayed:

- ``iter_size=2`` (the reference's optax.MultiSteps) over three
  mini-steps: the parameters do not move on mini-steps 1 and 3 (bit for
  bit) and equal the reference's after mini-step 2; the running stats
  follow every mini-step; the learning rate reaches the inner optimizer;
  a non-finite mini-step leaves the mini-step counter and the running mean
  where the reference leaves them;
- one train step of each of the Contrastive, Triplet and HardestTriplet
  trainers: loss terms, parameters and running stats;
- ``train_step_fused`` is ``train_step`` then ``build_batch``, bit for
  bit, and ``get_trainer`` builds the trainer of the config.

Tolerances are tests/test_torch_train.py's: loss terms rtol 1e-4;
parameters and running stats rtol 1e-4 with a floor of 1e-4 of each
tensor's largest entry (a 4-level U-Net's rounding compounds through the
forward and the backward).  The Predator trainer's accumulation is in
tests/test_torch_predator_iter_size.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_torch.bridge import load_flax_train_state_, resunet_state_dict
from apr_torch.config import APRConfig
from apr_torch.losses import contrastive
from apr_torch.training.trainer import FCGFTrainer, get_trainer
from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.training import get_trainer as ref_get_trainer
from test_torch_train import FIELDS, _close, _raw, _randomize, _ref_named, \
    _step_scores
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)

KEYS = (21, 22, 23, 24)


def _params(trainer):
    return {f"{tag}.{k}": v.detach().clone() for tag, m in
            zip(("encoder", "generator"), trainer.modules())
            for k, v in m.state_dict().items()}


def _reference(fields, n_steps):
    """The reference's batch, randomized state and the states after
    ``n_steps`` train steps (KEYS)."""
    ref_trainer = ref_get_trainer(RefConfig(**fields))
    cfg = APRConfig(**fields)
    raw = _raw(cfg)
    ref_batch = ref_trainer.build_batch(tuple(map(jnp.asarray, raw)))
    state = ref_trainer.init_state(jax.random.PRNGKey(0), ref_batch)
    state = state._replace(params=_randomize(state.params, 1),
                           batch_stats=_randomize(state.batch_stats, 2))
    states, metrics = [state], []
    for k in KEYS[:n_steps]:
        s, m = ref_trainer.train_step(states[-1], ref_batch,
                                      jax.random.PRNGKey(k))
        states.append(s)
        metrics.append(m)
    trainer = FCGFTrainer(cfg, device="cpu")
    load_flax_train_state_(trainer, state.params, state.batch_stats)
    return dict(ref_trainer=ref_trainer, ref_batch=ref_batch, cfg=cfg,
                states=states, metrics=metrics, trainer=trainer,
                batch=trainer.build_batch(raw))


def _replay(monkeypatch, queue, picks=()):
    picks = list(picks)

    def sample(generator, mask, num):
        return contrastive.top_valid(torch.from_numpy(queue.pop(0).copy()),
                                     mask, num)

    def pick(generator, num, high, device):
        return torch.from_numpy(picks.pop(0).astype(np.int64))

    monkeypatch.setattr(contrastive, "_sample_without_replacement", sample)
    monkeypatch.setattr(contrastive, "_random_picks", pick)


# --- iter_size = 2 -------------------------------------------------------

@pytest.fixture(scope="module")
def accumulating():
    run = _reference(dict(FIELDS, iter_size=2), 3)
    bad = run["ref_batch"]._replace(
        apc0=run["ref_batch"].apc0.at[0, 0].set(jnp.inf))
    s_bad, m_bad = run["ref_trainer"].train_step(
        run["states"][3], bad, jax.random.PRNGKey(KEYS[3]))
    run.update(bad_state=s_bad, bad_metrics=m_bad)
    return run


def test_iter_size_two_matches_multisteps(accumulating, monkeypatch):
    run = accumulating
    trainer, states = run["trainer"], run["states"]
    start = _params(trainer)
    got = []
    for k in KEYS[:3]:
        _replay(monkeypatch, _step_scores(jax.random.PRNGKey(k),
                                          run["ref_batch"]))
        m = trainer.train_step(run["batch"])
        assert float(m["skipped_nonfinite"]) == 0.0
        got.append((_params(trainer), trainer.accumulation.mini_step,
                    {n: float(v) for n, v in m.items()}))
    assert [g[1] for g in got] == [1, 0, 1] == [
        int(s.opt_state.mini_step) for s in states[1:]]
    assert trainer.step == 3
    for i, (params, _, metrics) in enumerate(got):
        s = states[i + 1]
        want = _ref_named(s.params, s.batch_stats)
        for name, value in run["metrics"][i].items():
            _close(metrics[name], float(value), floor=0, what=name)
        for name, w in want.items():
            _close(params[name], w, what=f"mini-step {i + 1} {name}")
            if name.endswith((".mean", ".var")):
                continue
            # parameters move only on the second mini-step
            before = start if i < 2 else got[1][0]
            assert torch.equal(params[name], before[name]) == (i != 1), name


def test_iter_size_lr_and_nonfinite_mini_step(accumulating, monkeypatch):
    run = accumulating
    trainer = FCGFTrainer(run["cfg"], device="cpu")
    load_flax_train_state_(trainer, run["states"][0].params,
                           run["states"][0].batch_stats)
    ref_lr = run["ref_trainer"].set_lr(run["states"][0], 4).opt_state \
        .inner_opt_state.hyperparams["learning_rate"]
    assert trainer.set_lr(4) == pytest.approx(float(ref_lr), rel=1e-7)
    assert trainer.optimizer.param_groups[0]["lr"] == trainer.set_lr(4)
    trainer.set_lr(0)
    _replay(monkeypatch, _step_scores(jax.random.PRNGKey(KEYS[0]),
                                      run["ref_batch"]))
    trainer.train_step(run["batch"])
    acc = [g.clone() for g in trainer.accumulation.grads]
    params = _params(trainer)
    bad = run["batch"]._replace(apc0=run["batch"].apc0.clone())
    bad.apc0[0, 0] = float("inf")
    _replay(monkeypatch, _step_scores(jax.random.PRNGKey(KEYS[3]),
                                      run["ref_batch"]))
    m = trainer.train_step(bad)
    assert float(m["skipped_nonfinite"]) == float(
        run["bad_metrics"]["skipped_nonfinite"]) == 1.0
    assert trainer.accumulation.mini_step == int(
        run["bad_state"].opt_state.mini_step) == 1
    assert all(torch.equal(a, b)
               for a, b in zip(acc, trainer.accumulation.grads))
    after = _params(trainer)
    assert all(torch.equal(params[k], after[k]) for k in params)
    assert trainer.step == 2


# --- the other loss modes ---------------------------------------------------

def _mode_draws(mode, key, batch, num_pos, num_hn):
    """The reference's draws of one step of ``mode`` (trainer.py:346 splits
    the step key; the loss splits its half)."""
    k_mine = jax.random.split(key)[0]
    n = int(np.prod(batch.pos_mask.shape))
    m = int(np.prod(batch.pyramid0.levels[0].mask.shape))
    if mode == "ContrastiveLossTrainer":
        k_pos, k_neg = jax.random.split(k_mine)
        return [np.asarray(jax.random.uniform(k_pos, (n,))),
                np.asarray(jax.random.uniform(k_neg, (m,)))], []
    k_pos, k_neg, k_pick = jax.random.split(k_mine, 3)
    scores = [np.asarray(jax.random.uniform(k_pos, (n,))),
              np.asarray(jax.random.uniform(k_neg, (m,)))]
    if mode == "HardestTripletLossTrainer":
        return scores, []
    return scores, [np.asarray(jax.random.randint(k_pick, (num_pos,), 0,
                                                  num_hn))]


@pytest.mark.parametrize("mode", ["ContrastiveLossTrainer",
                                  "TripletLossTrainer",
                                  "HardestTripletLossTrainer"])
def test_loss_mode_step_matches_reference(mode, monkeypatch):
    run = _reference(dict(FIELDS, trainer=mode), 1)
    trainer, cfg = run["trainer"], run["cfg"]
    assert trainer.generator is None
    scores, picks = _mode_draws(
        mode, jax.random.PRNGKey(KEYS[0]), run["ref_batch"],
        cfg.num_pos_per_batch * cfg.batch_size,
        cfg.num_hn_samples_per_batch * cfg.batch_size)
    _replay(monkeypatch, scores, picks)
    metrics = trainer.train_step(run["batch"])
    for name, value in run["metrics"][0].items():
        _close(float(metrics[name]), float(value), floor=0, what=name)
    assert float(metrics["skipped_nonfinite"]) == 0.0
    s = run["states"][1]
    want = resunet_state_dict(s.params["encoder"], s.batch_stats["encoder"])
    old = resunet_state_dict(run["states"][0].params["encoder"],
                             run["states"][0].batch_stats["encoder"])
    got = trainer.encoder.state_dict()
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], what=name)
    assert sum(not torch.equal(want[n], old[n]) for n in want) == len(want)


# --- fused step and the factory ---------------------------------------------

def test_train_step_fused_is_step_then_build():
    cfg = APRConfig(**FIELDS)
    raw = _raw(cfg)
    raw_next = tuple(np.roll(x, 1, axis=0) for x in raw)   # pairs swapped
    fused, plain = (get_trainer(cfg, device="cpu", seed=4) for _ in "ab")
    assert isinstance(fused, FCGFTrainer) and fused.config is cfg
    batch = fused.build_batch(raw)
    m_f, built = fused.train_step_fused(batch, raw_next,
                                        torch.Generator().manual_seed(3))
    m_p = plain.train_step(batch, torch.Generator().manual_seed(3))
    want_built = plain.build_batch(raw_next)
    assert m_f.keys() == m_p.keys()
    assert all(torch.equal(m_f[k], m_p[k]) for k in m_f)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(built)),
                    jax.tree_util.tree_leaves(tuple(want_built))):
        assert torch.equal(a, b)
    for a, b in zip(fused.parameters(), plain.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown trainer"):
        get_trainer(dataclasses.replace(cfg, trainer="Nope"), device="cpu")
