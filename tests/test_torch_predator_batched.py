"""The Predator-APR trainer's AdamW step and its grouped steps and build,
apr_torch against apr_tpu, at the config of
tests/test_torch_predator_train.py (whose helpers and tolerances these
tests share), from the same numpy pairs, weights and replayed draws.

- one AdamW step: loss terms and the first moment as the SGD step there,
  parameters within rtol 1e-3 plus a quarter of the learning rate;
- ``train_step_batched`` on two pairs with uniform and with (1, 0)
  ``pair_weights``: the weighted loss terms, the parameters, the first
  moment and the running stats (the weighted mean of the pairs' updates,
  both pairs starting from the same stats);
- ``valid_step_batched`` is the mean of the pairs' ``valid_step``s and
  ``train_step_batched_fused`` is the step followed by the next group's
  build;
- ``build_batch_group`` equals the reference's grouped build exactly, on
  the small pairs and on a dense slab whose level-0 windowed searches
  overflow, where both keep the overflowed tables (no exact rerun).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.training.predator import PredatorTrainer as RefTrainer
from apr_torch.config import APRConfig
from apr_torch.models.kpconv import build_kp_pyramid
from apr_torch.training.predator import PredatorTrainer, select_pair
from test_torch_kpconv import _clouds
from test_torch_predator_train import FIELDS, STEP_KEY, _close, \
    assert_step_matches, port_state, port_trainer, raw_pair, \
    reference_state, replay

GROUP_KEY = 31


def _leaves_equal(got, want, atol=0.0):
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), tuple(got)))
    want = jax.tree_util.tree_leaves(tuple(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def group():
    """Two pairs stacked; the reference's grouped batch, randomized state
    and grouped SGD step under uniform and (1, 0) pair weights."""
    cfg = APRConfig(**FIELDS)
    raws = [raw_pair(cfg, seed) for seed in (0, 1)]
    raw = tuple(np.stack(col) for col in zip(*raws))
    ref_trainer = RefTrainer(RefConfig(**FIELDS))
    ref_batch = ref_trainer.build_batch_group(tuple(map(jnp.asarray, raw)))
    state = reference_state(ref_trainer,
                            jax.tree.map(lambda x: x[0], ref_batch))
    keys = jax.random.split(jax.random.PRNGKey(GROUP_KEY), 2)
    steps = {w: ref_trainer.train_step_batched(
        state, ref_batch, keys, jnp.asarray(1.0),
        jnp.asarray(w, jnp.float32)) for w in ((0.5, 0.5), (1.0, 0.0))}
    return dict(cfg=cfg, raws=raws, raw=raw, ref_batch=ref_batch,
                state=state, keys=keys, steps=steps,
                n_corr=int(ref_batch.corr_src.shape[1]))


def test_build_batch_group_matches_reference(group):
    trainer = PredatorTrainer(group["cfg"], device="cpu")
    batch = trainer.build_batch_group(group["raw"])
    _leaves_equal(batch, group["ref_batch"], atol=1e-6)
    # pair i of the group is the pair's own batch
    for i, raw in enumerate(group["raws"]):
        _leaves_equal(select_pair(batch, i), tuple(jax.tree.map(
            lambda x: x[i], group["ref_batch"])), atol=1e-6)
        one = trainer.build_batch(raw)
        for a, b in zip(jax.tree_util.tree_leaves(tuple(one)),
                        jax.tree_util.tree_leaves(tuple(select_pair(batch,
                                                                    i)))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("weights", [(0.5, 0.5), (1.0, 0.0)])
def test_train_step_batched_matches_reference(group, monkeypatch, weights):
    state = group["state"]
    state1, metrics = group["steps"][weights]
    trainer = port_trainer(group["cfg"], state.params, state.batch_stats)
    batch = trainer.build_batch_group(group["raw"])
    replay(monkeypatch, list(group["keys"]), group["n_corr"])
    got = trainer.train_step_batched(batch, None, 1.0, pair_weights=weights)
    assert_step_matches(got, metrics, trainer, state1.params,
                        state1.batch_stats, state.params, state1.opt_state,
                        "momentum_buffer")


def test_grouped_valid_and_fused_steps(group, monkeypatch):
    """valid_step_batched is the pairs' mean valid_step and changes no
    state; train_step_batched_fused is train_step_batched followed by the
    next group's build."""
    state, keys = group["state"], list(group["keys"])
    trainer = port_trainer(group["cfg"], state.params, state.batch_stats)
    batch = trainer.build_batch_group(group["raw"])
    before = port_state(trainer)
    replay(monkeypatch, keys, group["n_corr"])
    mean = trainer.valid_step_batched(batch, None, 1.0)
    replay(monkeypatch, keys, group["n_corr"])
    each = [trainer.valid_step(select_pair(batch, i), None, 1.0)
            for i in range(2)]
    for name in mean:
        _close(float(mean[name]), 0.5 * float(each[0][name] + each[1][name]),
               rtol=1e-6, floor=0, what=name)
    assert all(torch.equal(v, port_state(trainer)[k])
               for k, v in before.items())

    fused = port_trainer(group["cfg"], state.params, state.batch_stats)
    replay(monkeypatch, keys, group["n_corr"])
    plain = trainer.train_step_batched(batch, None, 1.0)
    replay(monkeypatch, keys, group["n_corr"])
    metrics, next_batch = fused.train_step_batched_fused(
        batch, None, 1.0, group["raw"])
    for name in plain:
        assert float(metrics[name]) == float(plain[name]), name
    for a, b in zip(jax.tree_util.tree_leaves(tuple(next_batch)),
                    jax.tree_util.tree_leaves(tuple(batch))):
        assert torch.equal(a, b)
    # the CPU backward's threaded scatter-adds sum in no fixed order
    after, want = port_state(fused), port_state(trainer)
    for k in want:
        _close(after[k], want[k], rtol=1e-6, floor=1e-6, what=k)


def test_adamw_step_matches_reference(group, monkeypatch):
    fields = dict(FIELDS, optimizer="Adam")
    ref_trainer = RefTrainer(RefConfig(**fields))
    state = group["state"]
    state = state._replace(opt_state=ref_trainer.tx.init(state.params))
    ref_batch = jax.tree.map(lambda x: x[0], group["ref_batch"])
    key = jax.random.PRNGKey(STEP_KEY)
    state1, metrics = ref_trainer.train_step(state, ref_batch, key,
                                             jnp.asarray(1.0))
    cfg = dataclasses.replace(group["cfg"], optimizer="Adam")
    trainer = port_trainer(cfg, state.params, state.batch_stats)
    replay(monkeypatch, [key], group["n_corr"])
    got = trainer.train_step(trainer.build_batch(group["raws"][0]), None, 1.0)
    assert type(trainer.optimizer) is torch.optim.AdamW
    # AdamW's first step moves each entry by lr * g / (|g| + 1e-8): where
    # g is within rounding of zero, the two sides' steps may differ by a
    # fraction of lr (measured: 0.035 lr); the first moment, (1 - b1) g,
    # holds the gradients to the SGD step's tolerance
    assert_step_matches(got, metrics, trainer, state1.params,
                        state1.batch_stats, state.params, state1.opt_state,
                        "exp_avg", dict(rtol=1e-3, floor=0.25 * cfg.lr,
                                        scale=1.0))


def test_build_batch_group_keeps_overflowed_windowed_tables():
    """A dense slab overflows level 0's windowed searches: the grouped
    build keeps the truncated tables, as the reference's does, where the
    single-pair build reruns them exactly."""
    pts, msk = _clouds("slab")
    zeros = np.zeros((1, 4, 3), np.float32)
    raw = (pts[:1], msk[:1], pts[1:], msk[1:], zeros,
           np.zeros((1, 4), bool), zeros, np.zeros((1, 4), bool),
           np.eye(4, dtype=np.float32)[None])
    fields = dict(FIELDS, first_subsampling_dl=0.3, conv_radius=4.25,
                  kp_capacities=(8192, 2048, 1024, 512),
                  neighborhood_limits=(40,) * 4, overlap_radius=0.45,
                  point_capacity=pts.shape[1])
    want = RefTrainer(RefConfig(**fields)).build_batch_group(
        tuple(map(jnp.asarray, raw)))
    trainer = PredatorTrainer(APRConfig(**fields), device="cpu")
    fallbacks = build_kp_pyramid.fallbacks
    got = trainer.build_batch_group(raw)
    assert build_kp_pyramid.fallbacks == fallbacks
    _leaves_equal(got, want)
    exact = trainer.build_batch(tuple(x[0] for x in raw))
    assert build_kp_pyramid.fallbacks == fallbacks + 4
    for a, b in ((got.pyr0, exact.pyr0), (got.pyr1, exact.pyr1)):
        assert not torch.equal(a.levels[0].neighbors[0],
                               b.levels[0].neighbors)
        assert torch.equal(a.levels[2].neighbors[0], b.levels[2].neighbors)
