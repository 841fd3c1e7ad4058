"""The FCGF-APR train step data parallel over 2 gloo ranks on the CPU (one
pair each), against apr_tpu's train step on a 2-device mesh and against
the port's own one-process step, at tests/test_torch_train.py's small
config, from the same randomized weights, with the reference's
contrastive draws replayed on every rank (the rank bodies are in
test_torch_rank_bodies.py).

- each rank's build of its slice equals the matching slice of the
  one-process build, exactly (keys, kernel maps, correspondences);
- the ranks' loss terms, parameters and running stats are equal bit for
  bit (every rank computes the same global loss and the same summed
  gradients);
- against apr_tpu on the mesh: test_torch_train's step tolerance (loss
  terms rtol 1e-4; parameters and running stats ``_close`` at rtol 1e-4
  with a floor of 1e-4 of each tensor's largest entry), two steps;
- against one process: ``TOL`` (1e-5) relative with a floor of ``TOL`` of
  each tensor's largest entry (the gradients: of the model's largest
  gradient, as there): the global moments and the summed gradients add in
  another order;
- ``iter_size=2``: the weights move on the second mini-step only, and the
  result is the one-process one within ``TOL``;
- the valid step's metrics are the global batch's: equal on the ranks,
  the one-process ones within ``TOL`` (RTE / RRE within 1e-3, as in
  test_torch_train: the IRLS pose amplifies rounding);
- a non-finite target on one rank only: every rank skips the step, and
  nothing changes; the next step is taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.parallel import make_mesh as ref_make_mesh
from apr_tpu.parallel import replicate as ref_replicate
from apr_tpu.parallel import shard_batch as ref_shard_batch
from apr_tpu.training import get_trainer
from apr_torch.bridge import load_flax_train_state_
from apr_torch.config import APRConfig
from apr_torch.parallel.launch import spawn
from apr_torch.training.trainer import FCGFTrainer
from test_torch_rank_bodies import fcgf_dp, module_states
from test_torch_train import FIELDS, KEYS, TOL, _close, _randomize, _raw, \
    _ref_named, _replay, _step_scores


def _named(states):
    """[encoder, generator] state dicts -> one dict by the port's names."""
    return {f"{tag}.{k}": v for tag, sd in zip(("encoder", "generator"),
                                               states)
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    ref_cfg, cfg = RefConfig(**FIELDS), APRConfig(**FIELDS)
    raw = _raw(cfg)
    ref_trainer = get_trainer(ref_cfg)
    ref_batch = ref_trainer.build_batch(tuple(map(jnp.asarray, raw)))
    state = ref_trainer.init_state(jax.random.PRNGKey(0), ref_batch)
    state = state._replace(params=_randomize(state.params, 1),
                           batch_stats=_randomize(state.batch_stats, 2))
    keys = [jax.random.PRNGKey(k) for k in KEYS[:2]]
    queues = [_step_scores(k, ref_batch) for k in keys]

    mesh = ref_make_mesh(jax.devices()[:2])
    ref_states, ref_metrics = [ref_replicate(state, mesh)], []
    sharded = ref_shard_batch(ref_batch, mesh)
    for k in keys:
        s, m = ref_trainer.train_step(ref_states[-1], sharded, k)
        ref_states.append(s)
        ref_metrics.append({n: float(v) for n, v in m.items()})

    one = FCGFTrainer(cfg, device="cpu", seed=5)
    load_flax_train_state_(one, state.params, state.batch_stats)
    modules = module_states(one)
    ranks = spawn(fcgf_dp, 2, args=(FIELDS, modules, raw, queues),
                  devices="cpu", timeout=60, deadline=600,
                  init_file=str(tmp_path_factory.mktemp("dp") / "rdzv"))

    batch = one.build_batch(raw)
    mp = pytest.MonkeyPatch()
    try:
        steps = []
        for q in queues:
            _replay(mp, list(q))
            m = one.train_step(batch)
            steps.append(dict(
                metrics={n: float(v) for n, v in m.items()},
                state=module_states(one),
                grads=[p.grad.clone().numpy() for p in one.parameters()]))
        acc = FCGFTrainer(cfg.replace(iter_size=2), device="cpu", seed=5)
        load_flax_train_state_(acc, state.params, state.batch_stats)
        for q in queues:
            _replay(mp, list(q))
            acc.train_step(batch)
        _replay(mp, list(queues[-1]))
        valid = {n: float(v) for n, v in one.valid_step(batch).items()}
    finally:
        mp.undo()
    return dict(ranks=ranks, batch=batch, steps=steps, valid=valid,
                iter2=module_states(acc), ref_states=ref_states,
                ref_metrics=ref_metrics)


def test_each_ranks_build_is_its_slice_of_the_one_process_build(dp):
    whole = jax.tree_util.tree_leaves(tuple(dp["batch"]))
    for r, got in enumerate(dp["ranks"]):
        got = jax.tree_util.tree_leaves(got["build"])
        assert len(got) == len(whole)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g, w[r:r + 1].numpy())


def test_the_ranks_are_equal_bit_for_bit(dp):
    a, b = dp["ranks"]
    for sa, sb in zip(a["steps"], b["steps"]):
        assert sa["metrics"] == sb["metrics"]
        for x, y in zip(_named(sa["state"]).values(),
                        _named(sb["state"]).values()):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(sa["grads"], sb["grads"]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("step", [0, 1])
def test_two_ranks_match_the_reference_mesh(dp, step):
    got = dp["ranks"][0]["steps"][step]
    for name, value in dp["ref_metrics"][step].items():
        _close(got["metrics"][name], value, floor=0, what=name)
    assert got["metrics"]["skipped_nonfinite"] == 0.0
    s = dp["ref_states"][step + 1]
    want = _ref_named(jax.device_get(s.params),
                      jax.device_get(s.batch_stats))
    named = _named(got["state"])
    assert set(named) == set(want)
    for name in want:
        _close(named[name], want[name], what=name)


@pytest.mark.parametrize("step", [0, 1])
def test_two_ranks_match_one_process(dp, step):
    got, want = dp["ranks"][0]["steps"][step], dp["steps"][step]
    for name, value in want["metrics"].items():
        _close(got["metrics"][name], value, rtol=TOL, floor=0, what=name)
    a, b = _named(got["state"]), _named(want["state"])
    for name in b:
        _close(a[name], b[name], rtol=TOL, floor=TOL, what=name)
    scale = max(float(np.abs(g).max()) for g in want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        _close(g, w, rtol=TOL, floor=TOL, scale=scale)


def test_iter_size_two_accumulates_the_summed_gradients(dp):
    for got in dp["ranks"]:
        assert got["iter2"]["moved"] == [False, True]
        assert got["iter2"]["mini_step"] == 0
        a, b = _named(got["iter2"]["state"]), _named(dp["iter2"])
        for name in b:
            _close(a[name], b[name], rtol=TOL, floor=TOL, what=name)


def test_the_valid_step_gathers_the_global_metrics(dp):
    a, b = (r["valid"] for r in dp["ranks"])
    assert a == b
    want = dp["valid"]
    assert set(a) == set(want)
    for name, value in want.items():
        tol = 1e-3 if name in ("rte", "rre") else TOL
        _close(a[name], value, rtol=tol, floor=0, what=name)


def test_a_non_finite_rank_makes_every_rank_skip(dp):
    for got in dp["ranks"]:
        nf = got["nonfinite"]
        assert nf["skipped"] == 1.0 and not np.isfinite(nf["loss"])
        assert nf["unchanged"] and nf["momenta_after_skip"] == 0
        assert nf["next_skipped"] == 0.0 and nf["step"] == 2
