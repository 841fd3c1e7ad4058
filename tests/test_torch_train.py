"""The FCGF-APR training slice of apr_torch against apr_tpu, at a small
size on the CPU: the same numpy inputs, the same (bridged) weights and the
reference's own random draws replayed.  Its units are held to the
reference in tests/test_torch_train_units.py.

Tolerances, each with its reason:
- batches (voxels, maps, GT correspondences, APC dedup): exact, integer
  and selection work;
- the pair fold of the encoder against two forwards: 1e-5 relative,
  float32 sums in another order;
- the whole train step (loss terms, gradients, updated parameters and
  running stats, two steps so that momentum counts): 1e-4 relative with an
  absolute floor of 1e-4 of each tensor's largest entry, because the
  rounding differences of a 4-level U-Net with batch-statistic norms
  compound through the forward and the backward;
- validation: the loss terms as the train step; RTE / RRE within 1e-3, the
  20 IRLS solves of the pose fit amplify rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.synthetic import synthetic_pair as ref_synthetic_pair
from apr_tpu.training import get_trainer
from apr_torch.bridge import load_flax_train_state_, mlp_state_dict, \
    resunet_state_dict
from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.losses import contrastive
from apr_torch.training.trainer import FCGFTrainer

FIELDS = dict(
    trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=16,
    conv1_kernel_size=3, generator_model="GenerativeMLP_54",
    point_generation_ratio=2, batch_size=2, num_pos_per_batch=64,
    num_hn_samples_per_batch=32, voxel_size=0.75, point_capacity=1024,
    capacities=(256, 128, 64, 32), apc_capacity=1024,
    compute_dtype="float32", chamfer_mode="pallas",
)
PAIRS = [dict(seed=s, n_points=1000, apc_points=1000, distance=4.0,
              extent=12.0) for s in (0, 1)]
KEYS = (11, 12, 13)                  # two train steps and the valid step
TOL = 1e-5


def _raw(cfg):
    """The nine padded arrays of a batch of PAIRS."""
    pairs = [synthetic_pair(**p) for p in PAIRS]
    for p, kw in zip(pairs, PAIRS):
        want = ref_synthetic_pair(**kw)
        for k in ("points0", "points1", "apc0", "apc1", "t_gt"):
            np.testing.assert_array_equal(p[k], want[k])

    def stack(key, cap):
        ps, ms = zip(*[pad_points(p[key], cap) for p in pairs])
        return np.stack(ps), np.stack(ms)

    p0, m0 = stack("points0", cfg.point_capacity)
    p1, m1 = stack("points1", cfg.point_capacity)
    a0, am0 = stack("apc0", cfg.apc_capacity)
    a1, am1 = stack("apc1", cfg.apc_capacity)
    return p0, m0, p1, m1, a0, am0, a1, am1, np.stack([p["t_gt"]
                                                       for p in pairs])


def _randomize(tree, seed):
    """Every leaf of a flax tree drawn from numpy (kernels at the init's
    scale, random norm scales, biases and running stats), so that the
    bridge of every leaf matters."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = np.sqrt(6.0 / np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _scores(key, sizes):
    """The uniform scores the reference draws for the hardest-contrastive
    samples of ``hardest_contrastive_loss(key)`` (contrastive.py:78-83)."""
    return [np.asarray(jax.random.uniform(k, (n,)))
            for k, n in zip(jax.random.split(key, 3), sizes)]


def _replay(monkeypatch, queue):
    """Make the port's sampler take the queued reference scores."""
    def sample(generator, mask, num):
        return contrastive.top_valid(
            torch.from_numpy(queue.pop(0).copy()), mask, num)
    monkeypatch.setattr(contrastive, "_sample_without_replacement", sample)


def _step_scores(key, batch):
    """The scores of the train / valid step with ``key`` (trainer.py:346)."""
    n = int(np.prod(batch.pos_mask.shape))
    m = int(np.prod(batch.pyramid0.levels[0].mask.shape))
    return _scores(jax.random.split(key)[0], (n, m, m))


def _close(got, want, rtol=1e-4, floor=1e-4, what="", scale=None):
    """allclose with an absolute floor of ``floor`` times ``scale`` (by
    default the largest entry of ``want``)."""
    want = np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    atol = floor * max(scale, 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.fixture(scope="module")
def run():
    """Both trainers from the same randomized flax state: the reference's
    batch, gradients of the first step, state after two train steps and a
    valid step; the port's trainer and batch."""
    ref_cfg, cfg = RefConfig(**FIELDS), APRConfig(**FIELDS)
    raw = _raw(cfg)
    ref_trainer = get_trainer(ref_cfg)
    ref_batch = ref_trainer.build_batch(tuple(map(jnp.asarray, raw)))
    state = ref_trainer.init_state(jax.random.PRNGKey(0), ref_batch)
    state = state._replace(params=_randomize(state.params, 1),
                           batch_stats=_randomize(state.batch_stats, 2))
    keys = [jax.random.PRNGKey(k) for k in KEYS]
    grads = jax.jit(jax.grad(lambda p: ref_trainer.loss_fn(
        p, state.batch_stats, ref_batch, keys[0], True)[0]))(state.params)
    states, metrics = [state], []
    for k in keys[:2]:
        s, m = ref_trainer.train_step(states[-1], ref_batch, k)
        states.append(s)
        metrics.append(m)
    valid = ref_trainer.valid_step(states[-1], ref_batch, keys[2])

    trainer = FCGFTrainer(cfg, device="cpu")
    load_flax_train_state_(trainer, state.params, state.batch_stats)
    return dict(raw=raw, cfg=cfg, ref_trainer=ref_trainer,
                ref_batch=ref_batch, states=states, grads=grads,
                metrics=metrics, valid=valid, keys=keys, trainer=trainer,
                batch=trainer.build_batch(raw))


# --- batches -----------------------------------------------------------

def test_pair_batch_with_correspondences_matches_exactly(run):
    batch, ref = run["batch"], run["ref_batch"]
    got = jax.tree_util.tree_leaves(tuple(batch))
    want = jax.tree_util.tree_leaves(tuple(ref))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(batch.pos_mask.sum()) > 100                 # positives exist
    m = batch.apc0_mask.sum(1)
    assert (m > 0).all() and (m < run["cfg"].apc_capacity).all()


# --- the trainer ---------------------------------------------------------

def test_encode_pair_train_fold_matches_sequential(run):
    """The 2B fold with per-side statistics equals two sequential train
    forwards: the same features and the same running stats after both."""
    trainer, batch = run["trainer"], run["batch"]
    before = [b.clone() for b in trainer.encoder.buffers()]
    with torch.no_grad():
        seq = trainer._encode_pair(batch, train=True, fold=False)
        seq_stats = [b.clone() for b in trainer.encoder.buffers()]
        for b, old in zip(trainer.encoder.buffers(), before):
            b.copy_(old)
        fold = trainer._encode_pair(batch, train=True, fold=True)
        fold_stats = [b.clone() for b in trainer.encoder.buffers()]
        for b, old in zip(trainer.encoder.buffers(), before):
            b.copy_(old)
    for a, c in zip(fold, seq):
        _close(a, c, rtol=TOL, floor=TOL)
    for a, c in zip(fold_stats, seq_stats):
        _close(a, c, rtol=TOL, floor=TOL)
    assert any(not torch.equal(a, c) for a, c in zip(fold_stats, before))
    assert not trainer.encoder.training


def _params_of(trainer):
    return {**{f"encoder.{k}": p for k, p in
               trainer.encoder.named_parameters()},
            **{f"generator.{k}": p for k, p in
               trainer.generator.named_parameters()}}


def _ref_named(params, stats=None):
    stats = stats or {"encoder": {}, "generator": {}}
    out = {f"encoder.{k}": v for k, v in resunet_state_dict(
        params["encoder"], stats["encoder"]).items()}
    out.update({f"generator.{k}": v for k, v in mlp_state_dict(
        params["generator"], stats["generator"]).items()})
    return out


@pytest.fixture(scope="module")
def port_steps(run):
    """Two port train steps with the reference's draws; the gradients of
    the first, the metrics, and the state after each."""
    trainer, batch = run["trainer"], run["batch"]
    mp = pytest.MonkeyPatch()
    try:
        out = []
        for key in run["keys"][:2]:
            _replay(mp, _step_scores(key, run["ref_batch"]))
            metrics = trainer.train_step(batch)
            out.append(dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad.clone() for k, p in
                       _params_of(trainer).items()},
                state={**{f"encoder.{k}": v.clone() for k, v in
                          trainer.encoder.state_dict().items()},
                       **{f"generator.{k}": v.clone() for k, v in
                          trainer.generator.state_dict().items()}}))
        _replay(mp, _step_scores(run["keys"][2], run["ref_batch"]))
        valid = {k: float(v) for k, v in trainer.valid_step(batch).items()}
    finally:
        mp.undo()
    return out, valid


def test_train_step_gradients_match(run, port_steps):
    """The floor is the model's largest gradient: the bias of a conv in
    front of a batch-statistics norm has a zero gradient in exact
    arithmetic, so both sides hold rounding noise (~1e-9) there."""
    got = port_steps[0][0]["grads"]
    want = _ref_named(run["grads"])
    assert set(got) == set(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in want:
        _close(got[name], want[name], what=name, scale=scale)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_loss_terms_params_and_stats_match(run, port_steps, step):
    got = port_steps[0][step]
    for name, value in run["metrics"][step].items():
        _close(got["metrics"][name], value, floor=0, what=name)
    assert got["metrics"]["skipped_nonfinite"] == 0.0
    s = run["states"][step + 1]
    want = _ref_named(s.params, s.batch_stats)
    assert set(got["state"]) == set(want)
    moved = 0
    for name in want:
        _close(got["state"][name], want[name], what=name)
        old = _ref_named(run["states"][step].params,
                         run["states"][step].batch_stats)[name]
        moved += not np.array_equal(np.asarray(old), np.asarray(want[name]))
    assert moved == len(want)


def test_valid_step_metrics_match(run, port_steps):
    got, want = port_steps[1], run["valid"]
    assert set(got) == set(want)
    for name in ("loss", "pos_loss", "neg_loss", "chamfer_loss",
                 "regularization_loss", "hit_ratio", "feat_match_ratio",
                 "success"):
        _close(got[name], want[name], floor=0, what=name)
    for name in ("rte", "rre"):
        _close(got[name], want[name], rtol=1e-3, floor=1e-3, what=name)


def test_nan_gate_leaves_every_piece_of_state(run):
    """A non-finite loss skips the step: parameters, the optimizer's
    momentum and every running stat stay as they were."""
    cfg = run["cfg"]
    trainer = FCGFTrainer(cfg, device="cpu", seed=3)
    batch = run["batch"]
    trainer.train_step(batch, torch.Generator().manual_seed(0))
    before = {k: v.clone() for m in trainer.modules()
              for k, v in m.state_dict().items()}
    momentum = [trainer.optimizer.state[p]["momentum_buffer"].clone()
                for p in trainer.parameters()]
    bad = batch._replace(apc0=batch.apc0.clone())
    bad.apc0[0, 0] = float("inf")
    metrics = trainer.train_step(bad, torch.Generator().manual_seed(1))
    assert float(metrics["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(metrics["loss"]))
    after = {k: v for m in trainer.modules()
             for k, v in m.state_dict().items()}
    for k in before:
        assert torch.equal(before[k], after[k]), k
    for p, buf in zip(trainer.parameters(), momentum):
        assert torch.equal(trainer.optimizer.state[p]["momentum_buffer"],
                           buf)
    assert trainer.step == 2
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(2))
    assert float(metrics["skipped_nonfinite"]) == 0.0


def test_lr_schedule_and_optimizers(run):
    trainer = run["trainer"]
    cfg = run["cfg"]
    assert trainer.set_lr(10) == pytest.approx(cfg.lr * cfg.exp_gamma ** 10)
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(
        cfg.lr * cfg.exp_gamma ** 10)
    trainer.set_lr(0)
    adam = FCGFTrainer(APRConfig(**{**FIELDS, "optimizer": "Adam"}),
                       device="cpu")
    assert isinstance(adam.optimizer, torch.optim.Adam)
    assert adam.optimizer.defaults["weight_decay"] == cfg.weight_decay


def test_bridge_is_strict_and_later_names_raise(run):
    trainer = run["trainer"]
    state = run["states"][0]
    with pytest.raises(ValueError):
        load_flax_train_state_(trainer, {"encoder": state.params["encoder"]},
                               state.batch_stats)
    extra = dict(state.params["generator"], Dense_9={"bias": np.zeros(2)})
    with pytest.raises(RuntimeError):
        load_flax_train_state_(trainer, dict(state.params, generator=extra),
                               state.batch_stats)
    # the slice-2b modes no longer raise: the symmetric ResUNet decoder
    # loads through the bridge's ResUNet names (its strictness as above)
    sym = FCGFTrainer(APRConfig(**{**FIELDS, "symmetric": True,
                                   "generator_model": "ResUNetBN2B"}),
                      device="cpu")
    with pytest.raises(RuntimeError):
        load_flax_train_state_(sym, state.params, state.batch_stats)
    assert FCGFTrainer(APRConfig(**{**FIELDS, "iter_size": 2}),
                       device="cpu").accumulation.every_k == 2
    tri = FCGFTrainer(APRConfig(**{**FIELDS, "trainer": "TripletLossTrainer"}),
                      device="cpu")
    loss, metrics = tri.loss_fn(run["batch"], torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss.detach())) and float(
        metrics["neg_loss"]) == 0.0


def test_validate_convergence_loop_matches_the_reference_tool(run):
    """The first two steps of ``apr_torch.tools.validate_convergence``'s
    loop against the reference tool's (tools/validate_convergence.py:94-
    100: ``set_lr`` at step 0, then ``train_step`` with
    ``PRNGKey(step)``), from the same weights with the draws replayed:
    every loss term within the train step's tolerance."""
    from apr_torch.tools.validate_convergence import train

    ref_trainer, state = run["ref_trainer"], run["states"][0]
    s = ref_trainer.set_lr(state, 0)
    want = []
    for step in range(2):
        s, m = ref_trainer.train_step(s, run["ref_batch"],
                                      jax.random.PRNGKey(step))
        want.append(m)
    trainer = FCGFTrainer(run["cfg"], device="cpu")
    load_flax_train_state_(trainer, state.params, state.batch_stats)
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # many small ops: see test_torch_loop.py
    try:
        _replay(mp, [x for step in range(2) for x in _step_scores(
            jax.random.PRNGKey(step), run["ref_batch"])])
        got = train(trainer, [run["batch"]], 2, lambda step: None)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    for g, w in zip(got, want, strict=True):
        assert g["skipped_nonfinite"] == 0.0
        for name, value in w.items():
            _close(g[name], float(value), floor=0, what=name)
