"""The Predator-APR grouped train step data parallel over 2 gloo ranks on
the CPU (one pair each), against apr_tpu's ``train_step_batched`` on a
2-device mesh, at tests/test_torch_predator_train.py's config and weights
(WEIGHT_SEED: no near-tie in the forward), with the pair weights (1, 0) of
a group whose second pair is the loop's repetition padding, and each
pair's reference draws replayed on its own rank (the rank bodies are in
test_torch_rank_bodies.py).

- the ranks' loss terms and states are equal bit for bit;
- against the reference mesh: ``assert_step_matches``'s tolerances (loss
  terms rtol 1e-4; parameters ``STEP_TOL``; the running stats 1e-5; the
  frozen kernel points bit for bit; the momentum rtol 1e-3);
- the same group under uniform weights moves the state another way than
  under (1, 0), so the zero weight reaches the padding rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.parallel import make_mesh as ref_make_mesh
from apr_tpu.parallel import replicate as ref_replicate
from apr_tpu.parallel import shard_batch as ref_shard_batch
from apr_tpu.training.predator import PredatorTrainer as RefTrainer
from apr_torch.config import APRConfig
from apr_torch.parallel.launch import spawn
from apr_torch.training.predator import PredatorTrainer
from test_torch_predator_batched import GROUP_KEY
from test_torch_predator_train import FIELDS, assert_step_matches, \
    port_trainer, raw_pair, reference_state
from test_torch_rank_bodies import module_states, predator_dp, torch_tree

WEIGHTS = {"padded": (1.0, 0.0), "uniform": (0.5, 0.5)}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    cfg = APRConfig(**FIELDS)
    raws = [raw_pair(cfg, seed) for seed in (0, 1)]
    raw = tuple(np.stack(col) for col in zip(*raws))
    ref_trainer = RefTrainer(RefConfig(**FIELDS))
    ref_batch = ref_trainer.build_batch_group(tuple(map(jnp.asarray, raw)))
    state = reference_state(ref_trainer,
                            jax.tree.map(lambda x: x[0], ref_batch))
    keys = jax.random.split(jax.random.PRNGKey(GROUP_KEY), 2)
    n_corr = int(ref_batch.corr_src.shape[1])
    scores = [np.asarray(jax.random.uniform(k, (n_corr,))) for k in keys]
    mesh = ref_make_mesh(jax.devices()[:2])
    ref = ref_trainer.train_step_batched(
        ref_replicate(state, mesh), ref_shard_batch(ref_batch, mesh), keys,
        jnp.asarray(1.0), jnp.asarray(WEIGHTS["padded"], jnp.float32))
    modules = module_states(port_trainer(cfg, state.params,
                                         state.batch_stats))
    out = spawn(predator_dp, 2, args=(FIELDS, modules, raws, WEIGHTS,
                                      scores),
                devices="cpu", timeout=60, deadline=600,
                init_file=str(tmp_path_factory.mktemp("pdp") / "rdzv"))
    ranks = {name: [r[name] for r in out] for name in WEIGHTS}
    return dict(cfg=cfg, state=state, ref=ref, ranks=ranks)


def test_the_ranks_are_equal_bit_for_bit(dp):
    for runs in dp["ranks"].values():
        a, b = runs
        assert a["metrics"] == b["metrics"]
        for x, y in zip(jax.tree_util.tree_leaves(a["state"]["modules"]),
                        jax.tree_util.tree_leaves(b["state"]["modules"])):
            np.testing.assert_array_equal(x, y)


def test_two_ranks_with_a_padding_pair_match_the_reference_mesh(dp):
    state, (state1, metrics) = dp["state"], dp["ref"]
    got = dp["ranks"]["padded"][0]
    trainer = PredatorTrainer(dp["cfg"], device="cpu")
    trainer.load_state_dict(torch_tree(got["state"]))
    assert_step_matches(got["metrics"], metrics, trainer, state1.params,
                        state1.batch_stats, state.params, state1.opt_state,
                        "momentum_buffer")


def test_the_zero_weight_reaches_the_padding_rank(dp):
    padded = dp["ranks"]["padded"][0]
    uniform = dp["ranks"]["uniform"][0]
    assert padded["metrics"]["loss"] != uniform["metrics"]["loss"]
    moved = [not np.array_equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(padded["state"]["modules"]),
        jax.tree_util.tree_leaves(uniform["state"]["modules"]))]
    assert sum(moved) > len(moved) // 2
