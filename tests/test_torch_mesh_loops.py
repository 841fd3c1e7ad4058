"""Both training loops over 2 gloo ranks on the CPU (one process per rank,
the rank bodies in test_torch_rank_bodies.py), on tiny synthetic datasets
at tests/test_torch_loop.py's small widths, against the one-process loop,
and the multi-device dry run.

- ``run_training`` with ``num_devices=2``: rank 0 alone writes config.json,
  metrics.jsonl and the checkpoints; the ranks end with the same state bit
  for bit, and the one-process loop's on the same data within test_torch_
  train's train-step tolerance (``_close``: rtol 1e-4 with a floor of
  1e-4 of the model's largest entry, as its gradients are held; two
  steps compound the rounding of
  the global moments and the summed gradients, which add in another
  order; one step is held to 1e-5 in test_torch_dp_fcgf.py), the
  validation's loss terms too, and its registration metrics finite
  (``POSE_METRICS``);
- the ranks' loader batches of an epoch, put together, are the one-process
  loader's, bit for bit (every rank reads every pair, so the datasets'
  draws are the same);
- ``mesh_n_builders=1`` (one builder, one trainer): the trainer's state
  equals the one-process loop's bit for bit (its mesh is one rank holding
  the whole batch), and the builder writes nothing;
- a split that leaves no trainer logs the reference's warning and falls
  back to serial data parallelism (the ``num_devices=2`` run, bit for
  bit); a pipeline with 0 or all ranks building raises the reference's
  ValueError;
- at the seeds whose loop has a ReLU input at a float32 tie (TIE_SEEDS),
  the two-rank loop leaves the one-process loop's tolerance; with every
  ReLU decision of the one-process loop pinned to the ranks', it is back
  within that tolerance, and each decision the pins changed was a tie;
- ``run_predator_training`` over 2 ranks: one pair per rank, the same
  state on both, rank 0 alone writes;
- ``python -m apr_torch.dryrun 2 --device cpu`` prints its three lines.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import apr_torch.data.datasets as dsmod
import apr_torch.training.loop as loopmod
from apr_torch.config import APRConfig
from apr_torch.data.datasets import make_dataset
from apr_torch.data.pipeline import PairLoader
from apr_torch.parallel import BuilderTrainerPipeline
from apr_torch.parallel.launch import spawn
from apr_torch.parallel.mesh import Mesh
from test_torch_rank_bodies import LOOP_FIELDS, TIE_SEEDS, TINY, \
    ReluDecisions, kernel_move, loop_fields_json, loop_scenarios, \
    module_states, np_tree, tiny_datasets
from test_torch_train import _close

HERE = os.path.dirname(os.path.abspath(__file__))
# the registration metrics of random-weight features: the robust pose on
# mostly wrong correspondences turns on single nearest-neighbour flips
# (1.2e-2 of RRE measured after two steps), so the loops compare the loss
# terms; test_torch_dp_fcgf.py holds one valid step's pose metrics
POSE_METRICS = ("hit_ratio", "feat_match_ratio", "rte", "rre", "success")


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loops")
    ranks = spawn(loop_scenarios, 2, args=(str(tmp),), devices="cpu",
                  timeout=120, deadline=900,
                  init_file=str(tmp / "rdzv"))
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setattr(dsmod, "SyntheticPairDataset", dsmod.SyntheticPairDataset)
        tiny_datasets(*TINY["fcgf"])
        made = []
        real = loopmod.get_trainer

        def make(*a, **k):
            made.append(real(*a, **k))
            return made[-1]
        mp.setattr(loopmod, "get_trainer", make)
        cfg = APRConfig(**LOOP_FIELDS).replace(out_dir=str(tmp / "one"))
        summary = loopmod.run_training(cfg, device="cpu")
        modules = module_states(made[-1])
        ties = {}
        for seed in TIE_SEEDS:
            run = cfg.replace(seed=seed)
            loopmod.run_training(run.replace(
                out_dir=str(tmp / f"one_seed{seed}")), device="cpu")
            free = module_states(made[-1])
            pins = list(zip(*(r[f"dp_seed{seed}"]["relus"]
                              for r in ranks)))
            with ReluDecisions(pins) as relus:
                loopmod.run_training(run.replace(
                    out_dir=str(tmp / f"pinned_seed{seed}")), device="cpu")
            ties[seed] = dict(free=free, pinned=module_states(made[-1]),
                              moved=relus.ties, calls=len(relus.masks),
                              pins=len(pins))
        loader = PairLoader(make_dataset(cfg, "train"), cfg, shuffle=True,
                            seed=cfg.seed, device="cpu")
        loader.set_epoch(0)
        batches = [np_tree(tuple(b)) for b in loader]
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return dict(ranks=ranks, tmp=tmp, ties=ties, one=dict(
        summary=summary, modules=modules, batches=batches))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


def test_rank_zero_alone_writes(loops):
    for name in ("dp", "pipeline", "predator"):
        zero, one = (r[name]["writes"] for r in loops["ranks"])
        assert zero["config"] == 1 and zero["metrics"] > 0
        assert zero["checkpoint"] >= 1
        assert one == dict.fromkeys(one, 0), name
    out = loops["tmp"] / "dp"
    assert (out / "config.json").is_file()
    assert (out / "metrics.jsonl").is_file()
    assert (out / "checkpoints" / "1" / "state.pt").is_file()


def test_data_parallel_ranks_are_equal_and_match_one_process(loops):
    a, b = (r["dp"] for r in loops["ranks"])
    _assert_equal(a["modules"], b["modules"])
    for name in ("last_train", "last_val", "best_val", "steps"):
        assert a["summary"][name] == b["summary"][name]
    one = loops["one"]
    assert a["summary"]["steps"] == one["summary"]["steps"] == 2
    for name in ("last_train", "last_val"):
        for k, v in one["summary"][name].items():
            if k in POSE_METRICS:
                assert np.isfinite(a["summary"][name][k])
                continue
            _close(a["summary"][name][k], v, floor=0, what=k)
    # the floor is of the model's largest entry: the bias of a conv in
    # front of a batch-statistics norm has an analytically zero gradient,
    # so its update is rounding noise on both sides
    scale = max(float(np.abs(y).max()) for y in _leaves(one["modules"]))
    for x, y in zip(_leaves(a["modules"]), _leaves(one["modules"])):
        _close(x, y, scale=scale)


# a ReLU input whose sign the ranks' summation order may flip: within this
# much of 0, relative to the call's largest input (the two-rank and
# one-process inputs differ by up to ~1e-6 of it)
TIE = 1e-6


@pytest.mark.parametrize("seed", TIE_SEEDS)
def test_the_ranks_leave_one_process_only_at_float32_ties(loops, seed):
    """At TIE_SEEDS a ReLU input of the train steps lies within rounding
    of 0 and takes the other sign under the ranks' summation order; the
    flipped element's gradient moves the two-rank loop out of the one-
    process loop's tolerance.  With every ReLU decision of the one-process
    loop pinned to the ranks' (ReluDecisions), the two loops agree within
    the tolerance of test_data_parallel_ranks_are_equal_and_match_one_
    process, and every decision the pins changed had an input within TIE
    of 0: the mesh path computes the one-process loop's function."""
    a, b = (r[f"dp_seed{seed}"] for r in loops["ranks"])
    _assert_equal(a["modules"], b["modules"])
    tie = loops["ties"][seed]
    assert tie["calls"] == tie["pins"]
    assert max(tie["moved"], default=0.0) <= TIE
    want = tie["pinned"]
    scale = max(float(np.abs(y).max()) for y in _leaves(want))
    for x, y in zip(_leaves(a["modules"]), _leaves(want), strict=True):
        _close(x, y, scale=scale)


# the reference loop's own moves under a change of its float32 rounding,
# per seed (written by tests/reference_loop_drift.py)
REF_DRIFT = os.path.join(HERE, "reference_loop_drift.json")
DRIFT_MULTIPLE = 4.0


@pytest.mark.parametrize("seed", TIE_SEEDS)
def test_tie_flips_move_the_loop_as_far_as_they_move_the_reference(loops,
                                                                   seed):
    """apr_tpu's own loop at ``seed`` moves a conv kernel under another
    float32 rounding: on a 2-device mesh against one device, or from
    initial weights nudged by about one ulp (REF_DRIFT, made at this
    module's LOOP_FIELDS and TINY).  The port's two-rank loop moves from
    its one-process loop by at most DRIFT_MULTIPLE times the larger of the
    reference's two moves at that seed."""
    with open(REF_DRIFT) as f:
        ref = json.load(f)
    assert {k: ref[k] for k in ("loop_fields", "tiny")} == \
        loop_fields_json(), "stale: rerun tests/reference_loop_drift.py"
    a = loops["ranks"][0][f"dp_seed{seed}"]
    move = kernel_move(a["modules"], loops["ties"][seed]["free"])
    want = max(ref["mesh"][str(seed)], ref["nudged"][str(seed)])
    assert move <= DRIFT_MULTIPLE * want, (move, want)


def test_the_ranks_loader_batches_make_the_one_process_batches(loops):
    got = [r["loader"] for r in loops["ranks"]]
    want = loops["one"]["batches"]
    assert len(got[0]) == len(got[1]) == len(want) == 2
    for r0, r1, w in zip(got[0], got[1], want):
        for x, y, z in zip(_leaves(r0), _leaves(r1), _leaves(w),
                           strict=True):
            np.testing.assert_array_equal(np.concatenate([x, y]), z)


def test_one_builder_one_trainer_equals_the_serial_loop(loops):
    trainer, builder = (r["pipeline"] for r in loops["ranks"])
    _assert_equal(trainer["modules"], loops["one"]["modules"])
    assert trainer["summary"]["steps"] == builder["summary"]["steps"] == 2
    assert "last_val" in trainer["summary"]
    assert "last_val" not in builder["summary"]


def test_a_split_without_trainers_falls_back_to_serial_dp(loops):
    for r in loops["ranks"]:
        fb = r["fallback"]
        assert any("falling back to serial DP" in w for w in fb["warnings"])
        _assert_equal(fb["modules"], r["dp"]["modules"])


def test_a_pipeline_needs_builders_and_trainers():
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), ranks=(0, 1))
    for n in (0, 2):
        with pytest.raises(ValueError, match=f"n_builders={n} needs 1..1"):
            BuilderTrainerPipeline(None, n, mesh)


def test_predator_loop_over_two_ranks(loops):
    a, b = (r["predator"] for r in loops["ranks"])
    _assert_equal(a["modules"], b["modules"])
    assert a["summary"]["steps"] == b["summary"]["steps"] == 1
    assert np.isfinite(a["summary"]["last_val"]["loss"])
    assert a["summary"]["last_val"] == b["summary"]["last_val"]


def test_dryrun_on_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "apr_torch.dryrun", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(HERE))
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("dryrun_multichip(2): ")]
    assert [ln.split(": ")[1].split()[0] for ln in lines] == [
        "FCGF", "mesh-pipeline", "Predator"]
    assert all(ln.endswith(" ok") for ln in lines)
