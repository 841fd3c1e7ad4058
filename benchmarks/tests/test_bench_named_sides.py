"""A configuration names its trainer, its tester and how they take a pair
(the top-level key ``"side"`` of its file, ``harness/sides.py::roles_of``):
both loops build both sides from those classes, the faults patch them, a
name that does not resolve stops the run before its set-up, and without
the key the classes and ``pairs`` are those that ``fields.trainer``
gives.  The first gradient is read under any optimizer
(``loops/train.py::first_grad``), and a comparison of no leaves fails."""

import importlib
import math
import time

import pytest
import torch

import apr_torch.eval.predator_tester as program_tester
import apr_torch.training.predator as program_trainer
import stub_reference
import tiny
from harness import cells, checks, faults
from harness.common import generator
from harness.report import run_cell
from harness.sides import PROGRAM, REFERENCE, Side, roles_of

CPU = torch.device("cpu")
STUB = "stub_reference"
NAMED = {"trainer": "training.predator:RecordingTrainer",
         "tester": "eval.predator_tester:RecordingTester", "pairs": "one"}


@pytest.mark.parametrize("name,trainer,tester,pairs", [
    ("fcgf-apr.train", "training.trainer.FCGFTrainer",
     "eval.tester.FeatureTester", "group"),
    ("fcgf-apr.reg", "training.trainer.FCGFTrainer",
     "eval.tester.FeatureTester", "group"),
    ("predator-apr.train", "training.predator.PredatorTrainer",
     "eval.predator_tester.PredatorTester", "one")])
def test_a_cell_without_a_side_keeps_its_trainers_classes(
        name, trainer, tester, pairs):
    cell = cells.load_cell(name)
    assert "side" not in cell.config
    roles = roles_of(cell)
    assert roles.pairs == pairs
    for pkg in (REFERENCE, PROGRAM):
        want = tuple(getattr(importlib.import_module(f"{pkg}.{m}"), c)
                     for m, _, c in (p.rpartition(".")
                                     for p in (trainer, tester)))
        assert roles.classes(pkg) == want
    side = Side(PROGRAM, tiny.cell(name).config["fields"], CPU, roles)
    assert side.pairs == pairs
    assert (type(side.trainer), type(side.tester)) == want


@pytest.fixture
def recording(monkeypatch):
    """Recording subclasses of the program's PredatorTrainer and
    PredatorTester under the names that :data:`NAMED` gives, beside the
    stub reference's; the calls that both sides made."""
    monkeypatch.setattr(program_trainer, "RecordingTrainer",
                        stub_reference.recording(
                            program_trainer.PredatorTrainer, "program",
                            stub_reference.TRAINER_CALLS), raising=False)
    monkeypatch.setattr(program_tester, "RecordingTester",
                        stub_reference.recording(
                            program_tester.PredatorTester, "program",
                            stub_reference.TESTER_CALLS), raising=False)
    del stub_reference.USED[:]
    return stub_reference.USED


@pytest.mark.parametrize("name,call", [
    ("predator-apr.train", "PredatorTrainer.train_step"),
    ("predator-apr.reg", "PredatorTester.eval_one")])
def test_a_named_side_runs_both_sides_through_its_classes(recording, name,
                                                          call):
    cell = tiny.cell(name)
    cell.config.update(reference=STUB, side=NAMED)
    torch.manual_seed(0)
    out = run_cell(cell, tiny.SEED, 1.0, False, CPU, time.perf_counter())
    assert out["correct"], out["checks"]
    calls = [u for u in recording if isinstance(u, tuple)]
    for side in ("program", "reference"):
        assert {"PredatorTrainer.__init__", "PredatorTester.__init__",
                call} <= {c for s, c in calls if s == side}, side


def test_a_fault_patches_the_class_that_the_side_names(recording):
    cell = tiny.cell("predator-apr.train")
    cell.config.update(reference=STUB, side=NAMED)
    named, base = program_trainer.RecordingTrainer, \
        program_trainer.PredatorTrainer
    step, base_step = named.train_step, base.train_step
    with faults.unchanged(cell):
        assert named.train_step is not step
        assert base.train_step is base_step
    assert named.train_step is step
    with pytest.raises(ValueError):
        with faults.half_batch(cell):
            pass



@pytest.mark.parametrize("side,key,reference", [
    ("training.predator:PredatorTrainer", '"side"', STUB),
    (dict(NAMED, trainer="training.no_such:PredatorTrainer"),
     '"side".trainer', STUB),
    (dict(NAMED, trainer="training.predator:NoSuchTrainer"),
     '"side".trainer', STUB),
    (dict(NAMED, trainer="training.batching:make_pair_batch"),
     '"side".trainer', STUB),
    (dict(NAMED, tester="eval.predator_tester.PredatorTester"),
     '"side".tester', STUB),
    # resolves in the program but not in the configuration's reference
    (NAMED, '"side".trainer', None),
    (dict(NAMED, pairs="two"), '"side".pairs', STUB),
    ({k: v for k, v in NAMED.items() if k != "pairs"}, '"side".pairs',
     STUB),
    (dict(NAMED, optimizer="Adam"), '"side".optimizer', STUB)])
@pytest.mark.parametrize("mix", ["train", "reg"])
def test_a_side_that_does_not_resolve_stops_before_setup(
        recording, monkeypatch, mix, side, key, reference):
    cell = tiny.cell("predator-apr." + mix)
    cell.config["side"] = side
    if reference:
        cell.config["reference"] = reference
    loop = cells.loop_module(cell.mix["loop"])

    def set_up(*args, **kw):
        raise AssertionError("set-up began")

    monkeypatch.setattr(loop, "Side", set_up)
    monkeypatch.setattr(loop, "make_pool", set_up)
    with pytest.raises(SystemExit) as e:
        loop.run(cell, tiny.SEED, 1.0, False, CPU, time.perf_counter())
    assert str(e.value).startswith(cell.config_file + ": " + key + " ")


@pytest.fixture(scope="module")
def adam():
    """predator-apr.train at a tiny size under Adam: the cell and the
    names of its trained leaves."""
    cell = tiny.cell("predator-apr.train")
    cell.config["fields"]["optimizer"] = "Adam"
    side = Side(PROGRAM, cell.config["fields"], CPU, roles_of(cell))
    assert isinstance(side.trainer.optimizer, torch.optim.AdamW)
    trained = {n for n, p in side.named_parameters() if p.requires_grad}
    return cell, trained


def _compared(cell, monkeypatch):
    """Run ``cell``: its result line and the (program, reference) norms
    of every ``worst_leaf_gap`` it took, in order (grad, move, window_grad,
    window_move)."""
    seen = []
    gap = checks.worst_leaf_gap

    def recorded(prog, ref):
        seen.append((prog, ref))
        return gap(prog, ref)

    monkeypatch.setattr(checks, "worst_leaf_gap", recorded)
    torch.manual_seed(0)
    out = run_cell(cell, tiny.SEED, 1.0, False, CPU, time.perf_counter())
    return out, {n: v for n, v, _ in out["checks"]}, seen


def test_adam_grad_covers_every_trained_leaf(adam, monkeypatch):
    cell, trained = adam
    out, values, seen = _compared(cell, monkeypatch)
    assert out["correct"], out["checks"]
    assert values["grad_gap"] == 0.0 and values["window_grad_gap"] == 0.0
    for prog, ref in (seen[0], seen[2]):
        assert set(prog) == set(ref) == trained
        # every leaf as optimizer.step received it, none left at the zero
        # that a skipped step reads
        assert min(ref.values()) > 0.0
        assert prog == ref


def test_adam_unchanged_step_fails_grad_gap(adam, monkeypatch):
    cell, trained = adam
    with faults.unchanged(cell):
        out, values, seen = _compared(cell, monkeypatch)
    assert out["correct"] is False
    limits = cell.limits
    for number in ("grad_gap", "window_grad_gap"):
        assert values[number] > limits[number], number
    prog, ref = seen[0]
    assert set(prog) == trained and set(prog.values()) == {0.0}


@pytest.mark.parametrize("name", ["fcgf-apr.train", "predator-apr.train"])
def test_sgd_grad_is_the_momentum_buffers_change(name):
    """Under SGD with momentum, ``first_grad`` reads what the loop read
    before any optimizer could be named: each leaf's momentum buffer's
    change in the step, on a fresh optimizer and on one with buffers."""
    loop = cells.loop_module("train")
    cell = tiny.cell(name)
    fields, roles = cell.config["fields"], roles_of(cell)
    a, b = (Side(PROGRAM, fields, CPU, roles) for _ in range(2))
    b.trainer.load_state_dict(a.trainer.state_dict())
    feed = loop.Feed(a, cell.mix, cell.config["frames"]["train"], tiny.SEED)
    gen_a, gen_b = generator(CPU, 5), generator(CPU, 5)
    for k in range(2):
        batch = a.trainer.build_batch(feed.raw(k))
        _, got = loop.first_grad(a, lambda: a.trainer.train_step(batch,
                                                                 gen_a))
        trained = [(n, p) for n, p in b.named_parameters()
                   if p.requires_grad]
        state = b.trainer.optimizer.state
        mom0 = {n: state[p]["momentum_buffer"].clone() for n, p in trained
                if "momentum_buffer" in state.get(p, {})}
        b.trainer.train_step(b.trainer.build_batch(feed.raw(k)), gen_b)
        want = checks.leaf_norms({
            n: state[p]["momentum_buffer"] - mom0.get(n, 0.0)
            for n, p in trained})
        assert got == want and len(want) == len(trained)


@pytest.mark.parametrize("prog,ref,gap", [
    ({}, {}, math.inf),
    ({"a": 1.0}, {}, math.inf),
    ({"a": 0.0, "b": 0.0}, {"a": 0.0, "b": 0.0}, 0.0),
    ({}, {"a": 2.0, "b": 2.0}, 1.0)])
def test_a_comparison_of_no_leaves_fails(prog, ref, gap):
    assert checks.worst_leaf_gap(prog, ref) == gap
