"""``correct`` must come out false for the control (the reference one
precision below the configuration's, float8 e4m3 for bf16, in the
program's place) and for each fault the cell can have, planted in the
program under the timed path (``harness/faults.py``)."""

import pytest

import tiny
from harness import faults


@pytest.mark.parametrize("name", ["fcgf-apr.train", "fcgf-apr.reg",
                                  "predator-apr.train"])
def test_control_is_not_correct(name):
    out = tiny.run(name, control=True)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault,name,number", [
    ("unchanged", "fcgf-apr.train", "move_gap"),
    ("unchanged", "predator-apr.train", "move_gap"),
    ("unchanged", "fcgf-apr.train", "window_move_gap"),
    ("half_batch", "fcgf-apr.train", "loss_gap"),
    ("half_batch", "fcgf-apr.train", "window_loss_gap"),
    ("answer", "fcgf-apr.reg", "answer_gap"),
    ("answer", "predator-apr.reg", "answer_gap")])
def test_fault_is_not_correct(fault, name, number):
    with faults.FAULTS[fault](tiny.cell(name)):
        out = tiny.run(name)
    assert out["correct"] is False
    value, limit = {n: (v, lim) for n, v, lim in out["checks"]}[number]
    assert value > limit
