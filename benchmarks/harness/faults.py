"""Faults planted in the program under the timed path, which the
comparison has to catch (``correct`` false): the benchmark's tests plant
them at a tiny size on the CPU, and ``run.py --fault <name>`` at the
cell's own size on the card.  The benchmark's own runs plant none.
Each takes the cell and patches the classes that its configuration names
(``harness/sides.py::roles_of``), whatever they are."""

from __future__ import annotations

import contextlib

import torch

from harness.sides import PROGRAM, roles_of


def _unchanged(self, batch, generator=None, *args, **kw):
    """A train step that returns its state unchanged."""
    with torch.no_grad():
        _, metrics = self.loss_fn(batch, generator)
    return dict(metrics, skipped_nonfinite=torch.zeros(()))


_INHERITED = object()


@contextlib.contextmanager
def _patched(cls, name, fn):
    own = cls.__dict__.get(name, _INHERITED)
    setattr(cls, name, fn)
    try:
        yield
    finally:
        if own is _INHERITED:
            delattr(cls, name)
        else:
            setattr(cls, name, own)


def _program(cell):
    """The program's trainer and tester classes that ``cell``'s
    configuration names (``harness/sides.py::roles_of``)."""
    return roles_of(cell).classes(PROGRAM)


@contextlib.contextmanager
def unchanged(cell):
    """The cell's trainer's step leaves parameters and optimizer state as
    they were."""
    trainer, _ = _program(cell)
    with _patched(trainer, "train_step", _unchanged):
        yield


@contextlib.contextmanager
def half_batch(cell):
    """The cell's loss over the first half of the batch's pairs only, its
    means taken over that half: a fault of a cell whose steps take a group
    of pairs."""
    from apr_torch.training import batching

    if roles_of(cell).pairs != "group":
        raise ValueError(f"{cell.name} takes one pair a step: it has no "
                         f"half of a batch to leave out")
    trainer, _ = _program(cell)
    loss_fn = trainer.loss_fn

    def half(self, batch, *args, **kw):
        b = batch.feats0.shape[0]
        return loss_fn(self, batching._slice_tree(batch, slice(0, b // 2)),
                       *args, **kw)

    with _patched(trainer, "loss_fn", half):
        yield


@contextlib.contextmanager
def answer(cell):
    """Each registered pair's pose moved by 5 cm where the cell's tester's
    ``eval_one`` produces it."""
    _, tester = _program(cell)
    eval_one = tester.eval_one

    def altered(self, *args, **kw):
        t, rte, rre, fit = eval_one(self, *args, **kw)
        t = t.clone()
        t[0, 3] += 0.05
        return t, rte, rre, fit

    with _patched(tester, "eval_one", altered):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "answer": answer}
