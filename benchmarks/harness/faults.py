"""Faults planted in the program under the timed path, which the
comparison has to catch (``correct`` false): the benchmark's tests plant
them at a tiny size on the CPU, and ``run.py --fault <name>`` at the
cell's own size on the card.  The benchmark's own runs plant none."""

from __future__ import annotations

import contextlib

import torch


def _unchanged(self, batch, generator=None, *args, **kw):
    """A train step that returns its state unchanged."""
    with torch.no_grad():
        _, metrics = self.loss_fn(batch, generator)
    return dict(metrics, skipped_nonfinite=torch.zeros(()))


@contextlib.contextmanager
def _patched(cls, name, fn):
    orig = getattr(cls, name)
    setattr(cls, name, fn)
    try:
        yield
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def unchanged():
    """Both trainers' steps leave parameters and optimizer state as they
    were."""
    from apr_torch.training.predator import PredatorTrainer
    from apr_torch.training.trainer import FCGFTrainer

    with _patched(FCGFTrainer, "train_step", _unchanged), \
            _patched(PredatorTrainer, "train_step", _unchanged):
        yield


@contextlib.contextmanager
def half_batch():
    """The FCGF loss over the first half of the batch's pairs only, its
    means taken over that half."""
    from apr_torch.training import batching
    from apr_torch.training.trainer import FCGFTrainer

    loss_fn = FCGFTrainer.loss_fn

    def half(self, batch, *args, **kw):
        b = batch.feats0.shape[0]
        return loss_fn(self, batching._slice_tree(batch, slice(0, b // 2)),
                       *args, **kw)

    with _patched(FCGFTrainer, "loss_fn", half):
        yield


@contextlib.contextmanager
def answer():
    """Each registered pair's pose moved by 5 cm where ``eval_one``
    produces it."""
    from apr_torch.eval import FeatureTester, PredatorTester

    def altered(eval_one):
        def fn(self, *args, **kw):
            t, rte, rre, fit = eval_one(self, *args, **kw)
            t = t.clone()
            t[0, 3] += 0.05
            return t, rte, rre, fit
        return fn

    with _patched(FeatureTester, "eval_one",
                  altered(FeatureTester.eval_one)), \
            _patched(PredatorTester, "eval_one",
                     altered(PredatorTester.eval_one)):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "answer": answer}
