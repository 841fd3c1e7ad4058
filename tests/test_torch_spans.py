"""The package's own spans (``apr_torch/utils/profiling.py::span``) and
RANSAC's hypothesis counter, on the CPU at a tiny size.

- With no profiler, ``span`` is one shared null context, and a span opened
  then leaves nothing in a profile taken later; under a profiler it never
  waits for the card.
- Under ``torch.profiler``, for both trainer families: a build gives
  ``build.voxelize``, ``build.maps`` and ``build.corr`` in order; a train
  step ``train.forward`` (holding ``encode``), then ``train.backward``,
  then ``train.update``; a tester step its build, then ``encode``,
  ``match`` and ``ransac`` in order.  Every span of a call is opened once.
  The training loop's ``StepProfiler`` trace names them too.
- ``ransac_from_draws.hypotheses`` rises by ``sum(stage_sizes(...))``
  without escalation and only by the rungs that ran with it, exactly under
  several threads.
"""

import sys
import threading
from typing import List, NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.registration import ransac
from apr_torch.utils import profiling

FCGF = dict(
    trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=16,
    conv1_kernel_size=3, generator_model="GenerativeMLP_54",
    point_generation_ratio=2, batch_size=1, num_pos_per_batch=64,
    num_hn_samples_per_batch=32, voxel_size=0.75, point_capacity=1024,
    capacities=(256, 128, 64, 32), apc_capacity=1024,
    compute_dtype="float32", chamfer_mode="pallas", test_subsample=128,
    test_num_ransac_hypotheses=256)
PREDATOR = dict(
    trainer="PredatorTrainer", final_feats_dim=16, first_feats_dim=32,
    gnn_feats_dim=32, generator_model="GenerativeMLP_54",
    point_generation_ratio=2, first_subsampling_dl=1.0, conv_radius=2.5,
    kp_capacities=(1024, 512, 256, 128), neighborhood_limits=(16,) * 4,
    point_capacity=3000, apc_capacity=2048, pos_radius=1.0,
    safe_radius=2.5, overlap_radius=1.2, matchability_radius=1.2,
    max_points=128, compute_dtype="float32", chamfer_mode="pallas",
    test_subsample=128, test_num_ransac_hypotheses=256)
FAMILIES = ("fcgf", "predator")
BUILD = ["build.voxelize", "build.maps", "build.corr"]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int

    def holds(self, other: "Span") -> bool:
        return self.start_ns <= other.start_ns and other.end_ns <= self.end_ns


def spans_of(fn) -> List[Span]:
    """The ``apr::`` spans of one profiled call of ``fn``, by start (an
    outer span before the inner one that starts with it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [Span(e.name()[len(profiling.SPAN_PREFIX):], e.start_ns(),
                e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.SPAN_PREFIX)]
    return sorted(out, key=lambda s: (s.start_ns, -s.end_ns))


def _pair(family: str, seed: int = 0):
    if family == "fcgf":
        return synthetic_pair(seed, n_points=1000, apc_points=1000,
                              distance=4.0, extent=12.0)
    return synthetic_pair(seed, n_points=2500, apc_points=2000, distance=8.0,
                          extent=30.0)


def _trainer(family: str):
    torch.manual_seed(0)
    if family == "fcgf":
        from apr_torch.training.trainer import FCGFTrainer

        return FCGFTrainer(APRConfig(**FCGF), device="cpu")
    from apr_torch.training.predator import PredatorTrainer

    return PredatorTrainer(APRConfig(**PREDATOR), device="cpu")


def _raw(family: str, cfg):
    """The nine padded arrays of one pair (a batch of one for FCGF)."""
    d = _pair(family)
    arrays = []
    for key, cap in (("points0", cfg.point_capacity),
                     ("points1", cfg.point_capacity),
                     ("apc0", cfg.apc_capacity), ("apc1", cfg.apc_capacity)):
        arrays += list(pad_points(d[key], cap))
    p0, m0, p1, m1, a0, am0, a1, am1 = arrays
    raw = [p0, m0, p1, m1, a0, am0, a1, am1, d["t_gt"].astype(np.float32)]
    return [a[None] for a in raw] if family == "fcgf" else raw


def _tester(family: str, trainer):
    if family == "fcgf":
        from apr_torch.eval.tester import FeatureTester

        return FeatureTester(trainer.config, trainer, device="cpu")
    from apr_torch.eval.predator_tester import PredatorTester

    return PredatorTester(trainer.config, trainer, device="cpu")


def test_span_without_a_profiler_is_one_shared_null_context():
    a, b = profiling.span("train.forward"), profiling.span("ransac")
    assert a is b
    with a as got:
        assert got is None
    with profiling.span("build.maps"):
        x = torch.ones(4) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (x * 2).sum()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names and not [n for n in names
                          if n.startswith(profiling.SPAN_PREFIX)]


def test_span_under_a_profiler_records_and_never_waits(monkeypatch):
    def no_wait(*args, **kwargs):
        raise AssertionError("span waited for the card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_wait)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", no_wait)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", no_wait)

    def body():
        with profiling.span("encode"):
            with profiling.span("match"):
                torch.ones(3).sum()

    got = spans_of(body)
    assert [s.name for s in got] == ["encode", "match"]
    assert got[0].holds(got[1])


@pytest.mark.parametrize("family", FAMILIES)
def test_build_and_train_step_spans(family):
    trainer = _trainer(family)
    raw = _raw(family, trainer.config)
    gen = torch.Generator().manual_seed(0)
    trainer.train_step(trainer.build_batch(raw), gen)     # warm

    got = spans_of(lambda: trainer.train_step(trainer.build_batch(raw),
                                              gen))
    names = [s.name for s in got]
    assert names == BUILD + ["train.forward", "encode", "train.backward",
                             "train.update"]
    by = {s.name: s for s in got}
    order = BUILD + ["train.forward", "train.backward", "train.update"]
    for a, b in zip(order, order[1:]):
        assert by[a].end_ns <= by[b].start_ns, (a, b)
    assert by["train.forward"].holds(by["encode"])


def test_step_profilers_trace_holds_the_spans(tmp_path):
    """The training loop's ``StepProfiler`` (``profile_dir``) is the
    operator's view of the same spans: its Chrome trace names them."""
    import json

    from apr_torch.training.loop import StepProfiler

    trainer = _trainer("fcgf")
    raw = _raw("fcgf", trainer.config)
    cfg = APRConfig(**dict(FCGF, profile_dir=str(tmp_path), profile_start=0,
                           profile_steps=1))
    prof = StepProfiler(cfg, torch.device("cpu"))
    prof.before(0)
    trainer.train_step(trainer.build_batch(raw), torch.Generator())
    prof.after(1)
    trace = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {profiling.SPAN_PREFIX + n for n in BUILD + [
        "train.forward", "encode", "train.backward", "train.update"]} <= names


@pytest.mark.parametrize("family", FAMILIES)
def test_tester_step_spans(family):
    trainer = _trainer(family)
    tester = _tester(family, trainer)
    pair = _pair(family, seed=1)

    def register():
        gen = torch.Generator().manual_seed(0)
        return tester.step(tester._bucketed_batch(pair), gen)

    register()                                             # warm
    before = ransac.ransac_from_draws.hypotheses
    got = spans_of(register)
    assert [s.name for s in got] == BUILD + ["encode", "match", "ransac"]
    for a, b in zip(got, got[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)
    c = trainer.config
    assert ransac.ransac_from_draws.hypotheses - before == sum(
        ransac.stage_sizes(c.test_num_ransac_hypotheses))


def _matched(seed: int = 0, m: int = 300):
    """Correspondences of a rigid motion, a third of them outliers."""
    g = torch.Generator().manual_seed(seed)
    src = torch.rand((m, 3), generator=g) * 20.0
    angle = torch.tensor(0.3)
    c, s = torch.cos(angle), torch.sin(angle)
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    tgt = src @ rot.T + torch.tensor([1.0, -2.0, 0.5])
    tgt[: m // 3] = torch.rand((m // 3, 3), generator=g) * 20.0
    return src, tgt


@pytest.mark.parametrize("factor,min_inliers,rungs_run", [
    (0, 30, 0),              # no escalation: stage 1 alone
    (2, 10**9, 2),           # every rung runs
    (2, 0, 0),               # no rung runs
])
def test_hypotheses_counts_the_stages_that_ran(factor, min_inliers,
                                               rungs_run):
    src, tgt = _matched()
    sizes = ransac.stage_sizes(2048, 512, factor, 2)
    draws = ransac.draw_stages(torch.Generator().manual_seed(1),
                               torch.tensor(src.shape[0]), sizes)
    kw = dict(distance_threshold=0.3, hypothesis_chunk=512,
              escalation_min_inliers=min_inliers)
    want = sizes[0] + sum(sizes[1:1 + rungs_run])

    before = ransac.ransac_from_draws.hypotheses
    ransac.ransac_from_draws(src, tgt, None, draws, **kw)
    assert ransac.ransac_from_draws.hypotheses - before == want

    before = ransac.ransac_from_draws.hypotheses
    ransac.ransac_pose(torch.Generator().manual_seed(1), src, tgt,
                       num_hypotheses=2048, escalation_factor=factor,
                       escalation_rungs=2, **kw)
    assert ransac.ransac_from_draws.hypotheses - before == want
    if factor == 0:
        assert want == sum(sizes)


def test_hypotheses_count_is_exact_under_threads():
    n_threads, n_each = 16, 2000
    before = ransac.ransac_from_draws.hypotheses
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                ransac._count_hypotheses(3)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert ransac.ransac_from_draws.hypotheses - before == \
        3 * n_threads * n_each
    ransac.ransac_from_draws.hypotheses = before
