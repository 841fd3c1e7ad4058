"""The reading of the program's own spans (``harness/program.py``) on
hand-built windows, and the frozen reading of a window with and without
those spans."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from frozen import profiling
from harness import cells, program, tracing
from harness.program import Ev

ROOT = os.path.dirname(cells.BENCH_DIR)
MAIN, AUTOGRAD = 1, 2


def _launch(corr, t, start, end, thread=MAIN, via="runtime"):
    """A launch call at ``t`` and the activity it starts on the card: by
    the runtime call's correlation id, or only by the operator's link.
    Later activities take names that sort first."""
    name = f"kernel_{10**9 - start}"
    if via == "runtime":
        return [Ev("runtime", "cudaLaunchKernel", t, t + 1, thread, corr),
                Ev("device", name, start, end, 0, corr)]
    return [Ev("op", "aten::add", t, t + 2, thread, 900 + corr),
            Ev("device", name, start, end, 0, 5000 + corr, 900 + corr)]


def _train_unit(o):
    """One build and one step from time ``o``: every span, a kernel from
    the autograd thread, one through its operator only, a sync in the
    update, an unattributed kernel and the bench spans' own syncs."""
    ev = [Ev("bench", "build", o, o + 100, MAIN),
          Ev("bench", "step", o + 100, o + 400, MAIN),
          Ev("span", "build.voxelize", o + 2, o + 10, MAIN),
          Ev("span", "build.maps", o + 10, o + 50, MAIN),
          Ev("span", "build.corr", o + 50, o + 90, MAIN),
          Ev("span", "train.forward", o + 110, o + 200, MAIN),
          Ev("span", "encode", o + 120, o + 180, MAIN),
          Ev("span", "train.backward", o + 200, o + 300, MAIN),
          Ev("span", "train.update", o + 300, o + 390, MAIN),
          Ev("runtime", "cudaStreamSynchronize", o + 310, o + 350, MAIN,
             o + 7),
          Ev("runtime", "cudaDeviceSynchronize", o + 95, o + 99, MAIN,
             o + 8),
          Ev("runtime", "cudaDeviceSynchronize", o + 392, o + 398, MAIN,
             o + 9)]
    ev += _launch(o + 1, o + 20, o + 30, o + 40)                # maps
    ev += _launch(o + 2, o + 60, o + 62, o + 64)                # corr
    ev += _launch(o + 3, o + 130, o + 140, o + 160)             # encode
    ev += _launch(o + 4, o + 150, o + 160, o + 170, via="op")   # encode
    ev += _launch(o + 5, o + 185, o + 185, o + 195)             # forward
    ev += _launch(o + 6, o + 220, o + 230, o + 280,
                  thread=AUTOGRAD)                              # backward
    ev += _launch(o + 10, o + 320, o + 320, o + 330)            # update
    ev += _launch(o + 11, o + 105, o + 106, o + 108)            # none
    return ev


def test_attribution_on_a_hand_built_window():
    events = _train_unit(0) + _train_unit(1000)
    units = program.readings(events, "build")
    assert len(units) == 2
    for u in units:
        s = u["spans"]
        assert s["build.maps"] == dict(host_ms=40e-6, busy_ms=10e-6,
                                       launches=1, syncs=0,
                                       sync_wait_ms=0.0)
        assert s["encode"]["launches"] == 2
        assert s["encode"]["busy_ms"] == pytest.approx(30e-6)
        # the forward holds its nested encode
        assert s["train.forward"]["launches"] == 3
        assert s["train.forward"]["busy_ms"] == pytest.approx(40e-6)
        assert s["train.forward"]["host_ms"] == pytest.approx(90e-6)
        # launched from the autograd thread while the main thread waits
        assert s["train.backward"]["launches"] == 1
        assert s["train.backward"]["busy_ms"] == pytest.approx(50e-6)
        assert s["train.update"]["syncs"] == 1
        assert s["train.update"]["sync_wait_ms"] == pytest.approx(40e-6)
        assert s[program.UNATTRIBUTED]["launches"] == 1
        # the bench spans' own syncs are outside every program span
        assert u["syncs"] == 1 and u["sync_wait_ms"] == pytest.approx(40e-6)
        for stage, n in (("build", 2), ("step", 6)):
            st = u["stages"][stage]
            assert st["launches"] == st["device_launches"] == n
            assert st["busy_ms"] == pytest.approx(st["device_busy_ms"])
        assert u["stages"]["step"]["unattributed"] == 1
        assert u["stages"]["build"]["unattributed"] == 0
    vals = program.metric_values("train", dict(units=units, hypotheses=None))
    assert vals["fwd_busy_ms.train"] == pytest.approx(40e-6)
    assert vals["bwd_busy_ms.train"] == pytest.approx(50e-6)
    assert vals["update_busy_ms.train"] == pytest.approx(10e-6)
    assert vals["maps_busy_ms.train"] == pytest.approx(10e-6)
    assert vals["host_syncs.train"] == 1
    assert vals["sync_wait_ms.train"] == pytest.approx(40e-6)


def test_reg_metrics_and_a_program_without_spans():
    ev = []
    for k, o in enumerate((0, 1000)):
        ev += [Ev("bench", "build", o, o + 100, MAIN),
               Ev("bench", "step", o + 100, o + 900, MAIN),
               Ev("span", "encode", o + 110, o + 200, MAIN),
               Ev("span", "match", o + 200, o + 300, MAIN),
               Ev("span", "ransac", o + 300, o + 800, MAIN)]
        ev += _launch(o + 1, o + 150, o + 150, o + 170)
        for j in range(4):
            ev += _launch(o + 10 + j, o + 310 + j * 100, o + 320 + j * 100,
                          o + 370 + j * 100)
    units = program.readings(ev, "build")
    vals = program.metric_values("reg", dict(units=units, hypotheses=4000))
    assert vals["encode_launches.reg"] == 1
    assert vals["ransac_launches.reg"] == 4
    assert vals["encode_host_ms.reg"] == pytest.approx(90e-6)
    assert vals["ransac_host_ms.reg"] == pytest.approx(500e-6)
    assert vals["ransac_ns_per_hyp.reg"] == pytest.approx(200 / 2000)
    assert vals["host_syncs.reg"] == 0
    # the parent's program opens no span: nothing to read, and no raise
    bare = [e for e in ev if e.kind != "span"]
    units = program.readings(bare, "build")
    assert units[0]["spans"][program.UNATTRIBUTED]["launches"] == 5
    assert program.metric_values("reg", dict(units=units,
                                             hypotheses=None)) == {}
    assert program.metric_values("train", None) == {}


def _window(with_program_spans: bool) -> profiling.Window:
    """Two train units of kernels, bench spans and host operations; the
    program's spans, where present, are host events like any other."""
    kernels, spans, host = [], [], []
    for o in (0, 1000):
        spans += [profiling.Event("build", o, o + 100),
                  profiling.Event("step", o + 100, o + 400)]
        kernels += [profiling.Event("searchsorted_many_kernel", o + 30,
                                    o + 40),
                    profiling.Event("gemm", o + 140, o + 160),
                    profiling.Event("nn_min_kernel", o + 230, o + 280)]
        host += [profiling.Event("aten::mm", o + 130, o + 150)]
        if with_program_spans:
            host += [profiling.Event("apr::build.maps", o + 10, o + 50),
                     profiling.Event("apr::train.forward", o + 110, o + 200),
                     profiling.Event("apr::train.backward", o + 200,
                                     o + 300)]
    key = lambda e: e.start_ns          # noqa: E731
    return profiling.Window(sorted(kernels, key=key), spans,
                            sorted(host, key=key))


@pytest.mark.parametrize("kind", ["train", "reg"])
def test_existing_readers_read_the_same_with_program_spans(kind):
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    work = dict(k1_bytes=1e6, k2_pairs=1e9, k2_bytes=1e7, flops=1e12)
    got = {}
    for with_spans in (False, True):
        units, window_s, busy_s, breakdown = tracing.readings(
            _window(with_spans), ["build", "step"])
        run = tracing.TraceRun(kind, units, window_s, busy_s, work, 2,
                               breakdown, unit_wall_s=0.3, build_wall_s=0.05)
        got[with_spans] = {m["name"]: cells.metric_reader(m["name"])(run)
                           for m in spec["per_layer"]}
        got[with_spans]["device_ops"] = breakdown["device_ops"]
    assert got[True] == got[False]
    assert any(v is not None for v in got[True].values())


def test_frozen_reading_keeps_program_spans_among_host_operations():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(profiling.SPAN_PREFIX + "step"):
            with record_function(program.PROGRAM_PREFIX + "encode"):
                torch.ones(8).sum()
    win = profiling.read_events(prof)
    assert [s.name for s in win.spans] == ["step"]
    assert "apr::encode" in [h.name for h in win.host_ops]
    kinds = {e.name: e.kind for e in program.read_kineto(prof)}
    assert kinds["step"] == "bench" and kinds["encode"] == "span"
    assert kinds["aten::ones"] == "op"
