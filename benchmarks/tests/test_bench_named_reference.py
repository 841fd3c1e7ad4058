"""A configuration names its frozen reference (the top-level key
``"reference"`` of its file, ``harness/sides.py::reference_of``): both
loops take the reference ``Side``, the control's ``precision`` and the
``tally`` behind the shares of a peak from that one package.  The
per-layer metrics read the program's ``apr::`` spans through
``TraceRun.span_mean``, as ``program.metric_values`` reads them."""

import json
import os
import shutil
import time

import pytest
import torch

import stub_reference
import tiny
from harness import cells, program, sides
from harness.report import run_cell
from harness.tracing import TraceRun
from reference.aprref import precision, tally

ROOT = os.path.dirname(cells.BENCH_DIR)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CPU = torch.device("cpu")
# the per-layer metrics that read the program's spans and counter
SPAN_METRICS = {
    "fwd_busy_ms.train", "bwd_busy_ms.train", "update_busy_ms.train",
    "maps_busy_ms.train", "sync_wait_ms.train", "host_syncs.train",
    "encode_launches.reg", "ransac_launches.reg", "encode_host_ms.reg",
    "ransac_host_ms.reg", "sync_wait_ms.reg", "host_syncs.reg",
    "ransac_ns_per_hyp.reg"}
SPAN_KEYS = ("host_ms", "busy_ms", "launches", "syncs", "sync_wait_ms")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_a_configuration_without_a_reference_gets_aprref(name):
    cell = cells.load_cell(name)
    assert "reference" not in cell.config
    cfg = {c["name"]: c for c in SPEC["configs"]}[
        {w["name"]: w for w in SPEC["workloads"]}[name]["config"]]
    assert cell.config_file == cfg["file"]
    assert sides.reference_of(cell) == (sides.REFERENCE, precision, tally)


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("name", ["fcgf-apr.train", "fcgf-apr.reg"])
def test_a_named_reference_gives_side_precision_and_tally(name, control):
    cell = tiny.cell(name)
    cell.config["reference"] = "stub_reference"
    del stub_reference.USED[:]
    torch.manual_seed(0)
    out = run_cell(cell, tiny.SEED, 1.0, False, CPU, time.perf_counter(),
                   control=control)
    used = stub_reference.USED
    # the reference's side; under the control, the control's side too
    assert used.count("side") == 1 + control
    assert "tally" in used
    assert ("precision" in used) == control
    assert out["correct"] is not control, out["checks"]


def _config_naming(tmp_path, pkg: str) -> str:
    """A copy of the benchmark with one more configuration, ``fcgf-x``
    (fcgf-apr's file with ``"reference": pkg``), and its two cells."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(cells.BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests", "reference"))
    cfg = json.load(open(bench / "configs" / "fcgf-apr.json"))
    cfg.update(name="fcgf-x", reference=pkg)
    (bench / "configs" / "fcgf-x.json").write_text(json.dumps(cfg))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(name="fcgf-x", source="x",
                                file="benchmarks/configs/fcgf-x.json",
                                reduced=[], why="test"))
    for mix in ("train", "reg"):
        spec["workloads"].append(dict(name="fcgf-x." + mix, config="fcgf-x",
                                      traffic=mix, chips=1, why="test"))
        shutil.copy(bench / "limits" / f"fcgf-apr.{mix}.json",
                    bench / "limits" / f"fcgf-x.{mix}.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)


@pytest.mark.parametrize("pkg", ["reference.no_such_package",
                                 "stub_reference.no_such_module",
                                 "apr_torch", 7])
@pytest.mark.parametrize("mix", ["train", "reg"])
def test_a_reference_that_does_not_import_stops_before_setup(
        tmp_path, monkeypatch, mix, pkg):
    cell = cells.load_cell("fcgf-x." + mix, root=_config_naming(tmp_path,
                                                                pkg))
    loop = cells.loop_module(cell.mix["loop"])

    def set_up(*args, **kw):
        raise AssertionError("set-up began")

    monkeypatch.setattr(loop, "Side", set_up)
    monkeypatch.setattr(loop, "make_pool", set_up)
    with pytest.raises(SystemExit) as e:
        loop.run(cell, tiny.SEED, 1.0, False, CPU, time.perf_counter())
    assert "benchmarks/configs/fcgf-x.json" in str(e.value)
    assert repr(pkg) in str(e.value)


@pytest.fixture(scope="module", params=["fcgf-apr.train", "fcgf-apr.reg"])
def traced(request):
    """A tiny traced run of a cell: its result line and its TraceRun."""
    runs = []
    torch.manual_seed(0)
    out = run_cell(tiny.cell(request.param), tiny.SEED, 1.0, True, CPU,
                   time.perf_counter(), keep=runs)
    return request.param, out, runs[0]


def test_span_mean_reads_what_metric_values_reads(traced):
    name, out, run = traced
    units = run.program["units"]
    spans = {n for u in units for n in u["spans"]}
    assert {"build.maps", "encode"} <= spans
    for n in spans:
        for key in SPAN_KEYS:
            assert run.span_mean(n, key) == program.span_mean(units, n, key)
    want = program.metric_values(run.kind, run.program)
    for m in SPEC["per_layer"]:
        if m["name"] not in SPAN_METRICS:
            continue
        got = cells.metric_reader(m["name"])(run)
        if name in m["workloads"]:
            assert got is not None and got == want[m["name"]], m["name"]
            assert out["metrics"][m["name"]]["value"] == got
        else:
            assert got is None and m["name"] not in out["metrics"]
    assert {m["name"] for m in SPEC["per_layer"]} >= SPAN_METRICS


def test_a_span_the_program_never_opens_reads_none(traced, tmp_path):
    _, _, run = traced
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "never_ms.py").write_text(
        "def read(run):\n"
        "    return run.span_mean('never.opened', 'busy_ms')\n")
    assert cells.metric_reader("never_ms", str(tmp_path))(run) is None
    bare = TraceRun(run.kind, run.units, run.window_s, run.busy_s, run.work)
    assert bare.span_mean("encode", "busy_ms") is None
    for m in SPAN_METRICS:
        assert cells.metric_reader(m)(bare) is None
