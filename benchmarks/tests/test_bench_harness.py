"""The harness finds what a later change adds as new files, prints the
contract's result line, and refuses a run that loaded JAX."""

import json
import os
import shutil
import sys
import types

import pytest

import tiny
from harness import cells, guard

ROOT = os.path.dirname(cells.BENCH_DIR)


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "benchmarks"
    shutil.copytree(cells.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench / "configs" / "fcgf-apr.json"))
    cfg["name"] = "dummy-net"
    (bench / "configs" / "dummy-net.json").write_text(json.dumps(cfg))
    mix = json.load(open(bench / "traffic" / "train.json"))
    (bench / "limits" / "dummy-net.bursty.json").write_text(
        json.dumps({"loss_gap": 0.5}))
    (bench / "traffic" / "bursty.json").write_text(json.dumps(
        dict(mix, pool_batches=2, loop="bursts")))
    (bench / "loops" / "bursts.py").write_text(
        "def run(*args):\n    return 'ran'\n")
    (bench / "metrics" / "dummy_ms.py").write_text(
        "def read(run):\n    return 42.0\n")
    spec["configs"].append(dict(name="dummy-net", source="x",
                                file="benchmarks/configs/dummy-net.json",
                                reduced=[], why="test"))
    spec["workloads"].append(dict(name="dummy-net.bursty",
                                  config="dummy-net", traffic="bursty",
                                  chips=1, why="test"))
    for m in spec["end_to_end"]:
        if m["name"] == "train_pairs_per_s":
            m["workloads"].append("dummy-net.bursty")
    spec["per_layer"].append(dict(
        name="dummy_ms", unit="ms", better="lower", source="program_span",
        layer="batch build", moves="train_pairs_per_s",
        workloads=["dummy-net.bursty"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cells.load_cell("dummy-net.bursty", root=str(tmp_path))
    assert c.mix["pool_batches"] == 2 and c.limits == {"loss_gap": 0.5}
    assert [m["name"] for m in c.per_layer] == ["dummy_ms"]
    assert "train_pairs_per_s" in [m["name"] for m in c.end_to_end]
    assert cells.metric_reader("dummy_ms", str(bench))(None) == 42.0
    assert cells.loop_module(c.mix["loop"], str(bench)).run(c) == "ran"


def test_every_metric_has_a_reader_and_every_cell_its_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in spec["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
    for w in spec["workloads"]:
        c = cells.load_cell(w["name"])
        loop = cells.loop_module(c.mix["loop"])
        assert c.limits and callable(loop.run) and callable(loop.trace_run)


@pytest.mark.parametrize("name,trace", [("fcgf-apr.train", False),
                                        ("fcgf-apr.reg", True)])
def test_result_line_keys(name, trace):
    out = tiny.run(name, trace=trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[:5] == want
    assert list(out)[-1] == "checks"
    assert set(out) - set(want) - {"checks"} <= ({"breakdown"} if trace
                                                 else set())
    assert out["correct"] is True
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])


@pytest.mark.parametrize("planted,found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("flax.linen", ["flax"]),
    ("optax", ["optax"]), ("apr_tpu.ops", ["apr_tpu"]), ("jaxlib", ["jaxlib"]),
    ("jaxtyping", []), ("apr_torch.ops", [])])
def test_guard_compares_whole_top_level_names(planted, found):
    assert guard.forbidden_modules([planted, "torch", "numpy"]) == found


def test_guard_trips_on_a_planted_import(monkeypatch, capsys):
    import run as bench_run
    from harness import report

    fake = types.ModuleType("jax")
    monkeypatch.setitem(sys.modules, "jax", fake)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr(report, "run_cell",
                        lambda *a, **k: dict(checks=[]))
    rc = bench_run.main(["--workload", "fcgf-apr.train", "--seed", "1",
                         "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "jax" in captured.err


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    import run as bench_run

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = bench_run.main(["--workload", "fcgf-apr.train", "--seed", "1",
                         "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    import subprocess

    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "run.py"),
         "--workload", "fcgf-apr.reg", "--seed", str(2**31 + 99),
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
        cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]


def test_reference_and_harness_import_neither_the_program_nor_jax():
    """The reference imports nothing of apr_torch; nothing under
    benchmarks/ imports JAX or the JAX package (top-level names whole)."""
    import ast

    for dirpath, _, files in os.walk(cells.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module:
                    tops.add(node.module.split(".")[0])
            assert not tops & set(guard.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "apr_torch" not in tops, path
