"""A cell of ``BENCHMARK.json`` and everything it names, found by name:
the configuration file, the traffic mix ``traffic/<mix>.json``, the loop
that the mix names ``loops/<loop>.py``, the limits of its comparison
``limits/<cell>.json`` and the readers of its per-layer metrics
``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration file's object
    mix: Dict             # the traffic mix's parameters
    limits: Dict          # comparison name -> limit
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: "
                         f"{', '.join(sorted(work))}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg["file"]))
    bench_dir = os.path.join(root, os.path.dirname(cfg["file"]), os.pardir)
    mix = _json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(bench_dir, "limits", name + ".json"))
    return Cell(name, w["chips"], config, mix, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _module(kind: str, name: str, bench_dir: str) -> ModuleType:
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from a
    traced run, or None where the run has nothing for it to read."""
    return _module("metrics", name, bench_dir).read


def loop_module(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``loops/<name>.py``, the loop that a traffic mix names: its
    ``run(cell, seed, seconds, trace, device, clock0, control)`` drives the
    window and the comparison, and its ``trace_run(result)`` gives the
    metric readers their ``TraceRun``."""
    return _module("loops", name, bench_dir)
