"""A cell's run and its result line: the loop its traffic mix names
(``loops/<loop>.py``, found by name), the end-to-end or per-layer
metrics, the device and the comparison."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import torch

from harness import checks
from harness.cells import Cell, loop_module, metric_reader

GIB = float(1 << 30)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, clock0: float, control: bool = False,
             keep: Optional[List] = None) -> Dict:
    """The result line of one run; with ``trace``, where ``keep`` is a
    list, the ``TraceRun`` that the metrics were read from is appended to
    it."""
    loop = loop_module(cell.mix["loop"])
    res = loop.run(cell, seed, seconds, trace, device, clock0, control)
    rows = checks.verdict(res["values"], cell.limits)
    metrics: Dict[str, Dict] = {}
    out = dict(correct=checks.passed(rows),
               attempted=res["attempted"], failed=res["failed"],
               metrics=metrics)
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=cell.chips, memory_peak_bytes=res["memory_peak_bytes"])
    if trace:
        run = loop.trace_run(res)
        if keep is not None:
            keep.append(run)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        dev.update(busy_s=run.busy_s, window_s=run.window_s)
        for stage in run.units[0] if run.units else ():
            print(f"stage {stage}: wall "
                  f"{run.stage_mean(stage, 'wall_s') * 1e3:.3f} ms, busy "
                  f"{run.stage_mean(stage, 'busy_s') * 1e3:.3f} ms, "
                  f"launches {run.stage_mean(stage, 'launches'):.1f}",
                  file=sys.stderr)
    elif not control:
        res["peak_mem_gib"] = res["peak_window"] / GIB
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=res[m["name"]], unit=m["unit"])
    out["device"] = dev
    if trace:
        out["breakdown"] = run.breakdown
    out["checks"] = rows
    return out
