"""The traced window: a fixed number of steps or pairs under
``torch.profiler``, each stage a span of the benchmark's own, synchronised
at both ends, around the public call into its layer; and the unprofiled
host-clock timings that the shares of a peak divide by."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from frozen import profiling


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """``with spans("build"):`` records one span; no-op when off."""

    def __init__(self, device: torch.device, on: bool):
        self.device, self.on = device, on

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        sync(self.device)
        with torch.profiler.record_function(profiling.SPAN_PREFIX + name):
            yield
            sync(self.device)


@dataclass
class TraceRun:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""
    kind: str                              # "train" or "reg"
    units: List[Dict[str, Dict]]           # per step or pair: stage -> row
    window_s: float
    busy_s: float
    work: Dict[str, float]                 # per step or pair, reference's
    batch_size: int = 1
    breakdown: Dict = field(default_factory=dict)
    # host-clock seconds, unprofiled: a step or pair as the window runs
    # them (many timed together), and a batch build alone (builds run
    # back to back); None where the loop has none
    unit_wall_s: Optional[float] = None
    build_wall_s: Optional[float] = None

    def stage_mean(self, stage: str, key: str) -> float:
        vals = [u[stage][key] for u in self.units if stage in u]
        return sum(vals) / len(vals) if vals else float("nan")

    def unit_mean(self, key: str) -> float:
        """The mean over units of ``key`` summed over each unit's
        stages."""
        vals = [sum(r[key] for r in u.values()) for u in self.units]
        return sum(vals) / len(vals) if vals else float("nan")

    def kernel_s(self, stage: str, needle: str) -> List[float]:
        """Per unit, the device seconds of kernels whose name holds
        ``needle`` inside ``stage``; units with none left out."""
        out = []
        for u in self.units:
            if stage in u:
                s = sum(v for n, v in u[stage]["kernels"].items()
                        if needle in n)
                if s > 0:
                    out.append(s)
        return out


@contextlib.contextmanager
def profiled_window(device: torch.device):
    """Profile the block; yields a dict that holds the read window after
    it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box: Dict = {}
    sync(device)
    with profile(activities=acts) as prof:
        yield box
        sync(device)
    box["window"] = profiling.read_events(prof)


def readings(win: "profiling.Window", stages_per_unit: List[str]):
    """Per unit, stage -> span reading; the window's length and busy
    seconds; and the breakdown for the result line."""
    rows = profiling.span_readings(win)
    units, cur = [], {}
    for r in rows:
        if r["name"] == stages_per_unit[0] and cur:
            units.append(cur)
            cur = {}
        cur[r["name"]] = r
    if cur:
        units.append(cur)
    if not win.spans:
        return units, 0.0, 0.0, {}
    start, end = win.spans[0].start_ns, max(s.end_ns for s in win.spans)
    merged = profiling.busy_intervals(win.kernels)
    busy = profiling.busy_within(merged, start, end) / 1e9
    breakdown = dict(device_ops=profiling.top_kernels(
        [k for k in win.kernels if start <= k.start_ns < end]),
        idle_gaps=profiling.idle_gaps(win, start, end))
    return units, (end - start) / 1e9, busy, breakdown


def timed(device: torch.device, n: int, body) -> float:
    """Host seconds of one of ``n`` calls of ``body(i)`` run back to back,
    unprofiled, with the card synchronised at both ends only."""
    sync(device)
    t0 = time.perf_counter()
    for i in range(n):
        body(i)
    sync(device)
    return (time.perf_counter() - t0) / n
