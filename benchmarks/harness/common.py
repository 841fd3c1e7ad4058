"""What both loops share: the device's memory readings, seeds derived
from the run's seed, and freeing the program before the reference runs."""

from __future__ import annotations

import gc
import statistics
import sys
from typing import List

import torch

from harness.inputs import rng


def derived_seed(seed: int, *keys: int) -> int:
    return int(rng(seed, 3, *keys).integers(0, 1 << 62))


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def memory_peak(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def print_setup(clock0: float, marks) -> None:
    """The set-up's parts on standard error: seconds from the process's
    start (imports), then between marks."""
    parts, last = [], clock0
    for name, t in marks:
        parts.append(f"{name} {t - last:.3f} s")
        last = t
    print("setup: " + ", ".join(parts), file=sys.stderr)


def print_pace(name: str, t_start: float, ends: List[float],
               slice_s: float = 10.0) -> None:
    """The window's pace on standard error: each unit's host seconds
    (p10, median, p90, max) and the units that ended in each ``slice_s``
    seconds of it."""
    if not ends:
        return
    secs = [b - a for a, b in zip([t_start] + ends[:-1], ends)]
    q = statistics.quantiles(secs, n=10) if len(secs) > 1 else secs * 9
    slices = [0] * (int((ends[-1] - t_start) // slice_s) + 1)
    for t in ends:
        slices[int((t - t_start) // slice_s)] += 1
    print(f"pace: {len(ends)} {name}, ms p10 {q[0] * 1e3:.2f} median "
          f"{statistics.median(secs) * 1e3:.2f} p90 {q[-1] * 1e3:.2f} "
          f"max {max(secs) * 1e3:.2f}; per {slice_s:g} s {slices}",
          file=sys.stderr)
