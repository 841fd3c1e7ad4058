"""What both loops share: the device's memory readings, seeds derived
from the run's seed, and freeing the program before the reference runs."""

from __future__ import annotations

import gc
import sys

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
