"""Timers for the card, shared by ``chip_smoke.py`` and the profilers under
``apr_torch/tools/profile_*.py``, so that both time alike.

- :func:`host_ms`: the host's time to enqueue one call.
- :func:`cuda_ms`: device time from CUDA events, with the card held by a
  sleep kernel while the host enqueues (a call shorter on the device than
  on the host is then timed at the device's pace).
- :func:`profiled`: one run under ``torch.profiler``: the card's busy ms,
  its kernel launches and the longest kernels.
- :func:`stage_split`: one step by stage (wall, busy, launches).
- :func:`time_stage`: the profilers' protocol: K chained iterations, each
  input re-keyed from the previous output, read three ways (device ms,
  wall ms, busy ms with launches).
- :func:`span`: the package's own named ranges (``apr::<name>``) at its
  step, build and tester boundaries, recorded only while a profiler
  collects.

Every function takes the device from its ``device`` argument (the current
CUDA device by default).  :func:`cuda_ms` and :func:`profiled` raise on
the CPU; :func:`time_stage` reads only the host's wall clock there and
reports the device numbers as not measured.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, NamedTuple, Optional

import torch

SM_HZ = 1.98e9     # H100 SXM boost clock: the cycles of a sleep kernel

SPAN_PREFIX = "apr::"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("train.forward"):`` -- a ``record_function`` range named
    ``apr::<name>`` while a profiler collects (``torch.profiler`` or
    ``StepProfiler``), else one shared null context.  It never waits for
    the card: the range is a host event on the clock of the device trace,
    so the kernels it launches are found through their launch calls.  The
    flag read costs ~0.1-0.3 us on the host; an unguarded
    ``record_function`` ~15 us even with no profiler."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def _card(device, what: str) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError(f"{what} times the card; got device {dev}")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, reps=20, rounds=5, device=None):
    """Host time to enqueue one call of ``fn``: the least over ``rounds``
    of the mean over ``reps`` calls (no synchronisation inside a round).
    The least, because the host's cores are shared and other work only
    adds to a round."""
    dev = torch.device("cuda" if device is None else device)
    fn()
    best = float("inf")
    for _ in range(rounds):
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / reps)
    _sync(dev)
    return best


def cuda_ms(fn, reps, warmup=True, device=None):
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up
    (skipped for a call that takes seconds and needs none).  A sleep kernel
    holds the card while the host enqueues the launches, so calls whose
    device time is shorter than their host time are timed back to back on
    the device and not at the host's pace.  ``fn`` must not wait for the
    card: the wait would be charged the sleep."""
    dev = _card(device, "cuda_ms")
    with torch.cuda.device(dev):
        if warmup:
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if warmup:
            t0 = time.perf_counter()
            fn()
            enqueue_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda._sleep(int(min(1.5 * reps * enqueue_s, 2.0) * SM_HZ))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, x, inference=True, device=None):
    """Run ``fn(x)`` under torch.profiler; returns (result, card busy ms,
    kernel count, the three longest kernels by total time).  Busy time is
    the sum of the device activities' durations (one stream: they do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card(device, "profiled")
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode(inference):
            out = fn(x)
        torch.cuda.synchronize(dev)
    # the raw kineto events: prof.events() builds the Python event tree,
    # ~50x slower, seconds for a step of 10^4 launches.  The optimizer's
    # step and zero_grad also leave device-side user annotations: ranges,
    # not kernels
    dev_events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", bool)()]
    per_name = {}
    for e in dev_events:
        per_name[e.name()] = per_name.get(e.name(), 0.0) + e.duration_ns()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
    busy = sum(per_name.values()) / 1e6
    return out, busy, len(dev_events), "; ".join(
        f"{n[:48]} {ns / 1e6:.2f} ms" for n, ns in top)


def stage_split(stages, inference=False, unit="step", device=None):
    """One ``unit`` (a step, a pair) by stage, each stage synchronised at
    its boundaries: host-clock wall (second repetition), then a profiled
    repetition for the card's busy time, its kernel launches and the top
    kernels.  Each stage takes the previous one's result.  Returns (the
    last result, {stage: (wall ms, busy ms, launches)})."""
    dev = _card(device, "stage_split")
    wall, readings = {}, {}
    for rep in range(3):
        x = None
        for name, fn in stages.items():
            if rep < 2:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                with torch.inference_mode(inference):
                    x = fn(x)
                torch.cuda.synchronize(dev)
                wall[name] = (time.perf_counter() - t0) * 1e3
            else:
                x, busy, n_kern, top = profiled(fn, x, inference, dev)
                readings[name] = (wall[name], busy, n_kern)
                print(f"  {name:9s} wall {wall[name]:8.2f} ms  card busy "
                      f"{busy:8.2f} ms (idle share "
                      f"{1 - busy / wall[name]:.2f})  kernels {n_kern}  "
                      f"top: {top}")
    print(f"  {unit} total {sum(wall.values()):.2f} ms (wall, synchronised "
          f"per stage; busy and launches from a separate profiled run)")
    return x, readings


# --- the profilers' protocol --------------------------------------------

def leaves(tree):
    """The tensors of a nested tuple / list / NamedTuple / dict, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in leaves(x)]
    return []


def checksum(tree) -> torch.Tensor:
    """A float32 scalar that reads every tensor of ``tree``: what a chained
    iteration folds into the next input, so no output goes unread."""
    parts = [t.float().sum() for t in leaves(tree) if t.numel()]
    if not parts:
        raise ValueError("a stage returned no tensor")
    return torch.nan_to_num(torch.stack(parts).sum(), nan=0.0, posinf=0.0,
                            neginf=0.0)


def jitter(base: torch.Tensor, out, i: int) -> torch.Tensor:
    """The input of chained iteration ``i``: ``base`` plus 1e-4 of noise
    drawn from seed ``i``, plus 1e-30 of the previous output's checksum (a
    data dependency that changes no value above the noise)."""
    g = torch.Generator(base.device).manual_seed(i)
    noise = torch.randn(base.shape, generator=g, device=base.device,
                        dtype=base.dtype)
    return base + noise * 1e-4 + checksum(out).to(base.dtype) * 1e-30


class StageRow(NamedTuple):
    """One stage's readings, per iteration; None where not measured."""

    label: str
    device_ms: Optional[float]   # CUDA events, the card held while enqueued
    wall_ms: float               # host clock, synchronised at the ends
    busy_ms: Optional[float]     # one profiled iteration: kernels' sum
    launches: Optional[int]      # kernels of that iteration
    k1: int                      # kernel K1 launches of that iteration
    k2: int                      # kernel K2 launches of that iteration
    k3: int                      # kernel K3 launches of that iteration
    k3_plain: int                # card searches K3's shape test left plain
    top: str


def _kernel_counts():
    from apr_torch.ops.distance import nn_min
    from apr_torch.ops.neighbors import radius_select
    from apr_torch.ops.searchsorted import searchsorted_left

    return (searchsorted_left.launches, nn_min.launches,
            radius_select.launches, radius_select.plain_cuda)


def _reports_sync(fn):
    """(fn(), whether torch reported a wait for the card inside it): a
    stage found to sync is kept out of :func:`cuda_ms`'s sleep hold."""
    import warnings

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return out, any("synchroniz" in str(w.message) for w in seen)


def time_stage(label: str, fn: Callable, x0, rekey: Callable, k: int,
               device, syncs: bool = False, inference: bool = True,
               unit: str = "iteration"):
    """The profilers' protocol for one stage ``fn``: ``k`` chained
    iterations, the first on ``x0``, each later one on ``rekey(x0, out,
    i)`` (an input made from the previous output, so no iteration can be
    skipped or reused).  Read three ways, each per iteration: the device
    time of the ``k`` iterations by :func:`cuda_ms`; the wall time by the
    host clock, synchronised at both ends; and the busy ms, kernel
    launches and top kernels of one :func:`profiled` iteration (with the
    K1 / K2 / K3 launches of that iteration, and the card's searches that
    stayed on K3's plain chain).  A stage that ``syncs`` with the
    host inside (declared, or reported by torch's sync debug mode during
    the warm-up) is never timed under :func:`cuda_ms`'s sleep hold: it
    gets wall and busy only.  A chain of more launches than CUDA's queue
    holds (~1000) is enqueued at the host's pace, so its device ms reads
    the host: read busy ms there.  On the CPU only the wall is read.
    Prints one line; returns (StageRow, the last output)."""
    dev = torch.device(device)

    def chain():
        out = fn(x0)
        for i in range(1, k):
            out = fn(rekey(x0, out, i))
        return out

    with torch.inference_mode(inference):
        if dev.type == "cuda" and not syncs:
            out, syncs = _reports_sync(chain)          # warm-up
        else:
            out = chain()                              # warm-up
        dev_ms = None
        if dev.type == "cuda" and not syncs:
            dev_ms = cuda_ms(chain, 1, device=dev) / k
        _sync(dev)
        t0 = time.perf_counter()
        out = chain()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3 / k
    busy = n_kern = None
    top = "not measured (CPU)"
    c0 = _kernel_counts()
    if dev.type == "cuda":
        _, busy, n_kern, top = profiled(
            lambda x: fn(rekey(x0, x, k)), out, inference, dev)
    else:
        with torch.inference_mode(inference):
            fn(rekey(x0, out, k))
    c1 = _kernel_counts()
    row = StageRow(label, dev_ms, wall, busy, n_kern,
                   *(a - b for a, b in zip(c1, c0)), top)
    print(_format_row(row, unit), flush=True)
    return row, out


def _format_row(row: StageRow, unit: str) -> str:
    def ms(v):
        return "not measured" if v is None else f"{v:9.3f} ms"

    dev = ("wall + busy only (syncs with the host)"
           if row.device_ms is None and row.busy_ms is not None
           else ms(row.device_ms))
    launches = "not measured" if row.launches is None else row.launches
    return (f"{row.label:<44} device {dev}  wall {ms(row.wall_ms)}  busy "
            f"{ms(row.busy_ms)}  launches {launches}  K1 {row.k1}  K2 "
            f"{row.k2}  K3 {row.k3} (plain on the card {row.k3_plain})  per "
            f"{unit}  top: {row.top}")


def difference(label: str, a: StageRow, b: StageRow, unit: str) -> str:
    """The line for what stage ``a`` adds to stage ``b``: busy ms where
    both were profiled (the card's own work: device ms of a stage of more
    launches than CUDA's queue holds, ~1000, reads the host's pace), and
    wall ms."""
    busy = ("busy not measured" if a.busy_ms is None or b.busy_ms is None
            else f"busy {a.busy_ms - b.busy_ms:9.3f} ms")
    return (f"{label:<44} {busy}  wall {a.wall_ms - b.wall_ms:9.3f} ms  per "
            f"{unit} (a difference of two stages)")


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    CPU named as such (no device metric)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "device cpu (wall clock only: no device metric)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    return f"device {torch.cuda.get_device_name(dev)} ({smi or 'no nvidia-smi reading'})"
