# Frozen copy of the arithmetic of apr_torch/utils/profiling.py::profiled at
# commit bc3af59 (busy time and launches from the raw kineto events), with
# the benchmark's spans laid over it.
"""Reading a ``torch.profiler`` window: the card's kernels, the
benchmark's own spans (``record_function("bench::<stage>")`` ranges, each
synchronised at both ends) and the host's operations.

Busy time is the union of the device activities' intervals; a span's busy
time is the part of that union inside the span; launches are the device
activities that start inside it.  The raw kineto events are read, not
``prof.events()``, which builds the Python event tree and takes seconds
for a step of 10^4 launches.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

SPAN_PREFIX = "bench::"


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Window(NamedTuple):
    kernels: List[Event]      # device activities, by start
    spans: List[Event]        # the benchmark's spans, by start
    host_ops: List[Event]     # the host's other operations


def read_events(prof) -> Window:
    """The three kinds of event of a finished profile.  The optimizer's
    step and zero_grad also leave device-side user annotations: ranges,
    not kernels, left out of the kernels."""
    kernels, spans, host = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == cuda:
            if not getattr(e, "is_user_annotation", bool)():
                kernels.append(ev)
        elif e.name().startswith(SPAN_PREFIX):
            spans.append(ev._replace(name=e.name()[len(SPAN_PREFIX):]))
        else:
            host.append(ev)
    key = lambda ev: ev.start_ns     # noqa: E731
    return Window(sorted(kernels, key=key), sorted(spans, key=key),
                  sorted(host, key=key))


def busy_intervals(kernels: List[Event]) -> List[Tuple[int, int]]:
    """The union of the kernels' intervals, merged and in order."""
    out: List[List[int]] = []
    for k in kernels:
        if out and k.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], k.end_ns)
        else:
            out.append([k.start_ns, k.end_ns])
    return [(a, b) for a, b in out]


def busy_within(intervals, start_ns: int, end_ns: int) -> int:
    """Nanoseconds of ``intervals`` inside [start, end]."""
    return sum(max(0, min(b, end_ns) - max(a, start_ns))
               for a, b in intervals)


def span_readings(win: Window) -> List[Dict]:
    """Per span: its name, wall seconds, busy seconds, launches and kernel
    seconds by name."""
    merged = busy_intervals(win.kernels)
    rows = []
    for s in win.spans:
        inside = [k for k in win.kernels
                  if s.start_ns <= k.start_ns < s.end_ns]
        by_name: Dict[str, float] = {}
        for k in inside:
            by_name[k.name] = by_name.get(k.name, 0.0) + (
                k.end_ns - k.start_ns) / 1e9
        rows.append(dict(name=s.name, wall_s=(s.end_ns - s.start_ns) / 1e9,
                         busy_s=busy_within(merged, s.start_ns, s.end_ns)
                         / 1e9, launches=len(inside), kernels=by_name))
    return rows


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its template arguments past ``width``
    characters."""
    return name if len(name) <= width else name[:width - 3] + "..."


def top_kernels(kernels: List[Event], n: int = 10) -> List[List]:
    """The ``n`` kernels that took most device time, summed by name."""
    per_name: Dict[str, int] = {}
    for k in kernels:
        per_name[k.name] = per_name.get(k.name, 0) + k.end_ns - k.start_ns
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:n]
    return [[short(name), ns / 1e9] for name, ns in top]


def idle_gaps(win: Window, start_ns: int, end_ns: int, n: int = 10
              ) -> List[List]:
    """The ``n`` longest stretches of [start, end] with no kernel running,
    each named by the benchmark span and the innermost host operation
    under its midpoint (what the host was doing)."""
    merged = busy_intervals(win.kernels)
    gaps, t = [], start_ns
    for a, b in merged + [(end_ns, end_ns)]:
        if a > t:
            gaps.append((min(a, end_ns) - t, t, min(a, end_ns)))
        t = max(t, b)
    gaps = sorted(gaps, reverse=True)[:n]

    def under(events, mid):
        cover = [e for e in events if e.start_ns <= mid < e.end_ns]
        return min(cover, key=lambda e: e.end_ns - e.start_ns).name \
            if cover else "-"

    return [[f"{under(win.spans, (a + b) // 2)}/"
             f"{under(win.host_ops, (a + b) // 2)}", ns / 1e9]
            for ns, a, b in gaps]
