"""The program's own spans in a traced window: the ``record_function``
ranges ``apr::<name>`` that ``apr_torch/utils/profiling.py::span`` opens
at the port's step, build and tester boundaries, read from the finished
profile's kineto events beside the benchmark's ``bench::`` spans.

Each device activity (kernel, copy, set) is attributed through the host
call that launched it: the CUDA runtime call with the activity's own
correlation id, else the operator whose correlation id the activity links
to, else the activity's own start.  It goes to the innermost ``apr::``
span, on any thread, that holds that launch time: the backward's kernels
are launched from autograd's worker thread while the main thread sits in
``train.backward``.  An activity launched inside a ``bench::`` span and
outside every ``apr::`` span goes to the ``unattributed`` row.

Per unit (a step or a pair: the ``bench::`` spans from one ``build`` to
the next) and per span name, the row holds the span's host ms (its
duration), busy ms (the union of the intervals of the activities launched
inside it, nested spans included), launches, host syncs and sync-wait ms
(the calls that block the host until the card catches up, inside the
span, and the sum of their durations).  The ``bench::`` spans' own syncs
lie outside every ``apr::`` span and are not counted.

:func:`profiled_window` is the traced window of ``harness/tracing.py``
that also keeps this reading, and the RANSAC hypotheses the program
counted in it (``ransac_from_draws.hypotheses`` of ``apr_torch``, read
where the program has that counter).  :func:`metric_values` gives the
per-layer metrics named after what they read.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from frozen import profiling

PROGRAM_PREFIX = "apr::"
UNATTRIBUTED = "unattributed"
# runtime calls that block the host until the card has caught up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


class Ev(NamedTuple):
    """One kineto event: ``kind`` is ``bench`` or ``span`` (the two
    prefixes, stripped from ``name``), ``device`` (an activity on the
    card), ``runtime`` (a CUDA runtime call) or ``op`` (any other host
    event)."""
    kind: str
    name: str
    start_ns: int
    end_ns: int
    thread: int = 0
    corr: int = 0
    linked: int = 0


def _kind(e) -> str:
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "" if getattr(e, "is_user_annotation", bool)() else "device"
    if name.startswith(profiling.SPAN_PREFIX):
        return "bench"
    if name.startswith(PROGRAM_PREFIX):
        return "span"
    # the CUDA runtime's calls by name: ``activity_type`` is missing from
    # some torch releases' kineto events (2.11)
    return "runtime" if name.startswith("cuda") else "op"


def read_kineto(prof) -> List[Ev]:
    """The events of a finished profile that the reading needs."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if not kind:
            continue
        name = e.name()
        if kind == "bench":
            name = name[len(profiling.SPAN_PREFIX):]
        elif kind == "span":
            name = name[len(PROGRAM_PREFIX):]
        start = e.start_ns()
        out.append(Ev(kind, name, start, start + e.duration_ns(),
                      e.start_thread_id(), e.correlation_id(),
                      e.linked_correlation_id()))
    return out


class _Cover:
    """Which of a set of intervals holds a time: the innermost (the
    shortest holding it), found by bisection over the elementary pieces
    between the intervals' ends."""

    def __init__(self, intervals: List[Tuple[int, int]]):
        cuts = sorted({t for iv in intervals for t in iv})
        self.cuts = cuts
        self.owner: List[Optional[int]] = []
        for a, b in zip(cuts, cuts[1:]):
            holding = [i for i, (s, e) in enumerate(intervals)
                       if s <= a and b <= e]
            self.owner.append(min(holding, key=lambda i: intervals[i][1]
                                  - intervals[i][0]) if holding else None)

    def __call__(self, t: int) -> Optional[int]:
        j = bisect.bisect_right(self.cuts, t) - 1
        return self.owner[j] if 0 <= j < len(self.owner) else None


def _parents(spans: List[Ev]) -> List[Optional[int]]:
    """Each span's parent: the shortest other span that holds it."""
    out = []
    for i, s in enumerate(spans):
        holding = [j for j, o in enumerate(spans) if j != i
                   and o.start_ns <= s.start_ns and s.end_ns <= o.end_ns
                   and (o.end_ns - o.start_ns, -o.start_ns)
                   > (s.end_ns - s.start_ns, -s.start_ns)]
        out.append(min(holding, key=lambda j: spans[j].end_ns
                       - spans[j].start_ns) if holding else None)
    return out


def _busy_ms(acts: List[Ev]) -> float:
    merged = profiling.busy_intervals(
        sorted((profiling.Event(a.name, a.start_ns, a.end_ns) for a in acts),
               key=lambda a: a.start_ns))
    return sum(b - a for a, b in merged) / 1e6


def _row(acts: List[Ev], host_ms: float, syncs: List[Ev]) -> Dict:
    return dict(host_ms=host_ms, busy_ms=_busy_ms(acts),
                launches=len(acts), syncs=len(syncs),
                sync_wait_ms=sum(s.end_ns - s.start_ns for s in syncs) / 1e6)


def readings(events: List[Ev], first_stage: str) -> List[Dict]:
    """Per unit: ``spans`` (span name -> row, nested spans included, and
    the ``unattributed`` row), ``stages`` (``bench::`` stage -> the
    launches and busy ms of the activities launched inside it, those of
    them outside every ``apr::`` span, the activities that start on the
    card inside it, as the frozen reading counts them, and ``outside``: a
    few launched inside it that start on the card elsewhere, each with its
    start, end and launch in ns from the stage's end), and the unit's
    ``syncs`` and ``sync_wait_ms`` inside ``apr::`` spans."""
    bench = sorted((e for e in events if e.kind == "bench"),
                   key=lambda e: e.start_ns)
    spans = sorted((e for e in events if e.kind == "span"),
                   key=lambda e: e.start_ns)
    runtime = {e.corr: e for e in events if e.kind == "runtime" and e.corr}
    ops = {e.corr: e for e in events if e.kind == "op" and e.corr}
    unit_of, k = [], -1
    for b in bench:
        if b.name == first_stage or k < 0:
            k += 1
        unit_of.append(k)
    in_bench = _Cover([(b.start_ns, b.end_ns) for b in bench])
    in_span = _Cover([(s.start_ns, s.end_ns) for s in spans])
    parents = _parents(spans)

    def chain(i: Optional[int]) -> List[int]:
        out = []
        while i is not None:
            out.append(i)
            i = parents[i]
        return out

    units = [dict(acts={}, syncs={}, stage_acts={}, stage_un={},
                  stage_out={}, device_acts={}) for _ in range(k + 1)]

    def file(where, key, ev):
        where.setdefault(key, []).append(ev)

    for e in events:
        if e.kind == "device":
            launch = runtime.get(e.corr) or ops.get(e.linked)
            t = launch.start_ns if launch is not None else e.start_ns
            b = in_bench(e.start_ns)
            if b is not None:
                file(units[unit_of[b]]["device_acts"], bench[b].name, e)
        elif e.kind == "runtime" and e.name in SYNC_CALLS:
            t = e.start_ns
        else:
            continue
        b = in_bench(t)
        if b is None:
            continue
        u = units[unit_of[b]]
        inner = chain(in_span(t))
        if e.kind == "device":
            file(u["stage_acts"], bench[b].name, e)
            if not inner:
                file(u["stage_un"], bench[b].name, e)
            if in_bench(e.start_ns) != b:
                file(u["stage_out"], bench[b].name,
                     (e.name[:60], e.start_ns - bench[b].end_ns,
                      e.end_ns - bench[b].end_ns, t - bench[b].end_ns))
            for i in inner or [None]:
                file(u["acts"], i, e)
        else:
            for i in inner:
                file(u["syncs"], i, e)
            if inner:
                file(u["syncs"], "all", e)

    out = []
    for n, u in enumerate(units):
        lo = min(b.start_ns for b, m in zip(bench, unit_of) if m == n)
        hi = max(b.end_ns for b, m in zip(bench, unit_of) if m == n)
        mine = [i for i, s in enumerate(spans)
                if lo <= s.start_ns and s.end_ns <= hi]
        rows: Dict[str, Dict] = {}
        for name in dict.fromkeys(spans[i].name for i in mine):
            ids = [i for i in mine if spans[i].name == name]
            # an instance inside another of its name is counted once
            outer = [i for i in ids if not any(
                spans[j].name == name for j in chain(parents[i])[1:])]
            acts = {id(a): a for i in ids for a in u["acts"].get(i, [])}
            syncs = {id(s): s for i in ids for s in u["syncs"].get(i, [])}
            rows[name] = _row(list(acts.values()), sum(
                spans[i].end_ns - spans[i].start_ns for i in outer) / 1e6,
                list(syncs.values()))
        rows[UNATTRIBUTED] = _row(u["acts"].get(None, []), 0.0, [])
        stages = {}
        for b, m in zip(bench, unit_of):
            if m != n:
                continue
            acts = u["stage_acts"].get(b.name, [])
            dev = u["device_acts"].get(b.name, [])
            un = u["stage_un"].get(b.name, [])
            stages[b.name] = dict(
                launches=len(acts), busy_ms=_busy_ms(acts),
                unattributed=len(un), unattributed_busy_ms=_busy_ms(un),
                device_launches=len(dev), device_busy_ms=_busy_ms(dev),
                outside=u["stage_out"].get(b.name, [])[:8])
        syncs = u["syncs"].get("all", [])
        out.append(dict(spans=rows, stages=stages, syncs=len(syncs),
                        sync_wait_ms=sum(s.end_ns - s.start_ns
                                         for s in syncs) / 1e6))
    return out


def links(events: List[Ev]) -> Dict:
    """How the device activities reach their launch (by the runtime
    call's correlation id, by the operator's link, or neither) and the
    sync calls by name: what the attribution rests on."""
    runtime = {e.corr for e in events if e.kind == "runtime" and e.corr}
    ops = {e.corr for e in events if e.kind == "op" and e.corr}
    how: Dict[str, int] = {}
    syncs: Dict[str, int] = {}
    for e in events:
        if e.kind == "device":
            k = ("runtime" if e.corr in runtime else
                 "op" if e.linked in ops else "unlinked")
            how[k] = how.get(k, 0) + 1
        elif e.kind == "runtime" and e.name in SYNC_CALLS:
            syncs[e.name] = syncs.get(e.name, 0) + 1
    return dict(linked=how, syncs=syncs)


def hypotheses() -> Optional[int]:
    """RANSAC hypotheses the program has scored so far, or None where it
    has no such counter."""
    try:
        ransac = importlib.import_module("apr_torch.registration.ransac")
    except ImportError:
        return None
    return getattr(ransac.ransac_from_draws, "hypotheses", None)


@contextlib.contextmanager
def profiled_window(device: torch.device, first_stage: str = "build"):
    """``harness/tracing.py::profiled_window`` (the same profile, synced
    alike), which also leaves in the box ``program``: the window's
    :func:`readings`, its :func:`links` and the hypotheses scored inside
    it (None where the program counts none)."""
    from harness import tracing
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    box: Dict = {}
    tracing.sync(device)
    h0 = hypotheses()
    with profile(activities=acts) as prof:
        yield box
        tracing.sync(device)
    h1 = hypotheses()
    box["window"] = profiling.read_events(prof)
    events = read_kineto(prof)
    box["program"] = dict(
        units=readings(events, first_stage), links=links(events),
        hypotheses=None if h0 is None or h1 is None else h1 - h0)


def span_mean(units: List[Dict], name: str, key: str) -> Optional[float]:
    """The mean over units of ``key`` in span ``name``'s row, over the
    units that have the span; None where none has it."""
    vals = [u["spans"][name][key] for u in units if name in u["spans"]]
    return sum(vals) / len(vals) if vals else None


def unit_mean(units: List[Dict], key: str) -> Optional[float]:
    vals = [u[key] for u in units if u["spans"].keys() - {UNATTRIBUTED}]
    return sum(vals) / len(vals) if vals else None


def metric_values(kind: str, program: Optional[Dict]) -> Dict[str, float]:
    """The per-layer metrics that read the program's spans and counter, by
    name, for a ``train`` or ``reg`` run; a metric with nothing to read
    (the program opens no such span) is left out."""
    if not program or not program["units"]:
        return {}
    units = program["units"]
    if kind == "train":
        want = {"fwd_busy_ms.train": span_mean(units, "train.forward",
                                               "busy_ms"),
                "bwd_busy_ms.train": span_mean(units, "train.backward",
                                               "busy_ms"),
                "update_busy_ms.train": span_mean(units, "train.update",
                                                  "busy_ms"),
                "maps_busy_ms.train": span_mean(units, "build.maps",
                                                "busy_ms"),
                "sync_wait_ms.train": unit_mean(units, "sync_wait_ms"),
                "host_syncs.train": unit_mean(units, "syncs")}
    else:
        want = {"encode_launches.reg": span_mean(units, "encode",
                                                 "launches"),
                "ransac_launches.reg": span_mean(units, "ransac",
                                                 "launches"),
                "encode_host_ms.reg": span_mean(units, "encode", "host_ms"),
                "ransac_host_ms.reg": span_mean(units, "ransac", "host_ms"),
                "sync_wait_ms.reg": unit_mean(units, "sync_wait_ms"),
                "host_syncs.reg": unit_mean(units, "syncs")}
        busy = span_mean(units, "ransac", "busy_ms")
        hyp = program.get("hypotheses")
        if busy is not None and hyp:
            want["ransac_ns_per_hyp.reg"] = busy * 1e6 / (hyp / len(units))
    return {k: v for k, v in want.items() if v is not None}
