"""The ``train`` loop: a closed loop of back-to-back training steps, as
the training loop runs them.  Each step takes the next batch of the pool
under a fresh rigid jitter (made one step ahead on a loader thread) and
calls the trainer's public ``build_batch(raw)`` and
``train_step(batch, generator)``.

Set-up builds one trainer, loads the benchmark's weights, and drives it
through its first ``STEPS_CHECKED`` steps, which warm every shape up.  The
same trainer then runs the window, and after it ``STEPS_CHECKED`` more
steps through the same calls and feed, from the state that the window
left (its parameters, running stats, optimizer state, step and the
contrastive generator's state).  The reference follows both runs of
steps: the first from the benchmark's weights, the last from a host copy
of the state the window left.  For each: the losses, the gradient as the
optimizer gets it (the change of its momentum buffers in the first step)
and each leaf's change over the steps.  The reference, its control and its
work counts come from the package that the configuration names
(``harness/sides.py::reference_of``)."""

from __future__ import annotations

import contextlib
import copy
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from types import ModuleType
from typing import Dict, List

import torch

from harness import checks, program
from harness.common import derived_seed, free, generator, memory_peak, \
    print_pace, print_setup, reset_peak
from harness.inputs import PaddedPool, make_pool
from harness.sides import PROGRAM, Side, draw_weights, host_leaves, \
    load_weights, reference_of
from harness.tracing import Spans, TraceRun, readings, sync, timed

STEPS_CHECKED = 3
BUILD_INDEX = 1 << 40      # step indices of the trace's timed builds


class Feed:
    """The pool of ``pool_batches`` batches of distinct pairs and each
    step's jittered raw batch."""

    def __init__(self, side: Side, mix: Dict, frames: Dict, seed: int):
        self.b = side.config.batch_size
        self.batched = not side.predator
        self.mix, self.seed = mix, seed
        pairs = make_pool(mix["scene_seed"], mix["pool_batches"] * self.b,
                          frames["points"], frames["apc_points"],
                          mix["min_dist"], mix["max_dist"], seed)
        self.pool = PaddedPool(pairs, self.b, side.config.point_capacity,
                               side.config.apc_capacity)

    def raw(self, step: int):
        return self.pool.raw(self.seed, step, self.mix["yaw_deg"],
                             self.mix["shift_m"], self.batched)


def _trained(side: Side):
    return [(n, p) for n, p in side.named_parameters() if p.requires_grad]


def _momenta(side: Side) -> Dict[str, torch.Tensor]:
    state = side.trainer.optimizer.state
    return {n: state[p]["momentum_buffer"].detach().clone()
            for n, p in _trained(side)
            if "momentum_buffer" in state.get(p, {})}


def checked_steps(side: Side, feed: Feed, first: int, gen,
                  tally: ModuleType) -> Dict:
    """``STEPS_CHECKED`` steps on the feed's batches ``first``, ...: their
    losses, the first batch on the host, each leaf's gradient as the
    optimizer gets it (its momentum buffer's change in the first step),
    each leaf's change over the steps, and the work that the reference
    counts in them through its ``tally`` (none on the program's side)."""
    tr = side.trainer
    before = {n: p.detach().clone() for n, p in _trained(side)}
    mom0 = _momenta(side)
    out = dict(loss=[], work=Counter())
    for j in range(STEPS_CHECKED):
        with tally.counting() as work:
            batch = tr.build_batch(feed.raw(first + j))
            metrics = tr.train_step(batch, gen)
        out["work"].update(work)
        out["loss"].append(float(metrics["loss"]))
        if j == 0:
            out["built"] = host_leaves(batch)
            out["grad"] = checks.leaf_norms({
                n: m - mom0[n] if n in mom0 else m
                for n, m in _momenta(side).items()})
    out["move"] = checks.leaf_norms({
        n: p.detach() - before[n] for n, p in _trained(side)})
    return out


def host_state(tree):
    """A copy of a trainer's ``state_dict()`` with every tensor on the
    host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_state(v) for v in tree)
    return copy.deepcopy(tree)


def compare(got: Dict, want: Dict, prefix: str) -> Dict[str, float]:
    n_int, f_gap = checks.build_gaps(got["built"], want["built"])
    return {prefix + "build_int_mismatch": float(n_int),
            prefix + "build_float_gap": f_gap,
            prefix + "loss_gap": max(checks.rel_gap(a, r) for a, r in
                                     zip(got["loss"], want["loss"])),
            prefix + "grad_gap": checks.worst_leaf_gap(got["grad"],
                                                       want["grad"]),
            prefix + "move_gap": checks.worst_leaf_gap(got["move"],
                                                       want["move"])}


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, clock0: float, control: bool = False) -> Dict:
    mix, frames = cell.mix, cell.config["frames"]["train"]
    fields = cell.config["fields"]
    ref = reference_of(cell)
    lower = ref.precision.lower if control else contextlib.nullcontext
    res: Dict = {}
    with lower():
        marks = [("imports", time.perf_counter())]
        prog = Side(ref.pkg if control else PROGRAM, fields, device)
        marks.append(("trainer", time.perf_counter()))
        feed = Feed(prog, mix, frames, seed)
        marks.append(("pool", time.perf_counter()))
        weights = draw_weights(prog, derived_seed(seed, 0))
        load_weights(prog, weights)
        weights = {n: w.cpu() for n, w in weights.items()}
        gen_seed = derived_seed(seed, 1)
        gen = generator(device, gen_seed)
        marks.append(("weights", time.perf_counter()))
        got_first = checked_steps(prog, feed, 0, gen, ref.tally)
        sync(device)
        marks.append(("first steps", time.perf_counter()))
        res["setup_s"] = time.perf_counter() - clock0
        print_setup(clock0, marks)
        setup_peak = memory_peak(device)
        reset_peak(device)
        tr, b, k = prog.trainer, feed.b, STEPS_CHECKED
        # the next step's raw batch is made on a second host thread while
        # this step runs, as the training loop's loader makes it
        with ThreadPoolExecutor(max_workers=1) as loader:
            ahead = loader.submit(feed.raw, k)

            def step(_=None):
                nonlocal ahead, k
                raw = ahead.result()
                ahead = loader.submit(feed.raw, k + 1)
                metrics = tr.train_step(tr.build_batch(raw), gen)
                k += 1
                return metrics

            if not control:
                # the timed window; a traced run runs it too, unprofiled,
                # before its trace (``TraceRun.window``)
                skipped: List[torch.Tensor] = []
                ends: List[float] = []
                first = k
                sync(device)
                t_start = time.perf_counter()
                while time.perf_counter() - t_start < seconds:
                    skipped.append(step()["skipped_nonfinite"])
                    ends.append(time.perf_counter())
                sync(device)
                elapsed = time.perf_counter() - t_start
                print_pace("steps", t_start, ends)
                res["window"] = dict(
                    train_pairs_per_s=(k - first) * b / elapsed)
                res.update(res["window"])
                res["attempted"] = k - first
                res["failed"] = int(sum(float(s) for s in skipped))
            if trace:
                n = mix["pace_steps"]
                res["unit_wall_s"] = timed(device, n, step)
                raws = [feed.raw(BUILD_INDEX + i) for i in range(n)]
                res["build_wall_s"] = timed(
                    device, n, lambda i: tr.build_batch(raws[i]))
                del raws
                spans = Spans(device, True)
                with program.profiled_window(device) as box:
                    for _ in range(mix["trace_steps"]):
                        raw = ahead.result()
                        ahead = loader.submit(feed.raw, k + 1)
                        with spans("build"):
                            batch = tr.build_batch(raw)
                        with spans("step"):
                            tr.train_step(batch, gen)
                        k += 1
                res["trace"] = readings(box["window"], ["build", "step"])
                res["program"] = box["program"]
                res["attempted"] = (res.get("attempted", 0)
                                    + mix["trace_steps"])
            ahead.result()
        res.setdefault("attempted", 0)
        res.setdefault("failed", 0)
        res["peak_window"] = memory_peak(device)
        res["memory_peak_bytes"] = max(setup_peak, res["peak_window"])
        # the state the window left, then the steps that follow it
        left = host_state(tr.state_dict())
        gen_state = gen.get_state()
        last = k
        got_last = checked_steps(prog, feed, last, gen, ref.tally)
        del prog, tr, gen, step
    free(device)

    # the reference follows the first steps from the same weights, inputs
    # and contrastive draws, then the last steps from the state the
    # window left
    ref_side = Side(ref.pkg, fields, device)
    load_weights(ref_side, weights)
    want_first = checked_steps(ref_side, feed, 0,
                               generator(device, gen_seed), ref.tally)
    ref_side.trainer.load_state_dict(left)
    ref_gen = generator(device, 0)
    ref_gen.set_state(gen_state)
    want_last = checked_steps(ref_side, feed, last, ref_gen,
                              ref.tally)
    del ref_side, ref_gen
    free(device)

    res["values"] = dict(compare(got_first, want_first, ""),
                         **compare(got_last, want_last, "window_"))
    # a step trains forward and backward: the backward counts twice the
    # forward's operations
    work = want_first["work"]
    per_step = {n: work[n] / STEPS_CHECKED
                for n in ("k1_bytes", "k2_pairs", "k2_bytes")}
    per_step["flops"] = 3 * work["fwd_flops"] / STEPS_CHECKED
    res["work"] = per_step
    res["batch_size"] = b
    return res


def trace_run(res: Dict) -> TraceRun:
    units, window_s, busy_s, breakdown = res["trace"]
    return TraceRun("train", units, window_s, busy_s, res["work"],
                    res["batch_size"], breakdown,
                    unit_wall_s=res["unit_wall_s"],
                    build_wall_s=res["build_wall_s"],
                    program=res["program"], window=res.get("window", {}))
