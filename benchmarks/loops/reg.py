"""The ``reg`` loop: a closed loop of online registration, one distant
pair at a time, through the tester's per-pair call, as
``FeatureTester.test(..., pipelined=False)`` / ``PredatorTester.test``
make it: ``tester.step(tester._bucketed_batch(pair), generator)`` (the
build, the encoder, and ``eval_one``'s subsample, matching and RANSAC).
A pair ends when its pose, RTE, RRE and fitness are on the host; its
latency runs from when it is handed in.

Once the window has closed, a sample of its pairs, drawn from the seed
over all of them, is registered again by the reference from the same
weights, inputs and random draws, and its answers are held to the
window's.  The program encodes the sampled pairs once more, outside the
timing, so that its batches and features are held to the reference's
too.  The reference, its control and its work counts come from the
package that the configuration names (``harness/sides.py::
reference_of``)."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import checks, program
from harness.common import derived_seed, free, generator, memory_peak, \
    print_pace, print_setup, reset_peak
from harness.inputs import jittered, make_pool, rng
from harness.sides import PROGRAM, Side, draw_weights, host_leaves, \
    load_weights, reference_of
from harness.tracing import Spans, TraceRun, readings, sync, timed

WARMUP_INDEX = 1 << 40     # jitter indices of the warm-up pairs
PACE_INDEX = 1 << 41       # jitter indices of the trace's timed pairs


def answer(t, rte, rre, fit) -> torch.Tensor:
    """The 4x4 pose, RTE, RRE and fitness as 19 float32 on the host."""
    return torch.cat([t.reshape(-1).float(),
                      torch.stack([rte, rre, fit]).float()]).cpu()


def register(side: Side, pair: Dict, seed: int, spans: Spans
             ) -> torch.Tensor:
    """One pair through the tester's per-pair call: its answer."""
    gen = generator(side.device, seed)
    with spans("build"):
        batch = side.tester._bucketed_batch(pair)
    with spans("step"):
        return answer(*side.tester.step(batch, gen))


def encode(side: Side, pair: Dict):
    """The pair's batch and its encoder outputs, as ``step`` makes them:
    (f0, f1) for FCGF, the KPFCNN's outputs for Predator."""
    batch = side.tester._bucketed_batch(pair)
    with torch.inference_mode():
        if side.predator:
            return batch, side.tester.forward(batch)
        f0, f1 = side.trainer._encode_pair(batch, train=False)
        return batch, (f0[0], f1[0])


def evaluate(side: Side, batch, feats, seed: int) -> torch.Tensor:
    """Subsample, match and register from the encoder's outputs, as
    ``step`` does: the answer."""
    with torch.inference_mode():
        gen = generator(side.device, seed)
        if side.predator:
            return answer(*side.tester.eval_one(feats, batch, gen))
        return answer(*side.tester.eval_one(
            feats[0], feats[1], batch.xyz0[0], batch.xyz1[0],
            batch.pyramid0.levels[0].mask[0],
            batch.pyramid1.levels[0].mask[0], batch.t_gt[0], gen))


def valid_rows(side: Side, batch) -> List[torch.Tensor]:
    """The level-0 masks of the encoder outputs' rows, in their order."""
    if side.predator:
        m0, m1 = batch.pyr0.levels[0].mask, batch.pyr1.levels[0].mask
        return [m0, m1, m0, m1, m0, m1]
    return [batch.pyramid0.levels[0].mask[0], batch.pyramid1.levels[0].mask[0]]


def run(cell, seed: int, seconds: float, trace: bool,
        device: torch.device, clock0: float, control: bool = False) -> Dict:
    mix, frames = cell.mix, cell.config["frames"]["reg"]
    fields = cell.config["fields"]
    ref = reference_of(cell)
    lower = ref.precision.lower if control else contextlib.nullcontext
    marks = [("imports", time.perf_counter())]
    pool = make_pool(mix["scene_seed"], mix["pool_pairs"], frames["points"],
                     4, mix["min_dist"], mix["max_dist"], seed)
    marks.append(("pool", time.perf_counter()))

    def pair(k):
        return jittered(pool[k % len(pool)], seed, k, mix["yaw_deg"],
                        mix["shift_m"])

    res: Dict = {}
    answers: List[torch.Tensor] = []
    off = Spans(device, False)
    with lower():
        prog = Side(ref.pkg if control else PROGRAM, fields, device)
        marks.append(("trainer", time.perf_counter()))
        weights = draw_weights(prog, derived_seed(seed, 0))
        load_weights(prog, weights)
        weights = {n: w.cpu() for n, w in weights.items()}
        marks.append(("weights", time.perf_counter()))
        for j in range(mix["warmup_pairs"]):
            register(prog, pair(WARMUP_INDEX + j),
                     derived_seed(seed, 2, WARMUP_INDEX + j), off)
        sync(device)
        marks.append(("warm-up pairs", time.perf_counter()))
        res["setup_s"] = time.perf_counter() - clock0
        print_setup(clock0, marks)
        setup_peak = memory_peak(device)
        reset_peak(device)
        if not control:
            # the timed window; a traced run runs it too, unprofiled,
            # before its trace (``TraceRun.window``)
            lat, ends = [], []
            sync(device)
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < seconds:
                p = pair(len(answers))
                t_in = time.perf_counter()
                answers.append(register(prog, p,
                                        derived_seed(seed, 2, len(answers)),
                                        off))
                ends.append(time.perf_counter())
                lat.append(ends[-1] - t_in)
            elapsed = time.perf_counter() - t_start
            print_pace("pairs", t_start, ends)
            res["window"] = dict(
                reg_pairs_per_s=len(lat) / elapsed,
                reg_latency_p90_ms=float(np.percentile(lat, 90)) * 1e3)
            res.update(res["window"])
        if trace:
            res["unit_wall_s"] = timed(
                device, mix["pace_pairs"],
                lambda j: register(prog, pair(PACE_INDEX + j),
                                   derived_seed(seed, 2, PACE_INDEX + j),
                                   off))
        if trace or control:
            spans = Spans(device, trace)
            first = len(answers)
            with (program.profiled_window(device) if trace
                  else contextlib.nullcontext({})) as box:
                for k in range(first, first + mix["trace_pairs"]):
                    answers.append(register(prog, pair(k),
                                            derived_seed(seed, 2, k), spans))
            if trace:
                res["trace"] = readings(box["window"], ["build", "step"])
                res["program"] = box["program"]
        res["peak_window"] = memory_peak(device)
        res["memory_peak_bytes"] = max(setup_peak, res["peak_window"])
        # the sample, drawn over every pair of the window once it has
        # closed; the program encodes its pairs once more, untimed
        sample = sorted(int(i) for i in rng(seed, 4).choice(
            len(answers), size=min(mix["checked_pairs"], len(answers)),
            replace=False))
        kept, batch, feats = {}, None, None
        for k in sample:
            batch, feats = encode(prog, pair(k))
            kept[k] = dict(built=host_leaves(batch), feats=host_leaves(feats))
        del prog, batch, feats
    free(device)
    res["attempted"] = len(answers)
    res["failed"] = 0
    for k, a in enumerate(answers):
        if not bool(torch.isfinite(a).all()):
            res["failed"] += 1
            print(f"pair {k}: not finite {a.tolist()}", file=sys.stderr)

    # the reference registers the sampled pairs again from the same
    # weights, inputs and random draws, from its own batches and features
    ref_side = Side(ref.pkg, fields, device)
    load_weights(ref_side, weights)
    vals = dict(build_int_mismatch=0.0, build_float_gap=0.0, feat_gap=0.0,
                answer_gap=0.0)
    work = {"k1_bytes": 0, "fwd_flops": 0}
    for k in sample:
        got, got_kept = answers[k], kept[k]
        with ref.tally.counting() as c:
            batch, feats = encode(ref_side, pair(k))
            want = evaluate(ref_side, batch, feats, derived_seed(seed, 2, k))
        for n in work:
            work[n] += c[n] / len(sample)
        n_int, f_gap = checks.build_gaps(got_kept["built"],
                                         host_leaves(batch))
        vals["build_int_mismatch"] += n_int
        vals["build_float_gap"] = max(vals["build_float_gap"], f_gap)
        for fp, fr, m in zip(got_kept["feats"], host_leaves(feats),
                             valid_rows(ref_side, batch)):
            vals["feat_gap"] = max(vals["feat_gap"],
                                   checks.feature_gap(fp, fr, m))
        vals["answer_gap"] = max(vals["answer_gap"],
                                 checks.answer_gap(got, want))
        print(f"pair {k}: program {got.tolist()}", file=sys.stderr)
        print(f"pair {k}: reference {want.tolist()}", file=sys.stderr)
    del ref_side
    free(device)
    res["values"] = vals
    res["work"] = dict(k1_bytes=work["k1_bytes"], flops=work["fwd_flops"])
    return res


def trace_run(res: Dict) -> Optional[TraceRun]:
    units, window_s, busy_s, breakdown = res["trace"]
    return TraceRun("reg", units, window_s, busy_s, res["work"], 1,
                    breakdown, unit_wall_s=res["unit_wall_s"],
                    program=res["program"], window=res.get("window", {}))
