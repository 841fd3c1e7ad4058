"""The program's own spans in traced runs of a benchmark cell, on the card:

    python3 benchmarks/spans.py --workload <cell> --seed <n> [<n> ...] \
        [--out <dir>]

Each seed is one ``run.py --trace 1`` run of the cell (the same loop,
window, comparison and result line), whose profile ``harness/program.py``
reads as every traced run's: the ``apr::`` spans that ``apr_torch`` opens
at its step, build and tester boundaries, each unit's kernels attributed
to them through their launch calls.  Printed per seed: the result line's
per-layer metrics and ``correct``; per span the mean over units of host
ms, busy ms, launches, host syncs and sync-wait ms, read through the same
``TraceRun.span_mean`` as the span metrics' readers; and the checks of
the reading: per
``bench::`` stage the launches attributed (spans plus ``unattributed``)
against the frozen count, busy against the frozen busy, the unattributed
share of the stage's busy, the train step's three spans against the
step's busy, and how each activity was linked to its launch.  The whole
reading goes to ``<out>/<cell>.<seed>.json`` (``build/spans`` by
default).
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)


def mean(vals):
    vals = list(vals)
    return sum(vals) / len(vals) if vals else float("nan")


def report(cell: str, seed: int, out: dict, run) -> dict:
    """Print the run's span table and checks; the record to keep."""
    reading = run.program
    units = reading["units"]
    names = list(dict.fromkeys(n for u in units for n in u["spans"]))
    print(f"== {cell} seed {seed}: correct {out['correct']}, "
          f"{len(units)} units, hypotheses {reading['hypotheses']}")
    for n, m in out["metrics"].items():
        print(f"metric {n} {m['value']!r} {m['unit']}")
    print(f"{'span':<16} {'host ms':>10} {'busy ms':>10} {'launches':>9} "
          f"{'syncs':>6} {'wait ms':>10}")
    for n in names:
        row = {k: run.span_mean(n, k) for k in
               ("host_ms", "busy_ms", "launches", "syncs", "sync_wait_ms")}
        print(f"{n:<16} {row['host_ms']:10.3f} {row['busy_ms']:10.3f} "
              f"{row['launches']:9.1f} {row['syncs']:6.1f} "
              f"{row['sync_wait_ms']:10.3f}")
    checks = {}
    for stage in units[0]["stages"]:
        rows = [u["stages"][stage] for u in units if stage in u["stages"]]
        checks[stage] = dict(
            launches_equal=all(r["launches"] == r["device_launches"]
                               for r in rows),
            launches=mean(r["launches"] for r in rows),
            frozen_launches=mean(r["device_launches"] for r in rows),
            busy_ms=mean(r["busy_ms"] for r in rows),
            frozen_busy_ms=mean(r["device_busy_ms"] for r in rows),
            unattributed=mean(r["unattributed"] for r in rows),
            unattributed_share=mean(r["unattributed_busy_ms"]
                                    / max(r["busy_ms"], 1e-12)
                                    for r in rows))
        print(f"check {stage}: {checks[stage]}")
    if "train.forward" in names:
        three = sum(run.span_mean(n, "busy_ms") for n in
                    ("train.forward", "train.backward", "train.update"))
        step = checks["step"]["frozen_busy_ms"]
        checks["three_over_step"] = three / max(step, 1e-12)
        print(f"check forward + backward + update busy {three:.3f} ms over "
              f"the step's {step:.3f} ms: {checks['three_over_step']:.4f}")
    print(f"links {reading['links']}")
    for name, s in out.get("breakdown", {}).get("idle_gaps", []):
        print(f"idle gap {name} {s * 1e3:.3f} ms")
    return dict(cell=cell, seed=seed, correct=out["correct"],
                metrics=out["metrics"], checks=checks,
                breakdown=out.get("breakdown"), device=out["device"],
                reading=reading)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "spans"))
    args = ap.parse_args(argv)

    import torch

    from harness import cells
    from harness.report import run_cell

    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        print("no CUDA device: the spans are read on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    os.makedirs(args.out, exist_ok=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(device)}")
    for seed in args.seed:
        runs = []
        out = run_cell(cell, seed, 1.0, True, device, CLOCK0, keep=runs)
        rec = report(args.workload, seed, out, runs[0])
        path = os.path.join(args.out, f"{args.workload}.{seed}.json")
        with open(path, "w") as f:
            json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
