"""One run of one benchmark cell, on the card it is started on:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` it measures the cell's end-to-end metrics over a window
of ``--seconds``; with ``--trace 1`` it runs the same window, then profiles
a fixed number of steps or pairs, and reports the cell's per-layer metrics
(the window's readings among them, where a cell reports them per layer).  Either way the frozen
reference then checks what the timed path produced, and the last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit).  ``--control 1`` puts
the reference computed one precision lower in the program's place, and
``--fault <name>`` plants a fault of ``harness/faults.py`` in the program:
the control and the faults that ``correct`` has to catch (the
benchmark's own runs pass neither).
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)

    import contextlib

    import torch

    from harness import cells, faults, guard
    from harness.report import run_cell

    # load from one process with few threads: the host's cores are shared
    torch.set_num_threads(2)

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and has no "
              "CPU path", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    plant = faults.FAULTS[args.fault] if args.fault else \
        contextlib.nullcontext
    with plant():
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, CLOCK0, control=bool(args.control))
    found = guard.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the port and the "
              f"benchmark may import neither JAX nor the JAX package",
              file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi or torch.cuda.get_device_name(device)}",
          file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in out["checks"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
