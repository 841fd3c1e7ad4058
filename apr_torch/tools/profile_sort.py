"""Sort-floor study (the counterpart of the root ``tools/profile_sort.py``):
is ``torch.sort`` the floor under the voxel pipeline on the card, or does
the data-oblivious bitonic network (``apr_torch/ops/sort.py``) beat it at
the pipeline's shapes?

Shapes: the pyramid argsort ([N] keys with an index payload, N = the
point capacity) and the batched form ([B, N]: the 2B-folded batch build
sorts every cloud in one call).  Keys are 30-bit packed voxel keys
(int32).  Each stage runs K chained iterations, each on keys re-keyed
from the previous output (``(x ^ r) & (2^30 - 1)`` with fresh random
``r``, which keeps the value distribution); protocol:
``apr_torch/utils/profiling.py::time_stage``.

    python -m apr_torch.tools.profile_sort [--n 32768] [--batch 8]
        [--k 32] [--device cuda]
"""

import argparse
import sys

import numpy as np
import torch

from apr_torch.device import resolve_device
from apr_torch.ops.sort import bitonic_argsort, bitonic_sort
from apr_torch.utils.profiling import checksum, device_line, time_stage

MASK30 = (1 << 30) - 1


def rekey(base: torch.Tensor, out, i: int) -> torch.Tensor:
    """Iteration ``i``'s keys: the previous output's sorted keys XOR fresh
    random 30-bit keys (seed ``i``), plus a zero that reads every output
    tensor."""
    prev = out[0] if isinstance(out, tuple) else out
    g = torch.Generator(base.device).manual_seed(i)
    r = torch.randint(0, 1 << 30, base.shape, generator=g,
                      device=base.device, dtype=torch.int32)
    dep = (checksum(out) * 0).to(torch.int32)
    return ((prev ^ r) & MASK30) + dep


def stages(n: int, batch: int):
    """(label, function, which input: "1" the [n] keys or "b" the [batch,
    n] keys) in the reference's order; each function returns what it
    computed."""
    return [
        (f"torch.sort keys [{n}]", lambda x: torch.sort(x).values, "1"),
        (f"bitonic keys [{n}]", lambda x: bitonic_sort(x)[0], "1"),
        (f"torch.sort stable + indices [{n}]",
         lambda x: tuple(torch.sort(x, stable=True)), "1"),
        (f"bitonic argsort [{n}]", bitonic_argsort, "1"),
        (f"batched torch.sort stable + indices [{batch},{n}]",
         lambda x: tuple(torch.sort(x, dim=-1, stable=True)), "b"),
        (f"batched bitonic argsort [{batch},{n}]", bitonic_argsort, "b"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x1 = torch.from_numpy(rng.integers(0, 1 << 30, size=args.n)
                          .astype(np.int32)).to(dev)
    xb = torch.from_numpy(rng.integers(0, 1 << 30, size=(args.batch, args.n))
                          .astype(np.int32)).to(dev)
    print(f"# n={args.n} batch={args.batch} k={args.k}; {device_line(dev)}",
          flush=True)
    rows = []
    for label, fn, which in stages(args.n, args.batch):
        row, _ = time_stage(label, fn, x1 if which == "1" else xb, rekey,
                            args.k, dev, unit="sort")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
