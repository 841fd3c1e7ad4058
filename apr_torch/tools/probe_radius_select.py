"""Window k-smallest selector study for the KP radius tables (the
counterpart of the root ``tools/probe_radius_select.py``).

The port keeps one selector, ``apr_torch/ops/neighbors.py::_smallest_k``
(``torch.topk`` over an int64 key: the distance's bits above the
position).  This probe holds its own ports of the reference's two other
selectors (``_topk_tournament`` and ``_topk_itermin``, its
``_SELECTORS``), with the same int64 key and so the same tie rule, and
measures each in context: the full ``build_kp_pyramid`` at flagship
shape, swapped in for ``_smallest_k`` by :func:`selector` for the time of
one measurement.  Before it times a selector it checks that the
selector's tables equal the program's own (on a card, kernel K3's).  On a
card the program's searches select in kernel K3 and never reach
``_smallest_k``, so :func:`selector` also keeps them on the plain chain
that does.  The build reads its windows' overflow flags on the host, so
it is timed by wall and busy ms only.

    python -m apr_torch.tools.probe_radius_select [--iters 8]
        [--methods topk,tournament,itermin] [--device cuda]
"""

import argparse
import contextlib
import sys
from typing import Tuple

import torch

from apr_torch.data.synthetic import pad_points, synthetic_pair
from apr_torch.device import resolve_device
from apr_torch.models.kpconv import build_kp_pyramid
from apr_torch.ops import neighbors
from apr_torch.utils.profiling import device_line, jitter, time_stage

# the reference's fixed sizes (its probe's flagship shape)
CAPS = (16384, 4096, 2048, 1024)
LIMITS = (40, 40, 40, 40)
POINTS = 30000
POINT_CAPACITY = 32768
TOURNAMENT_CHUNK = 128

_KEEP = neighbors._smallest_k      # the port's selector ("topk")


def _keys(d2: torch.Tensor) -> torch.Tensor:
    """The port's int64 selection key of a non-negative d2 [..., W]:
    distance bits above the position (``_smallest_k``'s)."""
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)
    pos = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    return (bits << 32) | pos


def _smallest_k_tournament(d2: torch.Tensor, k: int,
                           chunk: int = TOURNAMENT_CHUNK
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_topk_tournament``: the k smallest of every chunk
    of ``chunk`` positions, then the k smallest of those finalists.  Exact:
    each of the row's k smallest is among its chunk's k smallest.  Falls
    back to the plain selection where the reference's does."""
    w = d2.shape[-1]
    if w % chunk or w <= chunk or k > chunk:
        return _KEEP(d2, k)
    key = _keys(d2).reshape(*d2.shape[:-1], w // chunk, chunk)
    first = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    final = torch.topk(first.flatten(-2), k, dim=-1, largest=False,
                       sorted=True).values
    idx = final & 0xFFFFFFFF
    return torch.gather(d2, -1, idx), idx


def _smallest_k_itermin(d2: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_topk_itermin``: k sequential passes, each taking
    the row's least key and rewriting it to the largest int64."""
    key = _keys(d2)
    taken = []
    for _ in range(k):
        least, at = key.min(dim=-1, keepdim=True)
        taken.append(least)
        key = key.scatter(-1, at, torch.iinfo(torch.int64).max)
    idx = torch.cat(taken, -1) & 0xFFFFFFFF
    return torch.gather(d2, -1, idx), idx


SELECTORS = {"topk": _KEEP, "tournament": _smallest_k_tournament,
             "itermin": _smallest_k_itermin}


def _plain_chain(points: torch.Tensor, k: int) -> bool:
    """``neighbors._takes_k3`` inside :func:`selector`: no search runs
    kernel K3."""
    return False


@contextlib.contextmanager
def selector(method: str):
    """``neighbors._smallest_k`` swapped for the selector ``method`` inside
    the block, every search kept on the plain chain that calls it (on a
    card too), both restored on exit, also when the block raises."""
    fn = SELECTORS[method]
    saved = neighbors._smallest_k, neighbors._takes_k3
    neighbors._smallest_k = fn
    neighbors._takes_k3 = _plain_chain
    try:
        yield fn
    finally:
        neighbors._smallest_k, neighbors._takes_k3 = saved


def build(pts, msk):
    """The timed stage: ``build_kp_pyramid`` with the selector in force."""
    return build_kp_pyramid(pts, msk, 0.3, 4.25, len(CAPS), CAPS, LIMITS)


def flagship_cloud(device):
    pair = synthetic_pair(seed=0, n_points=POINTS, apc_points=4,
                          extent=60.0, distance=15.0)
    p0, m0 = pad_points(pair["points0"], POINT_CAPACITY)
    return (torch.from_numpy(p0)[None].to(device),
            torch.from_numpy(m0)[None].to(device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--methods", default="topk,tournament,itermin")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    methods = args.methods.split(",")
    for m in methods:
        if m not in SELECTORS:
            raise SystemExit(f"unknown method {m!r}; one of "
                             f"{', '.join(SELECTORS)}")
    pts, msk = flagship_cloud(dev)
    print(f"# probe_radius_select caps {CAPS} limits {LIMITS} points "
          f"{POINTS} iters {args.iters}; {device_line(dev)}", flush=True)

    with torch.inference_mode():
        want = build(pts, msk)
    rows, results = [], {}
    for method in methods:
        with selector(method), torch.inference_mode():
            got = build(pts, msk)
            for lvl, (a, b) in enumerate(zip(got.levels, want.levels)):
                for name in ("neighbors", "pools", "upsamples"):
                    if not torch.equal(getattr(a, name), getattr(b, name)):
                        raise AssertionError(
                            f"selector {method}: level {lvl} {name} "
                            f"differ from the program's")
            row, _ = time_stage(
                f"build_kp_pyramid [{method}]",
                lambda p: build(p, msk), pts,
                jitter, args.iters, dev,
                syncs=True, unit="build")
        rows.append(row)
        results[method] = row.wall_ms
        print(f"# exactness vs the program [{method}]: 100.000% entries "
              f"equal (every table of every level)", flush=True)
    print({"results_ms": results})
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
