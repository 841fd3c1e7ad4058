"""The numbers that decide ``correct``: each a gap between what the
program's timed path produced and what the frozen reference works out
again from the same inputs and weights, held to its limit from
``limits/<cell>.json``."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch


def build_gaps(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]):
    """(integer and bool entries that differ, the largest float gap) over
    the leaves of two batches: voxel keys, coordinates, masks, kernel maps,
    neighbour lists and correspondences are integers; points are floats.
    A leaf of another shape counts every entry as differing."""
    if len(prog) != len(ref):
        return float("inf"), float("inf")
    n_int, f_gap = 0, 0.0
    for a, b in zip(prog, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            n_int += max(a.numel(), b.numel())
        elif a.dtype.is_floating_point:
            if a.numel():
                d = (a.double() - b.double()).abs()
                d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
                f_gap = max(f_gap, float(torch.nan_to_num(
                    d, nan=float("inf")).max()))
        else:
            n_int += int((a != b).sum())
    return n_int, f_gap


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The largest |program norm - reference norm| over the leaves, each
    against the larger of its reference norm and the median leaf's.
    Leaves whose reference norm is under a thousandth of the median's
    (a conv bias under batch norm, moved by round-off alone) are left
    out.  Where the reference read no leaf at all there is nothing that
    could agree: the gap is infinite, never 0."""
    if not ref:
        return float("inf")
    vals = sorted(ref.values())
    med = vals[len(vals) // 2]
    gaps = [abs(prog.get(n, 0.0) - r) / max(r, med)
            for n, r in ref.items() if r >= 1e-3 * med and med > 0]
    return max(gaps) if gaps else 0.0


def rel_gap(prog: float, ref: float) -> float:
    """|prog - ref| against |ref|."""
    if not (math.isfinite(prog) and math.isfinite(ref)):
        return float("inf")
    return abs(prog - ref) / max(abs(ref), 1e-12)


def answer_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest absolute gap between two answers (pose, RTE, RRE,
    fitness); NaN where both have NaN is no gap, NaN on one side alone
    is an infinite one."""
    a, b = prog.double(), ref.double()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def feature_gap(prog: torch.Tensor, ref: torch.Tensor, mask) -> float:
    """The largest absolute gap of one feature entry over the valid rows."""
    d = (prog.float().cpu() - ref.float().cpu()).abs()
    d = d[mask.cpu()] if mask is not None else d
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() \
        else 0.0


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> List[List]:
    """[name, value, limit] for every number compared; a number with no
    limit fails."""
    return [[n, v, limits.get(n, -1.0)] for n, v in values.items()]


def passed(rows: List[List]) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows)
