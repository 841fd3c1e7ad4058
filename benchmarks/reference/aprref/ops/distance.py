# Frozen copy of apr_torch/ops/distance.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Batched nearest-neighbour min over 3-D clouds (kernel K2) and the
Chamfer loss built on it.

``nn_min(queries [B, Nq, 3], supports [B, Ns, 3], s_mask [B, Ns],
q_mask [B, Nq] or None) -> (d2 float32 [B, Nq], idx int32 [B, Nq])`` is
the port of ``apr_tpu/ops/pallas/distance.py::nn_min_pallas``, batched
over clouds so that one launch serves every cloud of a Chamfer direction:
per query, the squared distance to the nearest masked-valid support of its
cloud and that support's index; ties go to the lowest index, and a query
with no valid support gets (inf, Ns).  A query that ``q_mask`` leaves out
gets (inf, Ns) too, uncomputed.

The wrapper partitions each cloud's valid supports (and valid queries) to
the front, keeping their order (:func:`partition`, device ops only), so the
kernel computes only valid pairs from per-cloud counts it reads on the
device; it maps the index back through the partition.  On a CUDA tensor it
the port launches its hand-written kernel; the frozen reference runs
:func:`nn_min_plain` over the compacted clouds on every device, the same
function in plain torch ops, whose sums the kernel repeats in the same
order and rounding (exact agreement, d2 and idx), and adds each call's
valid (query, support) pairs and bytes to ``tally``.

``directed_mean_sq_nn_pallas`` and ``chamfer_distance_pallas`` port the
custom-VJP wrappers of the same file (:120-174), per cloud over the batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from reference.aprref import tally

from reference.aprref.ops.pooling import flat_segments, sorted_row_sums


def nn_min_plain(queries: torch.Tensor, supports: torch.Tensor,
                 s_mask: Optional[torch.Tensor] = None, block: int = 2048
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise running (min, argmin) over supports, per cloud of queries
    [B, Nq, D] and supports [B, Ns, D]; the CPU path of :func:`nn_min`, the
    version the kernel is held against, and the port of
    ``apr_tpu/ops/chamfer.py::nn_distances`` (batched).  Ties go to the
    lowest index, a query with no valid support gets (inf, Ns).

    D <= 4 sums exact per-coordinate differences in coordinate order, for
    3-D points d2 = ((dx*dx) + (dy*dy)) + (dz*dz) (the matmul expansion
    cancels at LiDAR coordinate magnitudes); higher dims use
    |q|^2 - 2 q.s + |s|^2 with a float32 matmul, which needs TF32 off."""
    b, nq, dim = queries.shape
    ns = supports.shape[1]
    if s_mask is None:
        s_mask = torch.ones((b, ns), dtype=torch.bool, device=supports.device)
    best_d2 = torch.full((b, nq), float("inf"), dtype=queries.dtype,
                         device=queries.device)
    best_i = torch.full((b, nq), ns, dtype=torch.int32, device=queries.device)
    qq = (queries * queries).sum(dim=-1) if dim > 4 else None
    for base in range(0, ns, block):
        s = supports[:, base:base + block]
        if dim <= 4:
            d2 = torch.zeros((b, nq, s.shape[1]), dtype=queries.dtype,
                             device=queries.device)
            for c in range(dim):
                dc = queries[:, :, c:c + 1] - s[:, None, :, c]
                d2 = d2 + dc * dc
        else:
            d2 = (qq[:, :, None] - 2.0 * (queries @ s.transpose(1, 2))
                  + (s * s).sum(-1)[:, None, :])
            d2 = torch.clamp(d2, min=0.0)
        d2 = torch.where(s_mask[:, None, base:base + block], d2,
                         float("inf"))
        blk_best, blk_arg = torch.min(d2, dim=2)
        take = blk_best < best_d2
        best_d2 = torch.where(take, blk_best, best_d2)
        best_i = torch.where(take, blk_arg.to(torch.int32) + base, best_i)
    return best_d2, best_i


class Partition(NamedTuple):
    """A stable partition of each cloud's valid points to the front."""

    order: torch.Tensor   # [B, N] int64: original index at each position
    pos: torch.Tensor     # [B, N] int64: position of each original index
    count: torch.Tensor   # [B] int32: valid points


def partition(mask: torch.Tensor) -> Partition:
    """:class:`Partition` of ``mask`` [B, N] by device ops alone (cumsum
    positions and one scatter; no host sync): valid points keep their order
    at positions [0, count), the rest follow in theirs."""
    b, n = mask.shape
    if n == 0:
        none = torch.zeros((b, 0), dtype=torch.int64, device=mask.device)
        return Partition(none, none, torch.zeros(
            b, dtype=torch.int32, device=mask.device))
    # valid points before each one: a scan within rows of 256, then over
    # the rows' totals (a scan of a few long rows runs one block per row)
    rows = torch.nn.functional.pad(mask.long(), (0, -n % 256)).view(b, -1, 256)
    inner = torch.cumsum(rows, dim=2)
    totals = torch.cumsum(inner[:, :, -1], dim=1)
    count = totals[:, -1]
    before = (inner - rows + (totals - inner[:, :, -1])[:, :, None]).view(
        b, -1)[:, :n]
    ar = torch.arange(n, device=mask.device)
    pos = torch.where(mask, before, count[:, None] - before + ar)
    order = torch.empty_like(pos).scatter_(1, pos, ar.expand(b, -1))
    return Partition(order, pos, count.to(torch.int32))


def compact(points: torch.Tensor, part: Partition) -> torch.Tensor:
    """points [B, N, 3] in partition order as [B, N, 4] (x, y, z, 0): the
    layout the kernel stages with 16-byte copies."""
    padded = torch.nn.functional.pad(points, (0, 1))
    return torch.gather(padded, 1, part.order[..., None].expand(-1, -1, 4))


def _check(queries, supports, s_mask, q_mask) -> None:
    if queries.dtype != torch.float32 or supports.dtype != torch.float32:
        raise TypeError(f"nn_min takes float32 points, got {queries.dtype} "
                        f"and {supports.dtype}")
    if s_mask.dtype != torch.bool or (q_mask is not None
                                      and q_mask.dtype != torch.bool):
        raise TypeError("nn_min takes bool masks")
    b, nq = queries.shape[:2]
    if (queries.dim() != 3 or supports.dim() != 3 or queries.shape[2] != 3
            or supports.shape[2] != 3 or supports.shape[0] != b
            or tuple(s_mask.shape) != tuple(supports.shape[:2])
            or (q_mask is not None
                and tuple(q_mask.shape) != tuple(queries.shape[:2]))):
        raise ValueError(f"want queries [B, Nq, 3], supports [B, Ns, 3], "
                         f"s_mask [B, Ns] and q_mask [B, Nq], got "
                         f"{tuple(queries.shape)}, {tuple(supports.shape)}, "
                         f"{tuple(s_mask.shape)} and "
                         f"{None if q_mask is None else tuple(q_mask.shape)}")
    masks = (s_mask,) if q_mask is None else (s_mask, q_mask)
    if any(x.device != queries.device for x in (supports,) + masks):
        raise ValueError("nn_min takes its tensors on one device")


def _compact_plain(q4, s4, nq_count, ns_count):
    """The kernel's function in plain torch ops: :func:`nn_min_plain` over
    the compacted supports with a prefix mask (and over every query, the
    ``nq_count`` valid ones among them)."""
    ns = s4.shape[1]
    s_valid = (torch.arange(ns, device=s4.device)[None, :]
               < ns_count[:, None])
    d2, idx = nn_min_plain(q4[..., :3], s4[..., :3], s_valid)
    return d2, idx.long()


def nn_min_partitioned(queries: torch.Tensor, supports: torch.Tensor,
                       s_part: Partition, q_part: Optional[Partition] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nn_min` from precomputed partitions (a Chamfer computes each
    mask's partition once for both directions)."""
    b, nq = queries.shape[:2]
    ns = supports.shape[1]
    dev = queries.device
    if b == 0 or nq == 0 or ns == 0:
        return (torch.full((b, nq), float("inf"), device=dev),
                torch.full((b, nq), ns, dtype=torch.int32, device=dev))
    s4 = compact(supports, s_part)
    if q_part is None:
        q4 = torch.nn.functional.pad(queries, (0, 1))
        nq_count = torch.full((b,), nq, dtype=torch.int32, device=dev)
    else:
        q4, nq_count = compact(queries, q_part), q_part.count
    # the reference runs the plain version on every device
    tally.add("k2_pairs", (nq_count.long() * s_part.count.long()).sum())
    tally.add("k2_bytes", 12 * (nq_count.long() + s_part.count.long()).sum()
              + 8 * nq_count.long().sum())
    d2, idx = _compact_plain(q4, s4, nq_count, s_part.count)
    found = idx < s_part.count[:, None]
    idx = torch.where(found, torch.gather(s_part.order, 1,
                                          torch.where(found, idx, 0)), ns)
    if q_part is not None:
        valid = q_part.pos < q_part.count[:, None]
        d2 = torch.where(valid, torch.gather(d2, 1, q_part.pos),
                         float("inf"))
        idx = torch.where(valid, torch.gather(idx, 1, q_part.pos), ns)
    return d2, idx.to(torch.int32)


def nn_min(queries: torch.Tensor, supports: torch.Tensor,
           s_mask: Optional[torch.Tensor] = None,
           q_mask: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min sqdist float32 [B, Nq], argmin idx int32 [B, Nq]); see the
    module docstring for the contract.  With ``q_mask`` only the valid
    queries are computed, and the others get (inf, Ns)."""
    if s_mask is None:
        s_mask = torch.ones(supports.shape[:2], dtype=torch.bool,
                            device=supports.device)
    _check(queries, supports, s_mask, q_mask)
    return nn_min_partitioned(
        queries.contiguous(), supports.contiguous(), partition(s_mask),
        None if q_mask is None else partition(q_mask))



def directed_backward(queries, supports, resolved, idx, nq, g):
    """Gradients of a per-cloud masked mean of NN squared distances: the
    argmin support is re-gathered (no distance tile is saved) and the
    support side sums each support's queries.  ``resolved`` [B, Nq] marks
    the queries that carry gradient, ``nq`` [B] the per-cloud divisors,
    ``g`` [B].

    The support side is a segment sum over the queries sorted stably by
    their support, each support's queries added in query order: no float
    atomics (``index_add_`` on the card adds in whatever order its threads
    land, so two runs of a train step would differ in the last bits)."""
    b, n_s = supports.shape[:2]
    safe = idx.clamp(0, max(n_s - 1, 0)).long()
    nn_pts = torch.gather(supports, 1, safe[..., None].expand(-1, -1, 3))
    diff = torch.where(resolved[..., None], queries - nn_pts, 0.0)
    dq = (2.0 * g / nq)[:, None, None] * diff
    ds, _ = sorted_row_sums(-dq.reshape(-1, 3), flat_segments(safe, n_s),
                            b * n_s)
    return dq, ds.reshape(b, n_s, 3)


def masked_mean(d2: torch.Tensor, q_mask: torch.Tensor):
    """(sum of d2 over valid queries / max(count, 1), that divisor), per
    cloud."""
    nq = torch.clamp(q_mask.to(d2.dtype).sum(dim=1), min=1.0)
    return torch.where(q_mask, d2, 0.0).sum(dim=1) / nq, nq


class DirectedMeanSqNNPallas(torch.autograd.Function):
    """Per cloud, the masked mean over queries of the squared distance to
    the nearest valid support, through kernel K2 on the valid queries only;
    the backward masks with ``(idx < Ns) & q_mask`` as the Pallas VJP does
    (distance.py:151).  ``q_part`` / ``s_part``: the masks' partitions."""

    @staticmethod
    def forward(ctx, queries, supports, q_mask, s_mask, q_part, s_part):
        d2, idx = nn_min_partitioned(queries.contiguous(),
                                     supports.contiguous(), s_part, q_part)
        val, nq = masked_mean(d2, q_mask)
        ctx.save_for_backward(queries, supports, q_mask, idx, nq)
        return val

    @staticmethod
    def backward(ctx, g):
        queries, supports, q_mask, idx, nq = ctx.saved_tensors
        resolved = (idx < supports.shape[1]) & q_mask
        dq, ds = directed_backward(queries, supports, resolved, idx, nq, g)
        return dq, ds, None, None, None, None


def directed_mean_sq_nn_pallas(queries, supports, q_mask, s_mask):
    """[B] masked mean of min squared NN distances (kernel K2 forward)."""
    return DirectedMeanSqNNPallas.apply(queries, supports, q_mask, s_mask,
                                        partition(q_mask), partition(s_mask))


def chamfer_distance_pallas(a, b, a_mask=None, b_mask=None):
    """[B] bidirectional Chamfer (reference normalization) per cloud of
    a [B, Na, 3] and b [B, Nb, 3], through kernel K2; each mask is
    partitioned once for both directions."""
    if a_mask is None:
        a_mask = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    if b_mask is None:
        b_mask = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
    pa, pb = partition(a_mask), partition(b_mask)
    return (DirectedMeanSqNNPallas.apply(a, b, a_mask, b_mask, pa, pb)
            + DirectedMeanSqNNPallas.apply(b, a, b_mask, a_mask, pb, pa))
