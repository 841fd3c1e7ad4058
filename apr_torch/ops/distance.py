"""Batched nearest-neighbour min over 3-D clouds (kernel K2) and the
Chamfer loss built on it.

``nn_min(queries [B, Nq, 3], supports [B, Ns, 3], s_mask [B, Ns])
-> (d2 float32 [B, Nq], idx int32 [B, Nq])`` is the port of
``apr_tpu/ops/pallas/distance.py::nn_min_pallas``, batched over clouds so
that one launch serves every cloud of a Chamfer direction: per query, the
squared distance to the nearest masked-valid support of its cloud and that
support's index; ties go to the lowest index, and a query with no valid
support gets (inf, Ns).

On a CUDA tensor the wrapper launches the hand-written kernel
``apr_torch/csrc/nn_min.cu`` (or raises); on a CPU tensor it runs
:func:`nn_min_plain`, the same function in plain torch ops, whose sums the
kernel repeats in the same order and rounding (exact agreement, d2 and idx).
``nn_min.launches`` counts kernel launches.

``directed_mean_sq_nn_pallas`` and ``chamfer_distance_pallas`` port the
custom-VJP wrappers of the same file (:120-174), per cloud over the batch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch


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


def _check(queries, supports, s_mask) -> None:
    if queries.dtype != torch.float32 or supports.dtype != torch.float32:
        raise TypeError(f"nn_min takes float32 points, got {queries.dtype} "
                        f"and {supports.dtype}")
    if s_mask.dtype != torch.bool:
        raise TypeError(f"nn_min takes a bool support mask, got "
                        f"{s_mask.dtype}")
    b, nq = queries.shape[:2]
    if (queries.dim() != 3 or supports.dim() != 3 or queries.shape[2] != 3
            or supports.shape[2] != 3 or supports.shape[0] != b
            or tuple(s_mask.shape) != tuple(supports.shape[:2])):
        raise ValueError(f"want queries [B, Nq, 3], supports [B, Ns, 3] and "
                         f"s_mask [B, Ns], got {tuple(queries.shape)}, "
                         f"{tuple(supports.shape)} and {tuple(s_mask.shape)}")
    if not (queries.device == supports.device == s_mask.device):
        raise ValueError(f"queries on {queries.device}, supports on "
                         f"{supports.device}, s_mask on {s_mask.device}")


def _launch(queries, supports, s_mask):
    if not (queries.is_contiguous() and supports.is_contiguous()
            and s_mask.is_contiguous()):
        raise ValueError("nn_min kernel takes contiguous tensors")
    from apr_torch.kernels.build import load

    fn = load("nn_min").apr_nn_min
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, nq = queries.shape[:2]
    ns = supports.shape[1]
    d2 = torch.empty((b, nq), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, nq), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(queries.data_ptr(), supports.data_ptr(), s_mask.data_ptr(),
                 d2.data_ptr(), idx.data_ptr(), b, nq, ns, stream)
    if err != 0:
        raise RuntimeError(f"nn_min kernel launch failed: CUDA error {err}")
    if b > 0 and nq > 0:
        nn_min.launches += 1
    return d2, idx


def nn_min(queries: torch.Tensor, supports: torch.Tensor,
           s_mask: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min sqdist float32 [B, Nq], argmin idx int32 [B, Nq]); see the
    module docstring for the contract."""
    if s_mask is None:
        s_mask = torch.ones(supports.shape[:2], dtype=torch.bool,
                            device=supports.device)
    _check(queries, supports, s_mask)
    if queries.device.type == "cpu":
        return nn_min_plain(queries, supports, s_mask)
    if queries.device.type == "cuda":
        return _launch(queries, supports, s_mask)
    raise ValueError(f"nn_min has no path for {queries.device}")


nn_min.launches = 0


def directed_backward(queries, supports, resolved, idx, nq, g):
    """Gradients of a per-cloud masked mean of NN squared distances: the
    argmin support is re-gathered (no distance tile is saved) and the
    support side is a scatter-add.  ``resolved`` [B, Nq] marks the queries
    that carry gradient, ``nq`` [B] the per-cloud divisors, ``g`` [B]."""
    b, n_s = supports.shape[:2]
    safe = idx.clamp(0, max(n_s - 1, 0)).long()
    nn_pts = torch.gather(supports, 1, safe[..., None].expand(-1, -1, 3))
    diff = torch.where(resolved[..., None], queries - nn_pts, 0.0)
    dq = (2.0 * g / nq)[:, None, None] * diff
    offs = torch.arange(b, device=idx.device)[:, None] * n_s
    ds = torch.zeros((b * n_s, 3), dtype=supports.dtype,
                     device=supports.device)
    ds.index_add_(0, (safe + offs).reshape(-1), -dq.reshape(-1, 3))
    return dq, ds.reshape(b, n_s, 3)


def masked_mean(d2: torch.Tensor, q_mask: torch.Tensor):
    """(sum of d2 over valid queries / max(count, 1), that divisor), per
    cloud."""
    nq = torch.clamp(q_mask.to(d2.dtype).sum(dim=1), min=1.0)
    return torch.where(q_mask, d2, 0.0).sum(dim=1) / nq, nq


class DirectedMeanSqNNPallas(torch.autograd.Function):
    """Per cloud, the masked mean over queries of the squared distance to
    the nearest valid support, through kernel K2; the backward masks with
    ``(idx < Ns) & q_mask`` as the Pallas VJP does (distance.py:151)."""

    @staticmethod
    def forward(ctx, queries, supports, q_mask, s_mask):
        d2, idx = nn_min(queries.contiguous(), supports.contiguous(),
                         s_mask.contiguous())
        val, nq = masked_mean(d2, q_mask)
        ctx.save_for_backward(queries, supports, q_mask, idx, nq)
        return val

    @staticmethod
    def backward(ctx, g):
        queries, supports, q_mask, idx, nq = ctx.saved_tensors
        resolved = (idx < supports.shape[1]) & q_mask
        dq, ds = directed_backward(queries, supports, resolved, idx, nq, g)
        return dq, ds, None, None


def directed_mean_sq_nn_pallas(queries, supports, q_mask, s_mask):
    """[B] masked mean of min squared NN distances (kernel K2 forward)."""
    return DirectedMeanSqNNPallas.apply(queries, supports, q_mask, s_mask)


def chamfer_distance_pallas(a, b, a_mask=None, b_mask=None):
    """[B] bidirectional Chamfer (reference normalization) per cloud of
    a [B, Na, 3] and b [B, Nb, 3], through kernel K2."""
    if a_mask is None:
        a_mask = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    if b_mask is None:
        b_mask = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
    return (directed_mean_sq_nn_pallas(a, b, a_mask, b_mask)
            + directed_mean_sq_nn_pallas(b, a, b_mask, a_mask))
