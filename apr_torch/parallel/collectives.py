"""The collectives that GSPMD inserts implicitly under the reference's
mesh, made explicit for one process per device.

Two autograd functions carry the data-parallel train step:

- :func:`all_reduce_sum`: a SUM over the mesh whose backward is a SUM of
  the incoming gradient.  For a quantity every rank's partial loss reads
  (batch-norm moments): each rank's backward brings the gradient of its
  own loss term, and their sum is the gradient of the global loss.
- :func:`gather_batch`: the members' [b, ...] shards concatenated into the
  global [B, ...] batch, whose backward returns this rank's slice of the
  incoming gradient, with no sum.  For a term every rank computes whole
  and alike (the contrastive loss over the global batch): each rank's
  backward then carries that term's gradient through its own shard only.

Two more serve the sequence-parallel Chamfer, whose inputs are replicated
and whose output is replicated: :func:`reduce_from_shards` (a SUM whose
backward passes the gradient through) and :func:`copy_to_shards` (the
identity whose backward sums the gradient over the mesh).

Every collective goes through ``all_reduce``, ``broadcast`` or
``all_gather``, the three that gloo takes CUDA tensors in; bool tensors
travel as uint8.  With ``mesh.timings`` set, each collective is timed,
synchronised on the device, under its kind.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@contextlib.contextmanager
def timed(mesh, kind: str):
    """Add the seconds of the enclosed collective to ``mesh.timings[kind]``
    (device synchronised on entry and exit) when the mesh collects
    timings; otherwise nothing."""
    if mesh.timings is None:
        yield
        return
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda *_: None))
    sync(mesh.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(mesh.device)
        mesh.timings[kind] = (mesh.timings.get(kind, 0.0)
                              + time.perf_counter() - t0)


def all_reduce_(t: torch.Tensor, mesh, op: str = "sum",
                kind: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of ``t`` over the mesh (no autograd); returns
    ``t``.  A strided ``t`` goes through a dense copy (the collective
    reads the storage as it lies)."""
    dense = t if t.is_contiguous() else t.contiguous()
    with timed(mesh, kind):
        dist.all_reduce(dense, op=_OPS[op], group=mesh.group)
    if dense is not t:
        t.copy_(dense)
    return t


def all_gather_cat(t: torch.Tensor, mesh,
                   kind: str = "gather") -> torch.Tensor:
    """The members' tensors of one shape concatenated along dim 0 in rank
    order (no autograd)."""
    flag = t.dtype == torch.bool
    src = (t.to(torch.uint8) if flag else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    with timed(mesh, kind):
        dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts)
    return out.bool() if flag else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, kind):
        ctx.mesh, ctx.kind = mesh, kind
        return all_reduce_(x.clone(), mesh, kind=kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, kind=ctx.kind), None, None


def all_reduce_sum(x: torch.Tensor, mesh,
                   kind: str = "bn_all_reduce") -> torch.Tensor:
    """SUM over the mesh; the backward sums the incoming gradient over
    the mesh too."""
    return _AllReduceSum.apply(x, mesh, kind)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.b = mesh, x.shape[0]
        return all_gather_cat(x, mesh)

    @staticmethod
    def backward(ctx, g):
        r, b = ctx.mesh.rank, ctx.b
        return g[r * b:(r + 1) * b], None


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch [size * b, ...] from every member's [b, ...]
    shard, in rank order; the backward keeps this rank's slice of the
    gradient."""
    if not x.requires_grad:
        return all_gather_cat(x, mesh)
    return _GatherBatch.apply(x, mesh)


class _ReduceFromShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh), None


def reduce_from_shards(x: torch.Tensor, mesh) -> torch.Tensor:
    """SUM over the mesh of each rank's partial value; the backward passes
    the (replicated) gradient to each partial value as it is."""
    return _ReduceFromShards.apply(x, mesh)


def copy_to_shards(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated input used in part by each rank: the identity, whose
    backward sums the ranks' partial gradients into the whole one."""
    return _CopyToShards.apply(x, mesh)


@torch.no_grad()
def all_reduce_flat_(tensors: List[torch.Tensor], mesh,
                     kind: str = "grad_all_reduce") -> None:
    """SUM every tensor over the mesh in place through one flat buffer per
    dtype (one collective per dtype in place of one per tensor)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce_(flat, mesh, kind=kind)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
