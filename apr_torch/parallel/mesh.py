"""One process per device: the data-parallel mesh (port of
``apr_tpu/parallel/mesh.py``).

In the reference one controller drives every device of a 1-D
``Mesh(('data',))``: pairs shard along the leading batch axis, parameters
replicate, and GSPMD inserts the collectives, so an R-device step computes
the same function as a one-device step on the whole batch.  Here each
device has its own process in a ``torch.distributed`` process group; each
rank holds replicated parameters and its slice of the batch, and the
trainers call the collectives that GSPMD would insert
(:mod:`apr_torch.parallel.collectives`).

The backend is NCCL for CUDA devices and gloo for the CPU.  NCCL refuses
two ranks on one card, so several ranks that share a card use gloo, which
takes CUDA tensors in ``all_reduce``, ``broadcast`` and ``all_gather``
(the only collectives the port calls).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apr_torch.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(eq=False)
class Mesh:
    """A 1-D data-parallel mesh: this process's ``rank`` among ``size``
    members (global ranks ``ranks``), its ``device``, the process ``group``
    (None for the default group) and the axis name.  ``member`` is false
    on a rank outside the mesh, which takes part in no collective of it.

    ``timings``, when a dict, collects the seconds of each collective by
    kind (each one synchronised on the device before and after)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    ranks: Sequence[int] = ()
    axis: str = "data"
    backend: str = "gloo"
    member: bool = True
    timeout: datetime.timedelta = DEFAULT_TIMEOUT
    timings: Optional[Dict[str, float]] = field(default=None, repr=False)

    @property
    def src(self) -> int:
        """The global rank of the mesh's first member."""
        return self.ranks[0]

    def barrier(self) -> None:
        """Wait for every member (an all-reduce: gloo's barrier takes no
        CUDA tensor, NCCL's needs the device set)."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def split(self, ranks: Sequence[int]) -> "Mesh":
        """The mesh over ``ranks`` (global ranks) of this one.  Its members
        must call it, with the same ranks; on any other rank it returns a
        mesh that is not a member."""
        ranks = [int(r) for r in ranks]
        me = dist.get_rank()
        group = (dist.new_group(ranks, timeout=self.timeout,
                                backend=self.backend,
                                use_local_synchronization=True)
                 if me in ranks else None)
        return Mesh(rank=ranks.index(me) if me in ranks else -1,
                    size=len(ranks), device=self.device, group=group,
                    ranks=tuple(ranks), axis=self.axis,
                    backend=self.backend, member=me in ranks,
                    timeout=self.timeout)


def rank_device(devices, rank: int) -> torch.device:
    """This rank's device: ``devices[rank]`` of a list, or for one name
    ``"cuda"`` the card ``LOCAL_RANK`` (else ``rank``) modulo the cards
    present; any other single name (``"cpu"``, ``"cuda:0"``) as given.
    Raises for CUDA without a card."""
    if devices is None:
        devices = "cuda"
    if not isinstance(devices, (str, torch.device)):
        devices = list(devices)
        return resolve_device(devices[rank % len(devices)])
    dev = resolve_device(devices)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(devices=None, axis: str = "data",
              backend: Optional[str] = None, *, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The mesh over every process of the group, joining or creating it.

    An initialized default group is used as it is.  Otherwise the group is
    created from ``rank``, ``world_size`` and ``init_method`` (a
    ``file://`` path the ranks share, say), or from the launcher's
    environment (``torchrun``'s ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR``), or, with neither, as a world of one.  ``devices``
    names this rank's device (:func:`rank_device`); the default is the
    card, and a CUDA mesh without a card raises.  The backend is NCCL on
    CUDA and gloo on the CPU unless ``backend`` names one."""
    if rank is not None and world_size is not None and (
            not 0 <= rank < world_size):
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        if world_size is None:
            world_size = int(os.environ.get("WORLD_SIZE", 1))
    else:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    dev = rank_device(devices, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = dict(backend=backend, rank=rank, world_size=world_size,
                  timeout=timeout)
        if init_method is not None:
            kw["init_method"] = init_method
        elif "MASTER_ADDR" in os.environ:
            kw["init_method"] = "env://"
        elif world_size == 1:
            kw["store"] = dist.HashStore()
        else:
            raise ValueError(f"a world of {world_size} needs an init_method "
                             f"or the launcher's MASTER_ADDR")
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(**kw)
    return Mesh(rank=rank, size=world_size, device=dev, group=None,
                ranks=tuple(range(world_size)), axis=axis,
                backend=dist.get_backend(), timeout=timeout)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of every [B, ...] leaf (tensor or numpy array) of
    a tree of tuples, NamedTuples, lists and dicts; 0-d leaves and other
    values stay as they are.  ``B % mesh.size != 0`` raises, as GSPMD's
    sharding does."""
    def cut(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
            return x
        b = x.shape[0]
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not divide into "
                             f"{mesh.size} shards")
        k = b // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k]

    return tree_map(cut, batch)


def tree_map(fn, tree):
    """``fn`` over every leaf of a tree of tuples, NamedTuples, lists and
    dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, x) for x in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a tree of tuples, NamedTuples, lists and dicts, in
    order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def broadcast_tensors_(tensors, mesh: Mesh, src: Optional[int] = None
                       ) -> None:
    """Broadcast each tensor in place from the mesh's first member (or
    global rank ``src``); bool tensors travel as uint8 (gloo has no bool)."""
    src = mesh.src if src is None else src
    for t in tensors:
        # the collectives send a tensor's storage as it lies: a strided
        # view (a transposed kernel map, an expanded mask) travels as a
        # dense copy; NCCL moves device memory only, so a host tensor
        # (Adam's step count) travels through the mesh's device
        staged = (t.dtype == torch.bool or not t.is_contiguous() or (
            mesh.backend == "nccl" and t.device.type != "cuda"))
        if not staged:
            dist.broadcast(t.data, src, group=mesh.group)
            continue
        dev = mesh.device if mesh.backend == "nccl" else t.device
        u = t.to(device=dev, dtype=torch.uint8 if t.dtype == torch.bool
                 else t.dtype, memory_format=torch.contiguous_format,
                 copy=True)
        dist.broadcast(u, src, group=mesh.group)
        if dist.get_rank() != src:
            t.copy_(u)


def broadcast_object(obj, mesh: Mesh, src: Optional[int] = None):
    """A picklable host object from the mesh's first member (or ``src``)
    to every member."""
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.src if src is None else src,
                               group=mesh.group, device=mesh.device
                               if mesh.backend == "nccl" else None)
    return box[0]


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Make ``obj`` equal on every member to the mesh's first member: a
    trainer (its modules' parameters and buffers, the optimizer's state,
    the gradient accumulation, step and learning rate) or a module (its
    parameters and buffers).  Every member must call it."""
    if isinstance(obj, torch.nn.Module):
        broadcast_tensors_(list(obj.parameters()) + list(obj.buffers()),
                           mesh)
        return obj
    for m in obj.modules():
        replicate(m, mesh)
    params = obj.parameters()
    state = obj.optimizer.state
    # the optimizer's per-parameter state: the first member's keys, shapes
    # and non-tensor values; members that lack an entry allocate it
    spec = broadcast_object(
        [{k: ((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
               else v) for k, v in state.get(p, {}).items()}
         for p in params], mesh)
    for p, entries in zip(params, spec):
        for k, v in entries.items():
            if not (isinstance(v, tuple) and len(v) == 2
                    and isinstance(v[1], torch.dtype)):
                state[p][k] = v
                continue
            shape, dtype = v
            cur = state[p].get(k)
            if not (isinstance(cur, torch.Tensor)
                    and tuple(cur.shape) == shape and cur.dtype == dtype):
                # a 0-d entry (Adam's step) lives on the host, the moments
                # beside their parameter
                state[p][k] = torch.zeros(shape, dtype=dtype, device=(
                    p.device if shape else torch.device("cpu")))
            broadcast_tensors_([state[p][k]], mesh)
    acc = obj.accumulation
    broadcast_tensors_(acc.grads, mesh)
    step, lr, mini = broadcast_object(
        (obj.step, obj.lr, acc.mini_step), mesh)
    obj.step, acc.mini_step = step, mini
    obj._set_group_lr(lr)
    return obj


_SEED_RANGE = 2**31 - 2**20    # base + i stays a 31-bit seed for i < 2**20


def pair_generators(generator: Optional[torch.Generator], n: int):
    """The per-pair generators of a group of ``n`` pairs: one draw from
    ``generator`` (the group's split of the step's draws), then pair i's
    own generator on the same device, seeded from that draw and i.  Every
    rank of a mesh draws the same ones and uses its own pairs'; with no
    ``generator``, every pair draws from torch's default one (None)."""
    if generator is None:
        return [None] * n
    base = int(torch.randint(0, _SEED_RANGE, (1,), generator=generator,
                             device=generator.device))
    return [torch.Generator(device=generator.device).manual_seed(base + i)
            for i in range(n)]

