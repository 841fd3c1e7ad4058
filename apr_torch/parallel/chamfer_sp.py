"""Sequence-parallel Chamfer: the pairwise reduction sharded across the
mesh (port of ``apr_tpu/parallel/chamfer_sp.py``).

Each directed pass shards its QUERY axis over the mesh: each rank takes
Nq / R queries against a full replica of the supports, computes the local
masked sum of min squared NN distances and its count, and the pair is
all-reduced.  Both directions swap the roles, so a bidirectional Chamfer
costs two sharded passes and two small all-reduces.

The per-shard body is :class:`apr_torch.ops.chamfer.DirectedMeanSqNN`,
the plain torch path (the reference's body is the XLA ``nn_distances``,
not its Pallas kernel).  The inputs and the value are replicated: the
inputs pass through :func:`copy_to_shards`, whose backward sums the ranks'
partial gradients, so every rank gets the whole gradient of every input,
as the single-device Chamfer gives it.

    f = chamfer_distance_sp(mesh)
    cd = f(a, b, a_mask, b_mask)     # a [Na, 3], b [Nb, 3]
"""

from __future__ import annotations

from typing import Optional

import torch

from apr_torch.ops.chamfer import DirectedMeanSqNN
from apr_torch.parallel.collectives import all_reduce_, copy_to_shards, \
    reduce_from_shards


def _directed_sharded(queries, supports, q_mask, s_mask, mesh):
    """This rank's query shard -> (masked sum, count) -> summed over the
    mesh -> the directed mean."""
    n = queries.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} queries do not divide into {mesh.size} "
                         f"shards (pad with masked rows)")
    k = n // mesh.size
    rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
    q, qm = queries[rows], q_mask[rows]
    mean_local = DirectedMeanSqNN.apply(q[None], supports[None], qm[None],
                                        s_mask[None])[0]
    w_local = qm.sum().to(queries.dtype)
    total = reduce_from_shards(mean_local * torch.clamp(w_local, min=1.0),
                               mesh)
    count = all_reduce_(w_local.reshape(1).clone(), mesh)[0]
    return total / torch.clamp(count, min=1.0)


def chamfer_distance_sp(mesh):
    """A mesh-sharded bidirectional Chamfer: f(a, b, a_mask=None,
    b_mask=None) -> the replicated scalar, with a (then b) sharded on the
    query axis in the a->b (b->a) pass.  Every rank passes the whole
    clouds; their row counts must divide the mesh size."""

    def f(a: torch.Tensor, b: torch.Tensor,
          a_mask: Optional[torch.Tensor] = None,
          b_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if a_mask is None:
            a_mask = torch.ones(a.shape[0], dtype=torch.bool,
                                device=a.device)
        if b_mask is None:
            b_mask = torch.ones(b.shape[0], dtype=torch.bool,
                                device=b.device)
        a, b = copy_to_shards(a, mesh), copy_to_shards(b, mesh)
        return (_directed_sharded(a, b, a_mask, b_mask, mesh)
                + _directed_sharded(b, a, b_mask, a_mask, mesh))

    return f
