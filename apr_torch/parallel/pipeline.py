"""Builder / trainer split: the batch build of step i+1 overlaps step i on
other devices (port of ``apr_tpu/parallel/pipeline.py``).

The last ``n_builders`` ranks of the mesh build batches; the others train,
data parallel over their own mesh.  For each raw batch (the nine padded
[B, ...] arrays of ``collate_raw``, the same on every rank), the builders
build their slices of batch i+1 while the trainers step on batch i; each
builder then broadcasts its built slice to every rank (a collective that
gloo takes CUDA tensors in), and each trainer keeps its own slice of the
global batch.  Each pair's build is its own, so the trainers step on the
batch that serial data parallelism would have built.

When does the split pay?  With equal devices and a build that shards
perfectly, it does not for throughput: serial DP gives n / (b + s) batches
per second, a t-trainer / k-builder split t / s when the builders keep up
(k >= t b / s), and t / s > n / (b + s) needs t b > k s: the two meet only
at equality.  It pays when builders are another resource, or the build
does not shard.  So it is opt-in (``config.mesh_n_builders``), as in the
reference.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from apr_torch.parallel.mesh import Mesh, broadcast_object, \
    broadcast_tensors_, make_mesh, shard_batch, tree_leaves, tree_map


def _spec(tree):
    """The tree with each tensor leaf replaced by (shape, dtype)."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def _is_spec(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def _empty_like_spec(spec, device):
    if _is_spec(spec):
        return torch.empty(spec[0], dtype=spec[1], device=device)
    if isinstance(spec, dict):
        return {k: _empty_like_spec(v, device) for k, v in spec.items()}
    if isinstance(spec, (tuple, list)):
        items = [_empty_like_spec(x, device) for x in spec]
        return (type(spec)(*items) if hasattr(spec, "_fields")
                else type(spec)(items))
    return spec


def _concat(trees):
    """Trees of one structure -> one tree, leaves concatenated on dim 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    if isinstance(first, dict):
        return {k: _concat([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        items = [_concat(list(xs)) for xs in zip(*trees)]
        return (type(first)(*items) if hasattr(first, "_fields")
                else type(first)(items))
    return first


class BuilderTrainerPipeline:
    """Build on the last ``n_builders`` ranks of ``mesh`` (default: the
    launcher's group) while the others train.

    ``trainer`` needs ``build_batch(raw)``, ``train_step(batch,
    generator)`` and ``use_mesh(mesh)``; the trainer ranks call
    ``use_mesh(train_mesh)`` here.  Every rank of ``mesh`` constructs the
    pipeline and calls :meth:`run` with the same raw batches, whose batch
    size divides both the builders' and the trainers' counts.
    """

    def __init__(self, trainer, n_builders: int,
                 mesh: Optional[Mesh] = None):
        mesh = mesh or make_mesh()
        if not 0 < n_builders < mesh.size:
            raise ValueError(
                f"n_builders={n_builders} needs 1..{mesh.size - 1} "
                f"of {mesh.size} devices")
        self.trainer = trainer
        self.mesh = mesh
        n_train = mesh.size - n_builders
        self.train_mesh = mesh.split(mesh.ranks[:n_train])
        self.build_mesh = mesh.split(mesh.ranks[n_train:])
        self.is_builder = self.build_mesh.member
        if not self.is_builder:
            trainer.use_mesh(self.train_mesh)

    def build(self, raw):
        """On a builder: the build of its slice of ``raw``; elsewhere
        None."""
        if not self.is_builder:
            return None
        return self.trainer.build_batch(shard_batch(raw, self.build_mesh))

    def to_trainers(self, built):
        """Every builder broadcasts its built slice to every rank (in
        builder order); a trainer returns its own slice of the global
        batch, a builder None.  Every rank of the mesh calls it."""
        parts = []
        for src in self.build_mesh.ranks:
            spec = broadcast_object(
                _spec(built) if self.mesh.ranks[self.mesh.rank] == src
                else None, self.mesh, src=src)
            part = (built if self.mesh.ranks[self.mesh.rank] == src
                    else _empty_like_spec(spec, self.mesh.device))
            broadcast_tensors_([t for t in tree_leaves(part)
                                if isinstance(t, torch.Tensor)],
                               self.mesh, src=src)
            parts.append(part)
        if self.is_builder:
            return None
        return shard_batch(_concat(parts), self.train_mesh)

    def run(self, raw_batches: Iterable,
            generator: Optional[torch.Generator] = None,
            on_metrics: Optional[Callable] = None):
        """The steady state: for each raw batch, the builders build batch
        i+1 while the trainers step on batch i, then the hand-off; the last
        batch is stepped after the loop.  Returns the trainer (updated in
        place on the trainer ranks)."""
        built, have = None, False
        for raw in raw_batches:
            nxt = self.build(raw)
            if have and not self.is_builder:
                metrics = self.trainer.train_step(built, generator)
                if on_metrics is not None:
                    on_metrics(metrics)
            built, have = self.to_trainers(nxt), True
        if have and not self.is_builder:
            metrics = self.trainer.train_step(built, generator)
            if on_metrics is not None:
                on_metrics(metrics)
        return self.trainer
