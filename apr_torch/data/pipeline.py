"""Host-side input pipeline: pad, collate, prefetch, feed the device (port
of ``apr_tpu/data/pipeline.py``).

A background thread reads and pads batch i+1, copies it to the device and
(unless the loop builds batches itself) enqueues its device-side build
while the consumer steps on batch i.  The producer thread enqueues its
work on the stream that was current on the consumer's thread when the
iteration began, so every tensor it hands over is ordered before the
consumer's later work on that stream, with no event.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from apr_torch.config import APRConfig
from apr_torch.data.datasets import PairDataset
from apr_torch.data.synthetic import pad_points
from apr_torch.device import resolve_device
from apr_torch.training.batching import PairBatch, make_pair_batch

THREAD_NAME = "apr_torch-prefetch"


def prefetched(items, produce, prefetch: int = 2, device=None):
    """Generator over ``produce(item)`` for each of ``items``, computed by
    a background thread up to ``prefetch`` items ahead.

    An exception in the producer is raised in the consumer, after the
    items produced before it.  A consumer that stops early (``close()`` or
    garbage collection of the generator) stops the producer thread at its
    next hand-over.  On a CUDA ``device`` the producer runs on the
    consumer's current stream.
    """
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    dev = None if device is None else torch.device(device)
    stream = (torch.cuda.current_stream(dev)
              if dev is not None and dev.type == "cuda" else None)

    def put(item):
        # re-check stop while blocked on the full queue so an abandoned
        # consumer cannot strand this thread (and its prefetched payloads)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                for it in items:
                    if stop.is_set():
                        return
                    if not put(("ok", produce(it))):
                        return
            put(("done", None))
        except Exception as e:  # surface producer errors to the consumer
            put(("err", e))

    t = threading.Thread(target=producer, name=THREAD_NAME, daemon=True)
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "done":
                return
            if kind == "err":
                raise payload
            yield payload
    finally:
        stop.set()


def collate_raw(pairs: Sequence[dict], config: APRConfig, device="cuda"):
    """The nine stacked arrays of a batch of pair dicts (points0, mask0,
    points1, mask1, apc0, apc0_mask, apc1, apc1_mask, t_gt), padded to
    the config's capacities and copied to ``device``: the host's share of
    a batch; the device-side build runs later (``build_batch``)."""
    dev = resolve_device(device)
    cols = [[] for _ in range(9)]
    for d in pairs:
        p0, m0 = pad_points(d["points0"], config.point_capacity)
        p1, m1 = pad_points(d["points1"], config.point_capacity)
        a0, am0 = pad_points(d["apc0"], config.apc_capacity)
        a1, am1 = pad_points(d["apc1"], config.apc_capacity)
        for col, v in zip(cols, (p0, m0, p1, m1, a0, am0, a1, am1,
                                 d["t_gt"].astype(np.float32))):
            col.append(v)
    return tuple(torch.as_tensor(np.stack(c), device=dev) for c in cols)


def collate_pairs(pairs: Sequence[dict], config: APRConfig,
                  point_capacity: Optional[int] = None, capacities=None,
                  device="cuda") -> PairBatch:
    """A batch of pair dicts built on ``device``; ``point_capacity`` /
    ``capacities`` override the config's worst-case buffers (the capacity
    tiers of eval/bucketing.py)."""
    if point_capacity is not None:
        config = config.replace(point_capacity=point_capacity)
    return make_pair_batch(
        *collate_raw(pairs, config, device),
        voxel_size=config.voxel_size,
        capacities=tuple(capacities or config.capacities),
        conv1_kernel_size=config.conv1_kernel_size,
        corr_cap=config.corr_capacity_per_point,
        search_multiplier=config.positive_pair_search_voxel_size_multiplier,
        device=device)


class PairLoader:
    """Iterates built :class:`PairBatch` es (or, with ``raw``, the nine
    collated arrays for the loop's fused build) with background prefetch.
    Each epoch's order is a permutation drawn from ``seed + epoch``.

    With a data-parallel ``mesh`` each batch is this rank's slice of the
    global one.  Every rank still reads every pair of the global batch, in
    the global order: the datasets draw their augmentations from a
    generator advanced per ``get_pair`` (and the walks reseed numpy's
    global one), so a rank that read only its own pairs would draw other
    numbers than the one-process loader.  The ranks' slices together are
    that loader's batch, bit for bit."""

    def __init__(self, dataset: PairDataset, config: APRConfig,
                 batch_size: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, drop_last: bool = True,
                 raw: bool = False, device="cuda", mesh=None):
        self.dataset = dataset
        self.config = config
        self.batch_size = batch_size or config.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.raw = raw
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and self.batch_size % mesh.size:
            raise ValueError(f"a batch of {self.batch_size} does not divide "
                             f"into {mesh.size} shards")
        # capacity-tier batching (config.train_capacity_buckets) groups
        # each epoch's pairs into occupancy tiers, for built batches only
        self.bucket_tiers = 0 if raw else int(
            config.train_capacity_buckets or 0)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _index_order(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self._epoch
                                         ).permutation(n)
        return np.arange(n)

    def _mine(self, pairs):
        """This rank's slice of a global batch's pairs; a ragged last
        batch (``drop_last`` off) that does not divide the mesh stays
        whole, for every rank to run alone."""
        if self.mesh is None or len(pairs) % self.mesh.size:
            return pairs
        k = len(pairs) // self.mesh.size
        return pairs[self.mesh.rank * k:(self.mesh.rank + 1) * k]

    def __iter__(self) -> Iterator:
        order = self._index_order()
        if self.bucket_tiers:
            yield from self._iter_bucketed(order)
            return

        def build(b):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            pairs = self._mine([self.dataset.get_pair(int(i))
                                for i in idxs])
            if self.raw:
                return collate_raw(pairs, self.config, self.device)
            return collate_pairs(pairs, self.config, device=self.device)

        yield from prefetched(range(len(self)), build, self.prefetch,
                              self.device)

    def _iter_bucketed(self, order):
        """Tier-batched epoch: pairs accumulate per capacity tier and a
        batch is emitted when its tier fills, so every batch carries one
        (the smallest fitting) buffer shape.  Leftover pairs go at the
        worst-case tier at epoch end; a final partial batch drops under
        drop_last, as in plain batching."""
        from apr_torch.eval.bucketing import bucket_for_pair

        c = self.config

        def tiered_batches():
            accs = {}
            for i in order:
                pair = self.dataset.get_pair(int(i))
                tier = bucket_for_pair(
                    pair, c.voxel_size, c.capacities, c.point_capacity,
                    max_tiers=self.bucket_tiers)
                accs.setdefault(tier, []).append(pair)
                if len(accs[tier]) == self.batch_size:
                    yield tier, accs.pop(tier)
            rest = [p for tier in list(accs) for p in accs.pop(tier)]
            full = (c.point_capacity, tuple(c.capacities))
            for b in range(0, len(rest), self.batch_size):
                chunk = rest[b:b + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    break
                yield full, chunk

        def build(item):
            (pc, caps), pairs = item
            return collate_pairs(self._mine(pairs), c, point_capacity=pc,
                                 capacities=caps, device=self.device)

        yield from prefetched(tiered_batches(), build, self.prefetch,
                              self.device)
