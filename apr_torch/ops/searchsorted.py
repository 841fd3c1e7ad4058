"""Batched searchsorted-left for the kernel-map builds (kernel K1).

``searchsorted_left(support [B, S], queries [B, G, C]) -> [B, G, C]`` is
the port of ``apr_tpu/ops/pallas/searchsorted.py::searchsorted_left``,
batched over clouds so one launch serves a kernel map of every cloud of a
batch.  Contract: each support row ascending with INVALID_KEY padding at
its tail; within each query row the entries that are not INVALID_KEY
ascend (holes anywhere are fine).  The result equals
``searchsorted(support[b], queries[b], side='left')``; an INVALID query
gets the count of valid supports.

``searchsorted_left_many`` runs several such searches over the same
clouds, the seven kernel maps of a pyramid build, in one launch.

On a CUDA tensor the wrappers launch the hand-written kernel
``apr_torch/csrc/searchsorted.cu`` (or raise); on a CPU tensor they run
:func:`searchsorted_left_plain`, the same function in plain torch ops.
``searchsorted_left.launches`` counts kernel launches, grouped or single,
from every thread.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import torch


def searchsorted_left_plain(support: torch.Tensor,
                            queries: torch.Tensor) -> torch.Tensor:
    """Vectorised binary search: ceil(log2(S + 1)) steps over all queries
    at once.  The CPU path of :func:`searchsorted_left`, and the version the
    kernel is held against on the card."""
    b, s = support.shape
    g, c = queries.shape[1:]
    q = queries.reshape(b, g * c)
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, s)
    for _ in range(s.bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = torch.gather(support, 1, mid.clamp(max=s - 1)) < q
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo.to(torch.int32).reshape(b, g, c)


def _check(support: torch.Tensor, queries: torch.Tensor) -> None:
    if support.dtype != torch.int32 or queries.dtype != torch.int32:
        raise TypeError(f"searchsorted_left takes int32 keys, got "
                        f"{support.dtype} and {queries.dtype}")
    if (support.dim() != 2 or queries.dim() != 3
            or support.shape[0] != queries.shape[0]):
        raise ValueError(f"want support [B, S] and queries [B, G, C], got "
                         f"{tuple(support.shape)} and {tuple(queries.shape)}")
    if support.device != queries.device:
        raise ValueError(f"support on {support.device}, queries on "
                         f"{queries.device}")


MAX_SEARCHES = 8   # descriptors one launch carries (csrc/searchsorted.cu)
_Ptrs = ctypes.c_void_p * MAX_SEARCHES
_Ints = ctypes.c_int * MAX_SEARCHES
_Counts = ctypes.c_longlong * MAX_SEARCHES
_entry = []        # the loaded C entry point, once per process
_count_lock = threading.Lock()


def _kernel():
    if not _entry:
        from apr_torch.kernels.build import load

        fn = load("searchsorted").apr_searchsorted_left_many
        fn.argtypes = [ctypes.c_int, _Ptrs, _Ptrs, _Ptrs, _Ints, _Counts,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def _launch(searches):
    """One launch of the kernel over up to MAX_SEARCHES (support, queries)
    pairs that share B and a device; the results are views of one buffer."""
    fn = _kernel()
    b, dev = searches[0][0].shape[0], searches[0][0].device
    numels = [q.numel() for _, q in searches]
    flat = torch.empty(sum(numels), dtype=torch.int32, device=dev)
    outs = [o.view(q.shape)
            for o, (_, q) in zip(flat.split(numels), searches)]
    counts = [n // b if b else 0 for n in numels]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(len(searches), _Ptrs(*(s.data_ptr() for s, _ in searches)),
                 _Ptrs(*(q.data_ptr() for _, q in searches)),
                 _Ptrs(*(o.data_ptr() for o in outs)),
                 _Ints(*(s.shape[1] for s, _ in searches)), _Counts(*counts),
                 b, stream)
    if err != 0:
        raise RuntimeError(f"searchsorted_left kernel launch failed: CUDA "
                           f"error {err}")
    if b > 0 and any(counts):
        _count_launch()
    return outs


def _count_launch():
    """One more launch in ``searchsorted_left.launches``, exact when
    several threads launch (a loader's producer thread builds batches)."""
    with _count_lock:
        searchsorted_left.launches += 1


def searchsorted_left_many(searches: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor]]
                           ) -> List[torch.Tensor]:
    """Several searches (support [B, S_i], queries [B, G_i, C_i]) over the
    same B clouds in one launch (one per MAX_SEARCHES); their results in
    order.  On the CPU, the list of :func:`searchsorted_left_plain` calls."""
    searches = list(searches)
    for support, queries in searches:
        _check(support, queries)
    if not searches:
        return []
    dev, b = searches[0][0].device, searches[0][0].shape[0]
    if any(s.device != dev or s.shape[0] != b for s, _ in searches):
        raise ValueError("searchsorted_left_many takes searches over the "
                         "same clouds on one device")
    if dev.type == "cpu":
        return [searchsorted_left_plain(s, q) for s, q in searches]
    if dev.type != "cuda":
        raise ValueError(f"searchsorted_left has no path for {dev}")
    if not all(s.is_contiguous() and q.is_contiguous() for s, q in searches):
        raise ValueError("searchsorted_left kernel takes contiguous tensors")
    outs = []
    for i in range(0, len(searches), MAX_SEARCHES):
        outs += _launch(searches[i:i + MAX_SEARCHES])
    return outs


def searchsorted_left(support: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """Left insertion points of ``queries`` [B, G, C] in ``support`` [B, S]
    (int32); see the module docstring for the contract.  The grouped entry
    with one search."""
    return searchsorted_left_many([(support, queries)])[0]


searchsorted_left.launches = 0
