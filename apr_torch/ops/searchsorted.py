"""Batched searchsorted-left for the kernel-map builds (kernel K1).

``searchsorted_left(support [B, S], queries [B, G, C]) -> [B, G, C]`` is
the port of ``apr_tpu/ops/pallas/searchsorted.py::searchsorted_left``,
batched over clouds so one launch serves a kernel map of every cloud of a
batch.  Contract: each support row ascending with INVALID_KEY padding at
its tail; within each query row the entries that are not INVALID_KEY
ascend (holes anywhere are fine).  The result equals
``searchsorted(support[b], queries[b], side='left')``; an INVALID query
gets the count of valid supports.

On a CUDA tensor the wrapper launches the hand-written kernel
``apr_torch/csrc/searchsorted.cu`` (or raises); on a CPU tensor it runs
:func:`searchsorted_left_plain`, the same function in plain torch ops.
``searchsorted_left.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

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


def _launch(support: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    if not (support.is_contiguous() and queries.is_contiguous()):
        raise ValueError("searchsorted_left kernel takes contiguous tensors")
    from apr_torch.kernels.build import load

    fn = load("searchsorted").apr_searchsorted_left
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, s = support.shape
    n = queries.shape[1] * queries.shape[2]
    out = torch.empty_like(queries)
    with torch.cuda.device(support.device):
        stream = torch.cuda.current_stream(support.device).cuda_stream
        err = fn(support.data_ptr(), queries.data_ptr(), out.data_ptr(),
                 b, s, n, stream)
    if err != 0:
        raise RuntimeError(f"searchsorted_left kernel launch failed: CUDA "
                           f"error {err}")
    if b > 0 and n > 0:
        searchsorted_left.launches += 1
    return out


def searchsorted_left(support: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """Left insertion points of ``queries`` [B, G, C] in ``support`` [B, S]
    (int32); see the module docstring for the contract."""
    _check(support, queries)
    if support.device.type == "cpu":
        return searchsorted_left_plain(support, queries)
    if support.device.type == "cuda":
        return _launch(support, queries)
    raise ValueError(f"searchsorted_left has no path for {support.device}")


searchsorted_left.launches = 0
