"""Padded fixed-capacity neighbour search (kNN and radius) over a leading
batch of clouds: the port of ``apr_tpu/ops/neighbors.py``.

Missing neighbours hold the sentinel index ``Ns`` (the number of supports),
which the KPConv layers treat as a zero-feature shadow point.  Radius
neighbours are distance-sorted, then truncated to the cap, and ties go to
the lower index, as ``lax.top_k`` orders them: the selection sorts a
composite key (the distance's bits above the index), so the order of equal
distances is fixed, where ``torch.topk`` leaves it open.

The brute-force searches run in chunks of queries so that no [Nq, Ns]
tensor is held at once; the windowed search scores each tile of
cell-key-sorted queries against one contiguous window of sorted supports.

On a card, 3-D float32 points and k <= ``K3_MAX_K`` select through kernel
K3 (``apr_torch/csrc/radius_select.cu``, :func:`radius_select`): the
distances of the plain version's bits, each query's running list of its k
best candidates on chip, the same tables.  Every other search (feature
points, ``calibrate_neighbors``' histogram cap, the CPU) runs the plain
torch chain, the version the kernel is held to.  ``radius_select.
launches`` counts K3 launches and ``radius_select.plain_cuda`` the searches
of CUDA tensors that stayed on the plain chain by their shape, from every
thread.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from apr_torch.ops.chamfer_window import _INVALID, _OFFSET, _SLAB_SHIFT, \
    _slab_key, sort_cloud

# elements of a [.., Q, S] distance block held at once (the int64 selection
# key doubles it): 2^24 is 64 MiB of float32
_BLOCK_ELEMS = 1 << 24


def _pad_len(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _r2(radius: float) -> float:
    """float32(radius)^2 rounded to float32, as the reference squares its
    float32 radius; a float32 tensor compared with it casts it exactly."""
    r = np.float32(radius)
    return float(r * r)


def _above(r2: float) -> float:
    """The float32 next above ``r2``: for a float32 d2, ``d2 < _above(r2)``
    is ``d2 <= r2`` (kernel K3's one bound)."""
    return float(np.nextafter(np.float32(r2), np.float32(np.inf)))


def sq_norm(*diffs: torch.Tensor) -> torch.Tensor:
    """float32 ``d0^2 + d1^2 + ...`` of per-coordinate differences, rounded
    as the reference's compiled program rounds it: the sum contracts into
    fused multiply-adds, ``fma(d2, d2, fma(d1, d1, d0 * d0))`` (the
    reference's ``sum(diff * diff, -1)`` is ``sq_norm(dx, dy, dz)``).
    Each fused step is one float64 multiply-add (the product of two
    float32 values is exact in float64) rounded once to float32, so the
    card and the CPU give the same bits.  Neighbour tables hang on these
    bits: voxel barycenters often lie within an ulp of a tie.

    Both contraction orders (this one and the window body's, see
    :func:`windowed_radius_neighbors`) are what XLA's CPU compiler of
    jax / jaxlib 0.9.0 emits; ``tests/test_torch_neighbors.py::
    test_reference_contraction_order`` fails by name if a jax upgrade
    changes them."""
    acc = diffs[0] * diffs[0]
    for d in diffs[1:]:
        d = d.double()
        acc = torch.addcmul(acc.double(), d, d).float()
    return acc


def _pairwise_sqdist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., Q, S] of q [..., Q, D] and s [..., S, D]:
    exact per-coordinate differences for D <= 4 (coordinates: the matmul
    expansion cancels at LiDAR range), the expansion at full float32 for
    features (TF32 is off)."""
    if q.shape[-1] <= 4:
        return sq_norm(*(q[..., :, None, c] - s[..., None, :, c]
                         for c in range(q.shape[-1])))
    qq = (q * q).sum(-1)[..., :, None]
    ss = (s * s).sum(-1)[..., None, :]
    d2 = qq - 2.0 * torch.matmul(q, s.transpose(-1, -2)) + ss
    return torch.clamp(d2, min=0.0)


def _smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(values, positions) of the k smallest entries of each row of the
    non-negative d2 [..., W], ascending, ties to the lower position
    (``lax.top_k(-d2, k)``'s order).  A non-negative float32 orders as its
    bit pattern, so ``bits << 32 | position`` is a unique int64 key."""
    w = d2.shape[-1]
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)   # -0.0 -> +0.0
    pos = torch.arange(w, dtype=torch.int64, device=d2.device)
    key = torch.topk((bits << 32) | pos, k, dim=-1, largest=False,
                     sorted=True).values
    idx = key & 0xFFFFFFFF
    return torch.gather(d2, -1, idx), idx


# --- kernel K3 --------------------------------------------------------------

K3_MAX_K = 64           # csrc/radius_select.cu: kMaxK
_count_lock = threading.Lock()


def _takes_k3(points: torch.Tensor, k: int) -> bool:
    """Whether a search over points [B, N, D] for k neighbours runs kernel
    K3: 3-D float32 points on a card, 1 <= k <= ``K3_MAX_K``."""
    return (points.is_cuda and points.shape[-1] == 3
            and points.dtype == torch.float32 and 1 <= k <= K3_MAX_K)


def _count(name: str) -> None:
    """One more in ``radius_select.<name>``, exact when several threads
    search (a loader's producer thread builds batches)."""
    with _count_lock:
        setattr(radius_select, name, getattr(radius_select, name) + 1)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(queries, supports, q_mask, s_mask, lo, hi, idx, d2, bound,
            yx, tile, window):
    """``apr_radius_select`` on contiguous tensors of one card; fills idx
    (and d2 unless None) in place."""
    from apr_torch.kernels.build import load

    fn = load("radius_select").apr_radius_select
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    b, nq, k = idx.shape
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(_ptr(queries), _ptr(supports), _ptr(q_mask), _ptr(s_mask),
                 _ptr(lo), _ptr(hi), _ptr(idx), _ptr(d2), b, nq,
                 supports.shape[1], k, bound, int(yx), tile, window, stream)
    if err != 0:
        raise RuntimeError(f"radius_select kernel launch failed: CUDA error "
                           f"{err}")


def radius_select(queries: torch.Tensor, supports: torch.Tensor, k: int,
                  bound: float, q_mask: Optional[torch.Tensor] = None,
                  s_mask: Optional[torch.Tensor] = None,
                  window: Optional[Tuple[torch.Tensor, torch.Tensor, int,
                                         int]] = None,
                  yx: bool = False, with_d2: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel K3: per query of queries [B, Nq, 3], the positions of its k
    nearest candidates among supports [B, Ns, 3] whose squared distance is
    below ``bound``, ascending by (d2, position), padded with Ns, as idx
    int32 [B, Nq, k], and their d2 float32 (padded with +inf) unless
    ``with_d2`` is False.  Queries that ``q_mask`` leaves out get (Ns, inf).

    Brute mode (``window`` None): every support that ``s_mask`` keeps, in
    the order of ``sq_norm(dx, dy, dz)``.  Windowed mode: ``window`` is
    (lo, hi [B, ceil(Nq / tile)] int32, tile, size); the queries of tile t
    see positions [lo, lo + size) below hi; ``yx`` takes the window body's
    ``sq_norm(dy, dx, dz)``.  Callers dispatch here through
    :func:`_takes_k3`."""
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    dev = queries.device
    if (supports.dtype != queries.dtype or supports.dim() != 3
            or supports.shape[::2] != queries.shape[::2]
            or supports.device != dev
            or any(m is not None and (m.dtype != torch.bool
                                      or tuple(m.shape) != (b, n)
                                      or m.device != dev)
                   for m, n in ((q_mask, nq), (s_mask, ns)))):
        raise ValueError(
            f"radius_select takes supports [B, Ns, 3] like queries "
            f"{tuple(queries.shape)} {queries.dtype} and bool masks [B, Nq], "
            f"[B, Ns] on {dev}; got supports {tuple(supports.shape)} "
            f"{supports.dtype} on {supports.device}")
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=dev)
    d2 = (torch.empty((b, nq, k), dtype=torch.float32, device=dev)
          if with_d2 else None)
    lo, hi, tile, size = window if window is not None else (None, None, 0, 0)

    def dense(t):
        return None if t is None else t.contiguous()

    _launch(queries.contiguous(), supports.contiguous(), dense(q_mask),
            dense(s_mask), dense(lo), dense(hi), idx, d2, bound, yx, tile,
            size)
    _count("launches")
    return idx, d2


radius_select.launches = 0
radius_select.plain_cuda = 0


# --- the searches ------------------------------------------------------------

def knn(queries: torch.Tensor, supports: torch.Tensor, k: int,
        q_mask: Optional[torch.Tensor] = None,
        s_mask: Optional[torch.Tensor] = None,
        chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest supports of each query, per cloud of queries [B, Nq, D]
    and supports [B, Ns, D].

    Returns (idx int32 [B, Nq, k], sqdist float32 [B, Nq, k]) ascending by
    distance; masked queries and missing neighbours hold (Ns, inf).
    ``chunk`` queries per pass of the plain chain (default: a fixed element
    budget).
    """
    if _takes_k3(queries, k):
        return radius_select(queries, supports, k, float("inf"), q_mask,
                             s_mask)
    if queries.is_cuda:
        _count("plain_cuda")
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    dev = queries.device
    if q_mask is None:
        q_mask = torch.ones((b, nq), dtype=torch.bool, device=dev)
    k_eff = min(k, ns)
    if chunk is None:
        chunk = max(1, _BLOCK_ELEMS // max(b * ns, 1))
    idx_parts, d2_parts = [], []
    for q0 in range(0, nq, chunk):
        d2 = _pairwise_sqdist(queries[:, q0:q0 + chunk], supports)
        if s_mask is not None:
            d2 = torch.where(s_mask[:, None, :], d2, float("inf"))
        vals, idx = _smallest_k(d2, k_eff)
        d2_parts.append(vals)
        idx_parts.append(idx)
    d2k = torch.cat(d2_parts, 1)
    idx = torch.cat(idx_parts, 1)
    if k_eff < k:  # fewer supports than requested neighbours
        pad = (0, k - k_eff)
        idx = torch.nn.functional.pad(idx, pad, value=ns)
        d2k = torch.nn.functional.pad(d2k, pad, value=float("inf"))
    valid = q_mask[..., None] & torch.isfinite(d2k)
    return (torch.where(valid, idx, ns).to(torch.int32),
            torch.where(valid, d2k, float("inf")))


def radius_neighbors(queries: torch.Tensor, supports: torch.Tensor,
                     radius: float, cap: int,
                     q_mask: Optional[torch.Tensor] = None,
                     s_mask: Optional[torch.Tensor] = None,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """All supports within ``radius`` of each query, distance-sorted and
    truncated to ``cap``: idx int32 [B, Nq, cap], padded with Ns (the
    sorted nanoflann radius search plus the per-layer cap)."""
    if _takes_k3(queries, cap):
        return radius_select(queries, supports, cap, _above(_r2(radius)),
                             q_mask, s_mask, with_d2=False)[0]
    ns = supports.shape[1]
    idx, d2 = knn(queries, supports, cap, q_mask, s_mask, chunk)
    return torch.where(d2 <= _r2(radius), idx, ns).to(torch.int32)


def windowed_radius_neighbors(
    queries: torch.Tensor,
    supports: torch.Tensor,
    radius: float,
    cap: int,
    q_mask: Optional[torch.Tensor] = None,
    s_mask: Optional[torch.Tensor] = None,
    tile: int = 512,
    window: int = 2560,
    with_overflow: bool = False,
):
    """:func:`radius_neighbors` over cell-key-sorted contiguous windows.

    Queries and supports are sorted by x-major cell key (cell = ``radius``);
    every support within ``radius`` of a query lies in x-cells [cx - 1,
    cx + 1], one contiguous key range, so each tile of sorted queries
    scores one window of ``window`` consecutive sorted supports.  Exact
    whenever each tile's slab holds at most ``window`` supports; an
    overflowing slab truncates its largest-x candidates.  Ties go to the
    lower position in the SORTED window.  ``with_overflow=True`` also
    returns the fraction of query tiles whose slab overflowed, per cloud
    [B].  The reference's three k-smallest strategies (its
    ``select_method``) give one and the same table; this is
    :func:`_smallest_k`, or kernel K3 in windowed mode (see the module
    docstring).
    """
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    dev = queries.device
    if q_mask is None:
        q_mask = torch.ones((b, nq), dtype=torch.bool, device=dev)
    window = min(window, ns)
    # keep >= 32 tiles so no tile's x-range drags a wide slab past the window
    tile = max(64, min(tile, _pad_len(nq, 64) // 32))
    q = sort_cloud(queries, q_mask, radius, pad=0)
    s = sort_cloud(supports, s_mask, radius, pad=window)

    qvalid = q.keys != _INVALID
    qcx = (q.keys >> _SLAB_SHIFT) - _OFFSET
    nq_p = -(-nq // tile) * tile
    n_t = nq_p // tile

    def tiles(v, fill):
        return torch.nn.functional.pad(v[:, :nq], (0, nq_p - nq),
                                       value=fill).reshape(b, n_t, tile)

    qv_t = tiles(qvalid, False)
    big = _INVALID // 2
    qcx_t = tiles(torch.where(qvalid, qcx, big), big)
    cx_lo = torch.where(qv_t, qcx_t, big).amin(dim=2)
    cx_hi = torch.where(qv_t, qcx_t, -big).amax(dim=2)
    lo = torch.searchsorted(s.keys, _slab_key(cx_lo - 1), out_int32=True)
    hi = torch.searchsorted(s.keys, _slab_key(cx_hi + 2), out_int32=True)

    r2 = _r2(radius)
    # the reference's ``dx*dx + dy*dy + dz*dz`` compiles to
    # fma(dz, dz, fma(dx, dx, dy * dy)), another order than its sum: both
    # branches take sq_norm(dy, dx, dz)
    if _takes_k3(queries, cap):
        sidx = radius_select(
            torch.stack((q.x, q.y, q.z), -1),
            torch.stack((s.x[:, :ns], s.y[:, :ns], s.z[:, :ns]), -1), cap,
            _above(r2), qvalid, window=(lo, hi, tile, window), yx=True,
            with_d2=False)[0]
    else:
        if queries.is_cuda:
            _count("plain_cuda")
        qx_t, qy_t, qz_t = (tiles(v, 0.0) for v in (q.x, q.y, q.z))
        k_eff = min(cap, window)
        offs = torch.arange(window, dtype=torch.int32, device=dev)
        chunk = max(1, _BLOCK_ELEMS // max(b * tile * window, 1))
        parts = []
        for t0 in range(0, n_t, chunk):
            t1 = min(n_t, t0 + chunk)
            tlo, thi = lo[:, t0:t1], hi[:, t0:t1]
            pos = tlo[..., None] + offs                   # [B, c, window]
            flat = pos.long().reshape(b, -1)

            def win(plane):
                return torch.gather(plane, 1, flat).reshape(
                    pos.shape)[:, :, None]

            dx = qx_t[:, t0:t1, :, None] - win(s.x)
            dy = qy_t[:, t0:t1, :, None] - win(s.y)
            dz = qz_t[:, t0:t1, :, None] - win(s.z)
            d2 = sq_norm(dy, dx, dz)                      # [B, c, tile, win]
            keep = (pos < thi[..., None])[:, :, None, :] & (d2 <= r2)
            d2 = torch.where(keep, d2, float("inf"))
            vals, widx = _smallest_k(d2, k_eff)
            found = torch.isfinite(vals) & qv_t[:, t0:t1, :, None]
            parts.append(torch.where(
                found, torch.clamp(tlo[..., None, None] + widx, max=ns), ns))
        sidx = torch.cat(parts, 1).reshape(b, nq_p, k_eff)[:, :nq]
        if k_eff < cap:
            sidx = torch.nn.functional.pad(sidx, (0, cap - k_eff), value=ns)
    # sorted-support positions -> original indices; query rows unsorted
    s_order_pad = torch.cat(
        [s.order, torch.full((b, 1), ns, dtype=s.order.dtype, device=dev)], 1)
    rows = torch.gather(s_order_pad, 1,
                        sidx.reshape(b, -1).long()).reshape(b, nq, cap)
    out = torch.full((b, nq, cap), ns, dtype=torch.int32, device=dev)
    out.scatter_(1, q.order[..., None].expand(-1, -1, cap),
                 rows.to(torch.int32))
    out = torch.where(q_mask[..., None], out, ns)
    if with_overflow:
        return out, ((hi - lo) > window).float().mean(dim=1)
    return out
