# Frozen copy of apr_torch/ops/chamfer_window.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Windowed nearest-neighbour distances: the fast Chamfer of the train step
and the GT correspondence search (port of ``apr_tpu/ops/chamfer_window.py``,
per cloud over a leading batch).

1. bucket points on a uniform grid (cell = ``cell_size``) and sort each
   cloud once by x-major packed cell key, so an x-slab is one contiguous key
   range; the sorted views serve both Chamfer directions;
2. walk tiles of sorted queries; each tile's nearest supports lie in the
   key range covering x-cells [tile_min_x - 1, tile_max_x + 1], read as one
   window of ``window`` consecutive sorted supports;
3. brute-force the [tile, window] distances from exact per-coordinate
   differences with a masked min / argmin (ties to the lowest position).

Queries whose nearest found support is farther than ``2 * cell_size``, or
whose window holds no candidate, get the clamped distance
``(2 * cell_size)^2`` with zero gradient.  Tiles run in chunks so that no
[B, tiles, tile, window] tensor is held at once.  Plain torch, no kernel:
the reference is an XLA scan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from reference.aprref.ops.distance import directed_backward
from reference.aprref.ops.hashing import COORD_BITS, pack_coords
from reference.aprref.ops.voxelize import voxel_coords

_SLAB_SHIFT = 2 * COORD_BITS
_OFFSET = (1 << COORD_BITS) // 2
_INVALID = 2**31 - 1
# distance elements per chunk of tiles ([B, chunk, tile, window] floats)
_CHUNK_ELEMS = 1 << 26


class SortedCloud(NamedTuple):
    """Clouds [B, N] sorted by x-major cell key; the coordinate planes are
    padded by ``pad`` zeros so that no window runs past the end."""

    keys: torch.Tensor    # int32 [B, N] sorted cell keys (_INVALID masked)
    x: torch.Tensor       # [B, N + pad]
    y: torch.Tensor
    z: torch.Tensor
    order: torch.Tensor   # int64 [B, N] original index of each sorted row
    n: int


def sort_cloud(points: torch.Tensor, mask: Optional[torch.Tensor],
               cell_size: float, pad: int) -> SortedCloud:
    """Sort clouds points [B, N, 3] by cell key (stable).  The cell is
    ``floor(p * float32(1 / cell_size))``, as the reference's compiled
    program computes ``floor(p / cell_size)`` for a constant cell."""
    b, n = points.shape[:2]
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    key = torch.where(mask, pack_coords(voxel_coords(points, cell_size)),
                      _INVALID)
    keys, order = torch.sort(key, dim=1, stable=True)
    srt = torch.gather(points, 1, order[..., None].expand(-1, -1, 3))
    srt = torch.nn.functional.pad(srt, (0, 0, 0, pad))
    return SortedCloud(keys=keys, x=srt[..., 0], y=srt[..., 1],
                       z=srt[..., 2], order=order, n=n)


def _slab_key(cx: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cx + _OFFSET, 0, (1 << COORD_BITS) - 1) << _SLAB_SHIFT


def _directed_window(q: SortedCloud, s: SortedCloud, cell_size: float,
                     tile: int, window: int):
    """Per-cloud masked mean over valid queries of the windowed NN squared
    distance, the NN's ORIGINAL support index per ORIGINAL query (Ns when
    unresolved), and the valid-query count: ([B], [B, Nq] int32, [B])."""
    b, nq, ns = q.keys.shape[0], q.n, s.n
    dev = q.keys.device
    fallback = (2.0 * cell_size) ** 2
    qvalid = q.keys != _INVALID
    qcx = (q.keys >> _SLAB_SHIFT) - _OFFSET

    nq_p = -(-nq // tile) * tile
    n_t = nq_p // tile

    def tiles(v, fill):
        return torch.nn.functional.pad(v[:, :nq], (0, nq_p - nq),
                                       value=fill).reshape(b, n_t, tile)

    qx_t, qy_t, qz_t = (tiles(v, 0.0) for v in (q.x, q.y, q.z))
    qv_t = tiles(qvalid, False)
    big = _INVALID // 2
    qcx_t = tiles(torch.where(qvalid, qcx, big), big)
    cx_lo = torch.where(qv_t, qcx_t, big).amin(dim=2)
    cx_hi = torch.where(qv_t, qcx_t, -big).amax(dim=2)
    # masked supports carry _INVALID keys (sorted to the tail), so hi
    # excludes them: _slab_key(...) <= (1 << 30) - 1 < _INVALID
    lo = torch.searchsorted(s.keys, _slab_key(cx_lo - 1), out_int32=True)
    hi = torch.searchsorted(s.keys, _slab_key(cx_hi + 2), out_int32=True)

    offs = torch.arange(window, dtype=torch.int32, device=dev)
    chunk = max(1, _CHUNK_ELEMS // max(b * tile * window, 1))
    d2_parts, sidx_parts = [], []
    for t0 in range(0, n_t, chunk):
        t1 = min(n_t, t0 + chunk)
        tlo, thi = lo[:, t0:t1], hi[:, t0:t1]
        pos = (tlo[..., None] + offs).long()              # [B, c, window]
        flat = pos.reshape(b, -1)

        def win(plane):
            return torch.gather(plane, 1, flat).reshape(pos.shape)[:, :, None]

        dx = qx_t[:, t0:t1, :, None] - win(s.x)
        dy = qy_t[:, t0:t1, :, None] - win(s.y)
        dz = qz_t[:, t0:t1, :, None] - win(s.z)
        d2 = dx * dx + dy * dy + dz * dz                  # [B, c, tile, win]
        wvalid = (tlo[..., None] + offs) < thi[..., None]
        d2 = torch.where(wvalid[:, :, None, :], d2, float("inf"))
        best, arg = torch.min(d2, dim=3)
        # no candidate in the window, or the nearest beyond 2 cells:
        # the clamped distance, zero gradient
        unresolved = ~(best < fallback)
        d2_parts.append(torch.where(unresolved, fallback, best))
        sidx_parts.append(torch.where(
            unresolved, ns,
            torch.clamp(tlo[..., None] + arg.to(torch.int32), max=ns)))
    d2_sorted = torch.cat(d2_parts, 1).reshape(b, nq_p)[:, :nq]
    sidx_sorted = torch.cat(sidx_parts, 1).reshape(b, nq_p)[:, :nq]
    s_order_pad = torch.cat(
        [s.order, torch.full((b, 1), ns, dtype=s.order.dtype, device=dev)],
        dim=1)
    idx_sorted = torch.gather(s_order_pad, 1,
                              torch.clamp(sidx_sorted, max=ns).long())

    nvalid = torch.clamp(qvalid.to(d2_sorted.dtype).sum(dim=1), min=1.0)
    mean = torch.where(qvalid, d2_sorted, 0.0).sum(dim=1) / nvalid
    # back to the original query order for the backward gather
    out_idx = torch.full((b, nq), ns, dtype=torch.int32, device=dev)
    out_idx.scatter_(1, q.order,
                     torch.where(qvalid, idx_sorted, ns).to(torch.int32))
    return mean, out_idx, nvalid


def windowed_nn_distances(
    queries: torch.Tensor,              # [B, Nq, 3]
    supports: torch.Tensor,             # [B, Ns, 3]
    q_mask: Optional[torch.Tensor] = None,
    s_mask: Optional[torch.Tensor] = None,
    cell_size: float = 1.2,
    tile: int = 1024,
    window: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sqdist [B, Nq], idx int32 [B, Nq]) of the (near-)nearest support per
    query; idx == Ns and sqdist == (2 * cell_size)^2 for unresolved queries
    (every masked query among them)."""
    b, nq = queries.shape[:2]
    ns = supports.shape[1]
    if q_mask is None:
        q_mask = torch.ones((b, nq), dtype=torch.bool, device=queries.device)
    q = sort_cloud(queries, q_mask, cell_size, pad=0)
    s = sort_cloud(supports, s_mask, cell_size, pad=window)
    _, idx, _ = _directed_window(q, s, cell_size, tile, window)
    safe = idx.clamp(0, ns - 1).long()
    nn_pts = torch.gather(supports, 1, safe[..., None].expand(-1, -1, 3))
    d2 = ((queries - nn_pts) ** 2).sum(dim=-1)
    d2 = torch.where((idx < ns) & q_mask, d2, (2.0 * cell_size) ** 2)
    return d2, idx


class ChamferWindow(torch.autograd.Function):
    """(chamfer [B], clamp fraction [B]) of the windowed Chamfer, with the
    reference's custom backward (chamfer_window.py:236-262); the fraction
    carries no gradient."""

    @staticmethod
    def forward(ctx, a, b, a_mask, b_mask, cell_size, tile, window):
        na, nb = a.shape[1], b.shape[1]
        sa = sort_cloud(a, a_mask, cell_size, pad=window)
        sb = sort_cloud(b, b_mask, cell_size, pad=window)
        mean_ab, idx_ab, n_a = _directed_window(sa, sb, cell_size, tile,
                                                window)
        mean_ba, idx_ba, n_b = _directed_window(sb, sa, cell_size, tile,
                                                window)
        # clamp-hit telemetry: unresolved valid queries carry idx == N_support
        clamped = (torch.where(a_mask, (idx_ab >= nb).float(), 0.0).sum(1)
                   + torch.where(b_mask, (idx_ba >= na).float(), 0.0).sum(1))
        frac = clamped / torch.clamp(n_a + n_b, min=1.0)
        ctx.save_for_backward(a, b, idx_ab, idx_ba, n_a, n_b)
        ctx.mark_non_differentiable(frac)
        return mean_ab + mean_ba, frac

    @staticmethod
    def backward(ctx, g, _g_frac):
        # each direction's gradient on its queries (resolved ones only) and
        # the scatter of its negation onto the chosen supports
        a, b, idx_ab, idx_ba, n_a, n_b = ctx.saved_tensors
        da, db_s = directed_backward(a, b, idx_ab < b.shape[1], idx_ab, n_a, g)
        db, da_s = directed_backward(b, a, idx_ba < a.shape[1], idx_ba, n_b, g)
        return da + da_s, db_s + db, None, None, None, None, None


def chamfer_distance_window_stats(a, b, a_mask=None, b_mask=None,
                                  cell_size: float = 1.2, tile: int = 1024,
                                  window: int = 4096):
    """(chamfer [B], clamp_fraction [B]): the bidirectional windowed Chamfer
    per cloud and the fraction of valid queries (both directions pooled)
    that hit the ``(2 * cell_size)^2`` clamp."""
    if a_mask is None:
        a_mask = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    if b_mask is None:
        b_mask = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
    return ChamferWindow.apply(a, b, a_mask, b_mask, cell_size, tile, window)


def chamfer_distance_window(a, b, a_mask=None, b_mask=None,
                            cell_size: float = 1.2, tile: int = 1024,
                            window: int = 4096) -> torch.Tensor:
    """[B] bidirectional windowed Chamfer (reference normalization)."""
    return chamfer_distance_window_stats(a, b, a_mask, b_mask, cell_size,
                                         tile, window)[0]
