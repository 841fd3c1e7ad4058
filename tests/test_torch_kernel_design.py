"""The algorithms of the port's CUDA kernels, emulated step by step in
torch on the CPU and held to apr_tpu's Pallas kernels in interpret mode
(K1, K2) or to the jitted functions whose selection the kernel takes over
(K3).

K1 (``apr_torch/csrc/searchsorted.cu``): the two-level search (a coarse
table of every W-th key in shared memory, then a lower_bound in the W - 1
keys of the window it brackets), with the kernel's branchless fixed-length
steps and its INT32_MAX reads past S.  K2 (``apr_torch/csrc/nn_min.cu``):
the split of (query tile, support stage) units over a persistent grid, the
running fminf with a per-sub-tile note of improvement, the rescan for the
first index attaining the min and the packed 64-bit atomicMin that joins
partial sweeps, with small tiles so that ranges split sweeps often.  The
emulated K2 replaces the plain version behind ``nn_min``'s partition, so
the wrapper's compaction and index mapping run with it.  K3
(``apr_torch/csrc/radius_select.cu``): each query's running list of its k
best (d2, position) pairs, filled in ascending position, the float32
pre-test against the widened k-th distance, the float64 distance in the
call site's contraction order, brute mode's support stages and windowed
mode's ``[lo, lo + window) & pos < hi``; the emulated K3 replaces the
kernel's launch behind ``knn``, ``radius_neighbors`` and
``windowed_radius_neighbors``, so their sorting, slab bounds and index
mapping run with it.

Integer results (K1, K2's idx) are exact; K2's d2 is exact on grid-valued
points (multiples of 1/8, where every product and sum is exact), as in
tests/test_torch_distance.py.
"""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.data.synthetic import pad_points as ref_pad_points
from apr_tpu.data.synthetic import synthetic_pair
from apr_tpu.ops.hashing import INVALID_KEY
from apr_tpu.ops.pallas.distance import chamfer_distance_pallas as \
    ref_chamfer_pallas
from apr_tpu.ops.pallas.distance import nn_min_pallas
from apr_tpu.ops.pallas.searchsorted import searchsorted_left as ref_search
from apr_torch.ops import distance
from apr_torch.ops.distance import chamfer_distance_pallas, nn_min, \
    partition
from apr_torch.ops.searchsorted import searchsorted_left, \
    searchsorted_left_many
from apr_torch.registration.matching import gt_correspondences

# the modules (both packages' ops re-export functions under these names)
ref_nb, ref_vox = (importlib.import_module(f"apr_tpu.ops.{m}")
                   for m in ("neighbors", "voxelize"))
neighbors = importlib.import_module("apr_torch.ops.neighbors")

LINE_SHIFT = 5        # csrc/searchsorted.cu: kLineShift
MAX_COARSE = 8192     # csrc/searchsorted.cu: kMaxCoarse


# --- K1 -------------------------------------------------------------------

def coarse_shift(s, max_coarse=MAX_COARSE):
    """log2 of the coarse stride, as apr_searchsorted_left_many picks it."""
    shift = LINE_SHIFT
    while (s + (1 << shift) - 1) >> shift > max_coarse:
        shift += 1
    return shift


def two_level_search(support, queries, max_coarse=MAX_COARSE):
    """searchsorted_left as the kernel computes it, support [B, S] and
    queries [B, G, C] int32."""
    b, s = support.shape
    sup = support.long()
    q = queries.reshape(b, -1).long()
    shift = coarse_shift(s, max_coarse)
    m = (s + (1 << shift) - 1) >> shift

    def key(pos):                  # support[pos], INT32_MAX past S
        if s == 0:
            return torch.full_like(pos, INVALID_KEY)
        got = torch.gather(sup, 1, pos.clamp(0, s - 1))
        return torch.where(pos < s, got, INVALID_KEY)

    at = torch.zeros_like(q)
    if m > 0:                      # level 1: #{coarse < q}
        coarse = sup[:, ::1 << shift]
        n = m
        while n > 1:
            half = n >> 1
            at = torch.where(torch.gather(coarse, 1, at + half) < q,
                             at + half, at)
            n -= half
        at = at + (torch.gather(coarse, 1, at) < q).long()
    at = torch.where(at > 0, ((at - 1) << shift) + 1, 0)
    n = (1 << shift) - 1           # level 2: the window's W - 1 keys
    while n > 1:
        half = n >> 1
        at = torch.where(key(at + half) < q, at + half, at)
        n -= half
    at = at + (key(at) < q).long()
    return at.to(torch.int32).reshape(queries.shape)


def _pallas_padded(sup, q):
    """apr_tpu's kernel (interpret mode) on one cloud, the support and the
    query rows padded with INVALID_KEY to its multiples of 128: padding
    sorts after every key and changes no answer."""
    s_pad = max(128, -(-sup.shape[0] // 128) * 128)
    c_pad = max(128, -(-q.shape[1] // 128) * 128)
    sp = np.full(s_pad, INVALID_KEY, np.int32)
    sp[:sup.shape[0]] = sup
    qp = np.full((q.shape[0], c_pad), INVALID_KEY, np.int32)
    qp[:, :q.shape[1]] = q
    got = np.asarray(ref_search(jnp.asarray(sp), jnp.asarray(qp),
                                interpret=True))
    return got[:, :q.shape[1]]


def _k1_cases(rng):
    """(name, support [S], queries [G, C]): the contract cases of
    tests/test_pallas_searchsorted.py and the window edge cases."""
    sup = np.sort(rng.choice(100000, 700, replace=False)).astype(np.int32)
    sup = np.concatenate([sup, np.full(324, INVALID_KEY, np.int32)])
    rows = []
    for _ in range(5):
        q = np.sort(rng.choice(110000, 512, replace=False)).astype(np.int32)
        q[rng.random(512) < 0.1] = INVALID_KEY
        q[-40:] = INVALID_KEY
        rows.append(q)
    dup = np.sort(rng.integers(100, 200, 512).astype(np.int32))
    # runs of equal keys across every 32-key edge
    edge = np.repeat(np.arange(0, 40, dtype=np.int32) * 7, 24)[:900]
    edge = np.concatenate([edge, np.full(124, INVALID_KEY, np.int32)])
    q_edge = np.sort(rng.integers(-3, 290, (3, 300)).astype(np.int32), axis=1)
    q_edge[:, -20:] = INVALID_KEY
    small = np.array([3, 3, 9, 12, 40, 41, 41, 77, 100, 230], np.int32)
    odd = np.sort(rng.choice(5000, 333, replace=False)).astype(np.int32)
    return [
        ("holes and padding", sup, np.stack(rows)),
        ("multi-slab spans", np.arange(0, 131072, 2, dtype=np.int32)[:8192],
         np.broadcast_to(np.arange(0, 128 * 1024, 1024, dtype=np.int32),
                         (2, 128)).copy()),
        ("duplicates", dup,
         np.sort(rng.integers(0, 300, 256).astype(np.int32))[None]),
        ("all below", dup, np.zeros((1, 128), np.int32)),
        ("all above", dup, np.full((1, 128), 250, np.int32)),
        ("empty support", np.full(128, INVALID_KEY, np.int32),
         np.arange(128, dtype=np.int32)[None]),
        ("duplicates across 32-key edges", edge, q_edge),
        ("S < 32", small, np.arange(-2, 240, 2, dtype=np.int32)[None]),
        ("S % 32 != 0", odd,
         np.sort(rng.integers(-10, 5100, (2, 400)).astype(np.int32),
                 axis=1)),
        ("S = 0", np.zeros(0, np.int32),
         np.array([[0, 5, INVALID_KEY]], np.int32)),
    ]


@pytest.mark.parametrize("max_coarse", [MAX_COARSE, 4])
def test_two_level_search_matches_pallas(rng, max_coarse):
    """Each contract case, with the default table and with a table of at
    most 4 entries (coarse strides up to 2^11: the path of a support too
    long for the shared table)."""
    for name, sup, q in _k1_cases(rng):
        got = two_level_search(torch.from_numpy(sup)[None],
                               torch.from_numpy(q)[None], max_coarse)[0]
        np.testing.assert_array_equal(got.numpy(), _pallas_padded(sup, q),
                                      err_msg=name)
        np.testing.assert_array_equal(
            got.numpy(), np.searchsorted(sup, q, side="left"), err_msg=name)


def test_two_level_search_long_support(rng):
    """Supports past the table's reach at the default size (S > 8192 * 32
    takes stride 64), batched, against numpy."""
    s = 300000
    sup = np.stack([np.sort(rng.choice(1 << 29, s, replace=False))
                    for _ in range(2)]).astype(np.int32)
    sup[1, -1000:] = INVALID_KEY
    sup[1] = np.sort(sup[1])
    q = np.sort(rng.integers(-5, 1 << 29, (2, 3, 2000)).astype(np.int32),
                axis=2)
    q[:, :, rng.random(2000) < 0.1] = INVALID_KEY
    assert coarse_shift(s) == 6
    got = two_level_search(torch.from_numpy(sup), torch.from_numpy(q))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), np.searchsorted(sup[i], q[i], side="left"))


def test_grouped_search_equals_single_calls(rng):
    """searchsorted_left_many over more searches than one launch carries
    equals one searchsorted_left per search, and apr_tpu's kernel."""
    b = 2
    searches, cases = [], _k1_cases(rng)[:4] * 3
    for _, sup, q in cases:
        searches.append((torch.from_numpy(np.stack([sup] * b)),
                         torch.from_numpy(np.stack([q] * b))))
    assert len(searches) > 8
    outs = searchsorted_left_many(searches)
    for (sup_t, q_t), got, (_, sup, q) in zip(searches, outs, cases):
        assert torch.equal(got, searchsorted_left(sup_t, q_t))
        np.testing.assert_array_equal(got[1].numpy(), _pallas_padded(sup, q))
    assert searchsorted_left_many([]) == []
    with pytest.raises(ValueError):
        searchsorted_left_many([searches[0], (searches[1][0][:1],
                                              searches[1][1][:1])])


# --- K2 -------------------------------------------------------------------

_NONE = (0x7F800000 << 32) | 0xFFFFFFFF


def emulate_nn_min_kernel(q4, s4, nq_count, ns_count, grid=7, q_tile=16,
                          stage=8, sub=4):
    """apr_nn_min's result, unit by unit, as the kernel's blocks compute it
    (its tiles are 2048 queries, 256-support stages and 32-support
    sub-tiles; smaller here so that block ranges split sweeps)."""
    b_n, nq = q4.shape[:2]
    units = [(b, t, st) for b in range(b_n)
             for t in range(-(-int(nq_count[b]) // q_tile))
             for st in range(-(-int(ns_count[b]) // stage))]
    out = torch.full((b_n, nq), _NONE, dtype=torch.int64)

    def sq(q, p):                  # [Q, 3] x [P, 3], the kernel's rounding
        d = [q[:, None, c] - p[None, :, c] for c in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]

    def flush(b, t, q, best, sub_at):
        for k in range(q_tile):
            i = t * q_tile + k
            if i >= int(nq_count[b]) or sub_at[k] < 0:
                continue
            j0 = int(sub_at[k]) * sub
            j1 = min(j0 + sub, int(ns_count[b]))
            d2 = sq(q[k:k + 1], s4[b, j0:j1, :3])[0]
            arg = j0 + int(torch.nonzero(d2 == best[k])[0])
            packed = (int(best[k:k + 1].view(torch.int32)) << 32) | arg
            out[b, i] = min(int(out[b, i]), packed)

    total = len(units)
    for g in range(grid):
        held = None
        for u in range(total * g // grid, total * (g + 1) // grid):
            b, t, st = units[u]
            if (b, t) != held:
                if held is not None:
                    flush(*held, q, best, sub_at)
                held = (b, t)
                rows = torch.arange(t * q_tile, (t + 1) * q_tile)
                q = torch.where((rows < int(nq_count[b]))[:, None],
                                q4[b, rows.clamp(max=nq - 1), :3], 0.0)
                best = torch.full((q_tile,), float("inf"))
                sub_at = torch.full((q_tile,), -1)
            cols = torch.arange(st * stage, (st + 1) * stage)
            tile = torch.where((cols < int(ns_count[b]))[:, None],
                               s4[b, cols.clamp(max=s4.shape[1] - 1), :3],
                               float("inf"))
            for si in range(stage // sub):
                prev = best
                d2 = sq(q, tile[si * sub:(si + 1) * sub])
                best = torch.minimum(best, d2.min(dim=1).values)
                sub_at = torch.where(best < prev, st * (stage // sub) + si,
                                     sub_at)
        if held is not None:
            flush(*held, q, best, sub_at)
    d2 = (out >> 32).to(torch.int32).view(torch.float32)
    return d2, out & 0xFFFFFFFF


@pytest.fixture
def emulated_k2(monkeypatch):
    """nn_min on the CPU through the partition and the emulated kernel."""
    monkeypatch.setattr(distance, "_compact_plain", emulate_nn_min_kernel)


def _grid(rng, shape, scale=2):
    return (rng.integers(-8 * scale, 8 * scale, shape) / 8.0).astype(
        np.float32)


def _ref_nn(q, s, m, q_mask=None):
    d2, idx = nn_min_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(m),
                            tq=128, ts=256, interpret=True)
    d2, idx = np.asarray(d2), np.asarray(idx)
    if q_mask is not None:
        d2 = np.where(q_mask, d2, np.inf)
        idx = np.where(q_mask, idx, s.shape[0])
    return d2, idx


def _k2_cases(rng):
    """(name, q [B, Nq, 3], s [B, Ns, 3], s_mask, q_mask or None)."""
    b, nq, ns = 3, 75, 90
    q, s = _grid(rng, (b, nq, 3)), _grid(rng, (b, ns, 3))
    scattered_s = rng.random((b, ns)) > 0.4
    scattered_q = rng.random((b, nq)) > 0.3
    no_query = scattered_q.copy()
    no_query[1] = False
    no_support = scattered_s.copy()
    no_support[2] = False
    return [
        ("scattered masks, ties", q, s, scattered_s, scattered_q),
        ("no q_mask", q, s, scattered_s, None),
        ("a cloud with no valid query", q, s, scattered_s, no_query),
        ("a cloud with no valid support", q, s, no_support, scattered_q),
        ("every point valid", q, s, np.ones((b, ns), bool),
         np.ones((b, nq), bool)),
    ]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("kernel", ["plain", "emulated"])
def test_partitioned_nn_min_matches_pallas(rng, request, case, kernel):
    """nn_min through the partition (compaction, device counts, index map)
    equals apr_tpu's kernel per cloud: exact idx and d2 on grid values;
    masked queries get (inf, Ns)."""
    if kernel == "emulated":
        request.getfixturevalue("emulated_k2")
    name, q, s, m, qm = _k2_cases(rng)[case]
    d2, idx = nn_min(torch.from_numpy(q), torch.from_numpy(s),
                     torch.from_numpy(m),
                     None if qm is None else torch.from_numpy(qm))
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    for i in range(q.shape[0]):
        want = _ref_nn(q[i], s[i], m[i], None if qm is None else qm[i])
        np.testing.assert_array_equal(d2[i].numpy(), want[0], err_msg=name)
        np.testing.assert_array_equal(idx[i].numpy(), want[1], err_msg=name)


@pytest.mark.parametrize("n", [50, 256, 700, 0])
def test_partition_is_stable(rng, n):
    """Valid points first, both runs in their order, pos the inverse of
    order, at row lengths below, at and past the scan's 256-wide rows."""
    mask = torch.from_numpy(rng.random((3, n)) > 0.5)
    mask[1] = False
    mask[2] = True
    part = partition(mask)
    for b in range(3):
        valid = torch.nonzero(mask[b])[:, 0]
        rest = torch.nonzero(~mask[b])[:, 0]
        assert int(part.count[b]) == valid.numel()
        assert torch.equal(part.order[b], torch.cat([valid, rest]))
        assert torch.equal(part.order[b][part.pos[b]], torch.arange(n))
    d2, idx = nn_min(torch.zeros((3, 4, 3)), torch.zeros((3, n, 3)), mask)
    assert torch.equal(idx[1], torch.full((4,), n, dtype=torch.int32))
    assert torch.isinf(d2[1]).all()
    assert torch.isfinite(d2[2]).all() or n == 0


def test_emulated_chamfer_matches_pallas_vjp(rng, emulated_k2):
    """The Chamfer through the emulated kernel: value and gradients equal
    apr_tpu's custom VJP (1e-5, float32 sums in another order)."""
    a, c = _grid(rng, (2, 60, 3)), _grid(rng, (2, 70, 3))
    am, cm = rng.random((2, 60)) > 0.3, rng.random((2, 70)) > 0.2
    ta, tc = (torch.from_numpy(x).requires_grad_() for x in (a, c))
    val = chamfer_distance_pallas(ta, tc, torch.from_numpy(am),
                                  torch.from_numpy(cm))
    val.sum().backward()
    for i in range(2):
        rv, (ga, gc) = jax.value_and_grad(ref_chamfer_pallas, (0, 1))(
            jnp.asarray(a[i]), jnp.asarray(c[i]), jnp.asarray(am[i]),
            jnp.asarray(cm[i]))
        np.testing.assert_allclose(float(val[i].detach()), float(rv),
                                   rtol=1e-5)
        np.testing.assert_allclose(ta.grad[i].numpy(), np.asarray(ga),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tc.grad[i].numpy(), np.asarray(gc),
                                   rtol=1e-5, atol=1e-7)


# --- K3 -------------------------------------------------------------------

K3_SLACK = torch.tensor(1 + 2.0 ** -16, dtype=torch.float32)   # kSlack
K3_TINY = torch.tensor(np.finfo(np.float32).tiny)               # kTiny


def k3_exact_sq(d0, d1, d2):
    """The kernel's exact_sq: d0 * d0 in float32, then one float64
    multiply-add a coordinate (the product is exact in float64) rounded
    once to float32."""
    acc = d0 * d0
    for d in (d1, d2):
        acc = (acc.double() + d.double() * d.double()).float()
    return acc


def k3_widened(worst):
    """The float32 pre-test's threshold: each operation rounded alone."""
    return worst * K3_SLACK + K3_TINY


def emulate_radius_select(queries, supports, q_mask, s_mask, lo, hi, idx,
                          d2, bound, yx, tile, window, stage=24):
    """apr_radius_select's result as the kernel's threads compute it, every
    query at once: the block's candidate range (every support in brute
    mode; [lo, min(lo + window, hi)) of the query's tile in windowed mode)
    in stages of ``stage`` positions with NaN points past its end and where
    s_mask is False (the kernel's stages are 512; smaller here so that
    ranges split into many), each candidate in ascending position through
    the float32 pre-test against the widened k-th distance, the float64
    distance, the compare with the k-th and the insertion after every entry
    <= d2 (a full list drops its k-th).  Fills idx and d2 in place."""
    b, nq, k = idx.shape
    ns = supports.shape[1]
    nan = float("nan")
    rows = torch.arange(nq)
    valid = (torch.ones((b, nq), dtype=torch.bool) if q_mask is None
             else q_mask.clone())
    if tile > 0:
        t = rows // tile
        c0 = lo[:, t].long().clamp(min=0)
        c1 = torch.minimum(torch.minimum(c0 + window, hi[:, t].long()),
                           torch.tensor(ns))
    else:
        c0 = torch.zeros((b, nq), dtype=torch.long)
        c1 = torch.full((b, nq), ns)
    q = torch.where(valid[..., None], queries, nan).reshape(-1, 3)
    c0, c1 = c0.reshape(-1), c1.reshape(-1)
    cloud = torch.arange(b).repeat_interleave(nq)
    list_d = torch.full((b * nq, k), float("inf"))
    list_i = torch.full((b * nq, k), ns, dtype=torch.long)
    n = torch.zeros(b * nq, dtype=torch.long)
    worst = torch.full((b * nq,), bound, dtype=torch.float32)
    worst_hi = k3_widened(worst)
    cols = torch.arange(k)
    span = int((c1 - c0).clamp(min=0).max()) if b * nq else 0
    for base in range(0, span, stage):
        for o in range(base, base + stage):
            pos = c0 + o
            on = pos < c1
            at_s = pos.clamp(0, max(ns - 1, 0))
            if s_mask is not None:
                on &= s_mask[cloud, at_s]
            p = torch.where(on[:, None], supports[cloud, at_s], nan)
            dx, dy, dz = (q[:, c] - p[:, c] for c in range(3))
            rough = (dx * dx + dy * dy) + dz * dz
            exact = (k3_exact_sq(dy, dx, dz) if yx
                     else k3_exact_sq(dx, dy, dz))
            take = torch.nonzero((rough <= worst_hi) & (exact < worst))[:, 0]
            if len(take) == 0:
                continue
            ld, li, e = list_d[take], list_i[take], exact[take, None]
            last = n[take].clamp(max=k - 1)[:, None]
            at = ((cols < last) & (ld <= e)).sum(1, keepdim=True)
            right_d = torch.cat([ld[:, :1], ld[:, :-1]], 1)
            right_i = torch.cat([li[:, :1], li[:, :-1]], 1)
            list_d[take] = torch.where(cols < at, ld, torch.where(
                cols == at, e, right_d))
            list_i[take] = torch.where(cols < at, li, torch.where(
                cols == at, pos[take, None], right_i))
            n[take] = (n[take] + 1).clamp(max=k)
            full = take[n[take] == k]
            worst[full] = list_d[full, k - 1]
            worst_hi = k3_widened(worst)
    got = n[:, None] > cols
    idx.copy_(torch.where(got, list_i, ns).reshape(b, nq, k))
    if d2 is not None:
        d2.copy_(torch.where(got, list_d, float("inf")).reshape(b, nq, k))


@pytest.fixture
def emulated_k3(monkeypatch):
    """The searches on the CPU through K3's dispatch and the emulated
    kernel (the launch count included), on one torch thread: the emulation
    is thousands of small ops, which more threads only slow."""
    monkeypatch.setattr(neighbors, "_launch", emulate_radius_select)
    monkeypatch.setattr(neighbors, "_takes_k3", lambda points, k: (
        points.shape[-1] == 3 and 1 <= k <= neighbors.K3_MAX_K))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


K3_DL = 0.6


@pytest.fixture(scope="module")
def kp_levels():
    """Two padded synthetic clouds' level-0 and level-1 barycenters and
    masks (the jitted reference's voxelization, the searches' inputs), and
    level 1 with duplicated points: 150 valid points copied into its
    padding and marked valid (exact distance ties, zeros among them)."""
    d = synthetic_pair(5, n_points=4000, apc_points=4, distance=6.0,
                       extent=30.0)
    pts, msk = zip(*(ref_pad_points(d[k], 4608)
                     for k in ("points0", "points1")))
    build = jax.jit(partial(ref_vox.voxelize_pyramid, base_voxel=K3_DL,
                            capacities=(4096, 2048)))
    grids = [build(jnp.asarray(p), mask=jnp.asarray(m))
             for p, m in zip(pts, msk)]
    lv = [(np.stack([np.asarray(g[l].barycenter) for g in grids]),
           np.stack([np.asarray(g[l].mask) for g in grids])) for l in (0, 1)]
    p1, m1 = (x.copy() for x in lv[1])
    for c in range(2):
        valid, free = np.nonzero(m1[c])[0], np.nonzero(~m1[c])[0]
        assert len(free) >= 150 and len(valid) >= 150
        p1[c, free[:150]] = p1[c, valid[:150]]
        m1[c, free[:150]] = True
    return dict(levels=lv, dup=(p1, m1), t_gt=d["t_gt"])


K3_CASES = ["knn k=1 masked", "knn k=2 unmasked", "knn k=40 above valid",
            "radius cap 40 duplicates", "gt cap 2 duplicates",
            "windowed masked rows", "windowed overflow"]


def _k3_case(name, kp, rng):
    """(the port's call on torch tensors, the jitted reference per cloud on
    numpy arrays, whether the call returns (idx, d2))."""
    (p0, m0), (p1, m1) = kp["levels"]
    dp, dm = kp["dup"]
    T = torch.from_numpy
    if name.startswith("knn"):
        k = int(name.split()[1][2:])
        if name == "knn k=1 masked":
            q, s, qm, sm = p0, p1, m0, m1
        elif name == "knn k=2 unmasked":
            q, s, qm, sm = p1, p0, None, None
        else:                  # 30 valid supports a cloud, 40 asked for
            q, s, qm = p1, p1, m1
            sm = np.zeros_like(m1)
            for c in range(2):
                sm[c, np.nonzero(m1[c])[0][:30]] = True

        def ref(c):
            return jax.jit(partial(ref_nb.knn, k=k))(
                q[c], s[c], q_mask=None if qm is None else qm[c],
                s_mask=None if sm is None else sm[c])
        return (lambda: neighbors.knn(
            T(q), T(s), k, None if qm is None else T(qm),
            None if sm is None else T(sm)), ref, True)
    if name == "radius cap 40 duplicates":
        def ref(c):
            return jax.jit(lambda q, qm: ref_nb.radius_neighbors(
                q, q, 4.0, 40, q_mask=qm, s_mask=qm))(dp[c], dm[c])
        return (lambda: neighbors.radius_neighbors(
            T(dp), T(dp), 4.0, 40, T(dm), T(dm)), ref, False)
    if name == "gt cap 2 duplicates":
        from apr_tpu.registration.matching import gt_correspondences as \
            ref_gt
        t_gt = kp["t_gt"].astype(np.float32)

        def ref(c):
            return jax.jit(lambda a, b_, t, ma, mb: ref_gt(
                a, b_, t, radius=1.2, cap_per_point=2, mask0=ma, mask1=mb))(
                    dp[0], dp[1], t_gt, dm[0], dm[1]).tgt_idx
        return (lambda: gt_correspondences(
            T(dp[:1]), T(dp[1:]), T(t_gt[None]), 1.2, cap_per_point=2,
            mask0=T(dm[:1]), mask1=T(dm[1:])).tgt_idx[:, None], ref, False)
    kw = (dict(tile=64, window=768) if name == "windowed masked rows"
          else dict(tile=64, window=96))
    qm = m0 & (rng.random(m0.shape) > 0.3) if "masked" in name else m0

    def ref(c):
        return jax.jit(lambda q, qm_, sm: ref_nb.windowed_radius_neighbors(
            q, q, 2.5, 24, q_mask=qm_, s_mask=sm, with_overflow=True,
            **kw))(p0[c], qm[c], m0[c])
    return (lambda: neighbors.windowed_radius_neighbors(
        T(p0), T(p0), 2.5, 24, T(qm), T(m0), with_overflow=True, **kw),
        ref, False)


@pytest.mark.parametrize("case", K3_CASES)
def test_emulated_k3_matches_reference(kp_levels, rng, request, case):
    """Each search through K3's dispatch and the emulated kernel equals the
    jitted reference entry for entry (idx; the windowed overflow share
    too), and the plain version (d2 bit for bit): k = 1, 2, 40 (above the
    valid supports), masked and unmasked queries and supports, duplicated
    points, both contraction orders (brute (dx, dy, dz), windowed
    (dy, dx, dz)), an overflowing window.  One launch a search (cap 2: the
    GT correspondences' one search)."""
    call, ref, with_d2 = _k3_case(case, kp_levels, rng)
    plain = call()
    request.getfixturevalue("emulated_k3")
    before = (neighbors.radius_select.launches,
              neighbors.radius_select.plain_cuda)
    got = call()
    assert (neighbors.radius_select.launches - before[0],
            neighbors.radius_select.plain_cuda - before[1]) == (1, 0)
    if case.startswith("windowed"):
        (got, ovf), (plain, plain_ovf) = got, plain
        assert torch.equal(ovf, plain_ovf)
    for g, p in zip(got if with_d2 else (got,),
                    plain if with_d2 else (plain,)):
        assert g.dtype == p.dtype and torch.equal(g, p), case
    idx = got[0] if with_d2 else got
    for c in range(idx.shape[0]):
        want = ref(c)
        if case.startswith("windowed"):
            want, want_ovf = want
            assert float(ovf[c]) == float(want_ovf)
        want = want[0] if with_d2 else want
        np.testing.assert_array_equal(idx[c].reshape(np.shape(want)).numpy(),
                                      np.asarray(want), err_msg=case)
    ns = idx.shape[1] if case.startswith("radius") else None
    if case == "windowed overflow":
        assert float(ovf.min()) > 0.1        # the window truncates slabs
    if case == "knn k=40 above valid":
        assert bool((idx[..., 30:] == kp_levels["levels"][1][0].shape[1])
                    .all()) and bool((idx[..., :30] < 2048).any())
    if ns is not None:                       # some rows hit the cap
        assert bool((idx[..., -1] < ns).any())


@pytest.mark.parametrize("site", ["brute", "window"])
def test_k3_distance_is_the_reference_contraction(rng, site):
    """The emulated kernel's float64 distance in each site's order equals
    the reference's compiled squared distance bit for bit, and the other
    order does not on these inputs: the order is what the tables hang on."""
    q = rng.uniform(-60, 60, (512, 3)).astype(np.float32)
    s = (q[:128] + rng.normal(0, 0.3, (128, 3))).astype(np.float32)
    d = [torch.from_numpy(q[:, None, c] - s[None, :, c]) for c in range(3)]
    xyz, yxz = k3_exact_sq(d[0], d[1], d[2]), k3_exact_sq(d[1], d[0], d[2])
    if site == "brute":
        want, other = np.asarray(jax.jit(ref_nb._pairwise_sqdist)(q, s)), yxz
        got = xyz
    else:
        want = np.asarray(jax.jit(
            lambda dx, dy, dz: dx * dx + dy * dy + dz * dz)(
                *(x.numpy() for x in d)))
        got, other = yxz, xyz
    np.testing.assert_array_equal(got.numpy(), want)
    assert (other.numpy() != want).any()


def test_k3_dispatch_on_the_cpu_stays_plain(kp_levels):
    """CPU tensors never reach the kernel: no launch and no plain-on-card
    count, whatever k and dimension; the wrapper refuses supports or masks
    the kernel cannot read."""
    (p0, m0), (p1, m1) = kp_levels["levels"]
    before = (neighbors.radius_select.launches,
              neighbors.radius_select.plain_cuda)
    neighbors.knn(torch.from_numpy(p1), torch.from_numpy(p1), 2)
    neighbors.radius_neighbors(torch.from_numpy(p1), torch.from_numpy(p1),
                               2.5, neighbors.K3_MAX_K + 1)
    assert (neighbors.radius_select.launches,
            neighbors.radius_select.plain_cuda) == before
    assert not neighbors._takes_k3(torch.from_numpy(p1), 2)
    q = torch.from_numpy(p1)
    for s, qm in ((q.double(), None), (q[..., :2], None),
                  (q, torch.from_numpy(m1).float())):
        with pytest.raises(ValueError, match="radius_select takes"):
            neighbors.radius_select(q, s, 2, 1.0, q_mask=qm)
    assert neighbors.radius_select.launches == before[0]
