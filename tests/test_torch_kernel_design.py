"""The algorithms of the port's two CUDA kernels, emulated step by step in
torch on the CPU and held to apr_tpu's Pallas kernels in interpret mode.

K1 (``apr_torch/csrc/searchsorted.cu``): the two-level search (a coarse
table of every W-th key in shared memory, then a lower_bound in the W - 1
keys of the window it brackets), with the kernel's branchless fixed-length
steps and its INT32_MAX reads past S.  K2 (``apr_torch/csrc/nn_min.cu``):
the split of (query tile, support stage) units over a persistent grid, the
running fminf with a per-sub-tile note of improvement, the rescan for the
first index attaining the min and the packed 64-bit atomicMin that joins
partial sweeps, with small tiles so that ranges split sweeps often.  The
emulated K2 replaces the plain version behind ``nn_min``'s partition, so
the wrapper's compaction and index mapping run with it.

Integer results (K1, K2's idx) are exact; K2's d2 is exact on grid-valued
points (multiples of 1/8, where every product and sum is exact), as in
tests/test_torch_distance.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    import jax

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
