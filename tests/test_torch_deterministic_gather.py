"""The sorted-sum gathers of apr_torch (``ops/pooling.py::gather_rows``) and
every site that calls them, against plain autograd of the same gather.

``gather_rows``' backward sums each source row's contributions after one
stable sort of the indices (``segment_reduce``), in index order, so on the
card two runs give the same bits; plain autograd of an index or a
``torch.gather`` sums through ``index_put_`` / ``scatter_add_``.

Tolerances: with unique indices, or in float64, the gradients are equal
bit for bit (the same additions in the same order); float32 sums of
duplicated indices within 1e-6 relative of the plain backward (measured:
equal, the CPU's plain backward adds in index order too).  The KPConv,
pooling, upsampling, GCN and hardest-contrastive sites are compared
forward bit for bit and backward to 1e-6 relative against the same module
with the plain gather patched in.
"""

import numpy as np
import pytest
import torch

from apr_torch.losses import contrastive
from apr_torch.models import gcn, kpconv
from apr_torch.ops import pooling
from apr_torch.ops.pooling import gather_rows, segment_mean_capped, \
    sorted_row_sums

T = torch.from_numpy


def plain_gather_rows(src, idx):
    """``src[idx]`` with entries >= len(src) a zero row, through plain
    autograd (an accumulating index_put_ backward)."""
    padded = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    return padded[idx.long().clamp(max=src.shape[0])]


def _both(fn, src, g):
    """(output, gradient of src) of fn under the upstream gradient g."""
    x = src.detach().clone().requires_grad_(True)
    y = fn(x)
    y.backward(g)
    return y.detach(), x.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["sentinel", "duplicates", "unique",
                                  "empty_rows"])
def test_gather_rows_matches_plain_autograd(case, dtype):
    rng = np.random.default_rng(3)
    m, f = 40, 5
    if case == "unique":
        idx = rng.permutation(m)[:30].reshape(5, 6)
    elif case == "empty_rows":
        idx = rng.integers(0, 8, (7, 9))           # rows 8.. take nothing
    else:
        idx = rng.integers(0, m + (case == "sentinel") * 10, (64, 12))
    src = T(rng.normal(size=(m, f))).to(dtype)
    g = T(rng.normal(size=idx.shape + (f,))).to(dtype)
    idx = T(idx)
    y, dx = _both(lambda s: gather_rows(s, idx), src, g)
    y_ref, dx_ref = _both(lambda s: plain_gather_rows(s, idx), src, g)
    assert torch.equal(y, y_ref)
    if case == "sentinel":
        assert bool((y[idx >= m] == 0).all())
    if case == "empty_rows":
        assert bool((dx[8:] == 0).all())
    if case == "unique" or dtype == torch.float64:
        assert torch.equal(dx, dx_ref)
    else:
        torch.testing.assert_close(dx, dx_ref, rtol=1e-6, atol=1e-6)


def test_sorted_row_sums_drops_the_sentinel_and_adds_in_order():
    vals = torch.tensor([[1.0], [2.0], [4.0], [8.0], [16.0]])
    idx = torch.tensor([2, 0, 9, 2, 3])       # 9 >= m: the sentinel
    out, counts = sorted_row_sums(vals, idx, 4)
    assert out[:, 0].tolist() == [2.0, 0.0, 1.0 + 8.0, 16.0]
    assert counts.tolist() == [1, 0, 2, 1]


def test_segment_mean_capped_matches_the_scatter_mean():
    """The sorted-run mean equals the plain per-segment mean (the
    reference's jitted function is held in test_torch_neighbors.py)."""
    rng = np.random.default_rng(0)
    v = T(rng.normal(size=(3, 200, 6)).astype(np.float32))
    seg = T(rng.integers(0, 23, (3, 200)).astype(np.int32))
    got = segment_mean_capped(v, seg, 20)
    for b in range(3):
        for s in range(20):
            rows = v[b][seg[b] == s]
            want = rows.sum(0) / max(len(rows), 1)
            torch.testing.assert_close(got[b, s], want, rtol=1e-6,
                                       atol=1e-7)


def _patched(monkeypatch, module):
    monkeypatch.setattr(module, "gather_rows", plain_gather_rows)


def _site_grads(run, monkeypatch, module, inputs):
    """run(*inputs) -> scalar, with this package's gather and then the
    plain one; returns both (value, input grads)."""
    out = []
    for plain in (False, True):
        if plain:
            _patched(monkeypatch, module)
        xs = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in inputs]
        value = run(*xs)
        value.backward()
        out.append((value.detach(), [x.grad for x in xs
                                     if x.is_floating_point()]))
        monkeypatch.undo()
    return out


def _assert_same(pair):
    (v, gs), (v_ref, gs_ref) = pair
    assert torch.equal(v, v_ref)
    for g, g_ref in zip(gs, gs_ref):
        torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-7)


def test_pooling_sites_match_plain_gathers(monkeypatch):
    rng = np.random.default_rng(1)
    feats = T(rng.normal(size=(2, 50, 4)).astype(np.float32))
    table = T(rng.integers(0, 56, (2, 30, 7)).astype(np.int32))  # 50.. shadow
    up = T(rng.integers(0, 51, (2, 80, 1)).astype(np.int32))
    w = T(rng.normal(size=(2, 30, 4)).astype(np.float32))
    wu = T(rng.normal(size=(2, 80, 4)).astype(np.float32))

    def run(x):
        return ((pooling.max_pool_neighbors(x, table) * w).sum()
                + (kpconv.nearest_upsample(x, up) * wu).sum()
                + pooling.gather_neighbors(x, table).square().sum())
    _assert_same(_site_grads(run, monkeypatch, pooling, [feats]))


def test_gcn_edge_features_match_plain_gather(monkeypatch):
    rng = np.random.default_rng(2)
    coords = T(rng.normal(size=(40, 3)).astype(np.float32))
    feats = T(rng.normal(size=(40, 6)).astype(np.float32))
    mask = T(rng.random(40) > 0.2)
    w = T(rng.normal(size=(40, 5, 12)).astype(np.float32))

    def run(x):
        return (gcn._graph_features(coords, x, mask, 5) * w).sum()
    _assert_same(_site_grads(run, monkeypatch, gcn, [feats]))


def test_kpconv_layer_matches_plain_gather(monkeypatch):
    rng = np.random.default_rng(4)
    torch.manual_seed(0)
    layer = kpconv.KPConvLayer(4, 6, 1.0, 1.2)
    kpconv.reset_kp_parameters_(layer, torch.Generator().manual_seed(0))
    pts = T(rng.uniform(-2, 2, (2, 60, 3)).astype(np.float32))
    x = T(rng.normal(size=(2, 60, 4)).astype(np.float32))
    nb = T(rng.integers(0, 65, (2, 60, 9)).astype(np.int32))   # 60.. shadow
    wo = T(rng.normal(size=(2, 60, 6)).astype(np.float32))

    def run(feats):
        return (layer(pts, pts, nb, feats) * wo).sum()
    _assert_same(_site_grads(run, monkeypatch, kpconv, [x]))
    weights = layer.weights
    for plain in (False, True):
        if plain:
            _patched(monkeypatch, kpconv)
        layer.zero_grad()
        run(x).backward()
        g = weights.grad.clone()
        monkeypatch.undo()
        if not plain:
            g_ours = g
    torch.testing.assert_close(g_ours, g, rtol=1e-6, atol=1e-7)


def test_loss_sites_match_plain_gathers(monkeypatch):
    rng = np.random.default_rng(5)
    f0 = T(rng.normal(size=(60, 8)).astype(np.float32))
    f1 = T(rng.normal(size=(70, 8)).astype(np.float32))
    src = T(rng.integers(0, 60, 90).astype(np.int32))
    tgt = T(rng.integers(0, 70, 90).astype(np.int32))
    pmask = T(rng.random(90) > 0.1)
    scores = [T(rng.random(n).astype(np.float32)) for n in (90, 60, 70)]

    def run(a, b):
        queue = list(scores)
        monkeypatch.setattr(contrastive, "_sample_without_replacement",
                            lambda gen, mask, num: contrastive.top_valid(
                                queue.pop(0), mask, num))
        pos, neg = contrastive.hardest_contrastive_loss(
            None, a, b, src, tgt, pmask, num_pos=48, num_hn_samples=24)
        return pos + neg

    out = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(contrastive, "gather_rows",
                                plain_gather_rows)
        xs = [f0.clone().requires_grad_(True), f1.clone().requires_grad_(True)]
        v = run(*xs)
        v.backward()
        out.append((v.detach(), [x.grad for x in xs]))
        monkeypatch.undo()
    _assert_same(out)
