"""The Predator MetricLoss of apr_torch against apr_tpu's jitted one, on the
same numpy inputs made from a seed.

- coordinate distances (the circle loss's pairwise ones and the norms
  behind the tight and matchability masks): bit-equal, on points placed
  within a few ulps of ``pos_radius`` and ``safe_radius``;
- ``weighted_bce``, ``circle_loss``, ``feature_match_recall`` and the
  whole ``metric_loss`` (the reference's correspondence draws replayed),
  values and gradients: within rtol 1e-5, atol 1e-6 (float32 sums in
  another order);
- padded rows and padded picks change nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.losses import circle as ref
from apr_torch.losses import circle, contrastive

T = torch.from_numpy
RTOL, ATOL = 1e-5, 1e-6
POS, SAFE, MATCH = 0.21, 0.75, 0.3


def _rigid(rng):
    """A random rigid transform, float32 [4, 4]."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = q * np.sign(np.linalg.det(q))
    t[:3, 3] = rng.uniform(-20, 20, 3)
    return t


def _at(base, lengths, rng):
    """Points at ``lengths`` from ``base`` [N, 3] in random directions."""
    u = rng.normal(size=base.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (base + u * lengths[:, None]).astype(np.float32)


def _near(radius, n, rng):
    """Lengths within a few float32 ulps of ``radius``."""
    r = np.float32(radius)
    return np.nextafter(r, np.float32(np.inf) * rng.choice([-1, 1], n)) + \
        rng.integers(-3, 4, n) * np.spacing(r)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


# --- coordinate distances -------------------------------------------------

@pytest.fixture(scope="module")
def straddling():
    """Sources at LiDAR range and targets within a few ulps of each
    threshold of the loss (pos_radius, safe_radius and the tight and
    matchability radii), plus random ones."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-70, 70, (600, 3)).astype(np.float32)
    lengths = np.concatenate([_near(r, 120, rng) for r in
                              (POS, SAFE, POS - 0.001, MATCH)]
                             + [rng.uniform(0, 2, 120)])
    return a, _at(a, lengths.astype(np.float32), rng)


def _gathered_norm(a, b, i, j):
    """The norm of gathered differences, as metric_loss forms its
    correspondence and matchability distances."""
    return jnp.linalg.norm(a[i] - b[j], axis=1)


GATHER = (np.random.default_rng(1).permutation(600),) * 2


def test_coordinate_distances_bit_equal(straddling):
    a, b = straddling
    want = np.asarray(jax.jit(
        lambda a, b: jnp.sqrt(ref._sq_dist_coords(a, b)))(a, b))
    got = circle._sqrt(circle._sq_dist_coords(T(a), T(b))).numpy()
    np.testing.assert_array_equal(got, want)
    want_n = np.asarray(jax.jit(_gathered_norm)(a, b, *GATHER))
    np.testing.assert_array_equal(
        circle._norm3(T(a)[GATHER[0]] - T(b)[GATHER[1]]).numpy(), want_n)
    for r in (POS, SAFE):
        assert 0 < (np.diag(want) < np.float32(r)).sum() < 600


@pytest.mark.parametrize("site", ["pairwise", "norm"])
def test_reference_contraction_order(straddling, site):
    """The reference's jitted coordinate distances round as the port
    emulates them (jax / jaxlib 0.9.0): ``_sq_dist_coords`` as
    ``fma(dz, dz, fma(dx, dx, dy * dy))``, ``jnp.linalg.norm`` of a
    3-vector as ``fma(dz, dz, fma(dy, dy, dx * dx))``, each square root
    correctly rounded.  The unfused float32 sum with torch's CPU sqrt
    differs on these inputs, so if a jax upgrade changes the reference's
    order this test names the cause."""
    a, b = straddling
    if site == "pairwise":
        want = np.asarray(jax.jit(
            lambda a, b: jnp.sqrt(ref._sq_dist_coords(a, b)))(a, b))
        got = circle._sqrt(circle._sq_dist_coords(T(a), T(b))).numpy()
        d = T(a)[:, None, :] - T(b)[None, :, :]
        order = "fma(dz, dz, fma(dx, dx, dy * dy))"
    else:
        want = np.asarray(jax.jit(_gathered_norm)(a, b, *GATHER))
        d = T(a)[GATHER[0]] - T(b)[GATHER[1]]
        got = circle._norm3(d).numpy()
        order = "fma(dz, dz, fma(dy, dy, dx * dx))"
    plain = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                       + d[..., 2] * d[..., 2]).numpy()
    assert (plain != want).any(), "the inputs cannot tell orders apart"
    assert np.array_equal(got, want), (
        f"XLA's CPU build (jax {jax.__version__}) no longer computes the "
        f"reference's {site} coordinate distance as {order}: update "
        f"apr_torch/losses/circle.py")


# --- the pieces -----------------------------------------------------------

def test_weighted_bce_matches(rng):
    n = 3000
    pred = rng.uniform(0, 1, n).astype(np.float32)
    pred[:50] = 0.0                                   # masked-score padding
    pred[50:80] = np.float32(1 - 1e-7)                # the clip's edge
    pred[80:90] = 1.0
    gt = (rng.random(n) < 0.3).astype(np.float32)
    mask = rng.random(n) < 0.8
    want, vjp = jax.vjp(lambda p: ref.weighted_bce(p, jnp.asarray(gt),
                                                   jnp.asarray(mask)), pred)
    p = T(pred).requires_grad_()
    got = circle.weighted_bce(p, T(gt), T(mask))
    for g, w in zip(got, want):
        _close(g.detach(), w)
    got[0].backward()
    _close(p.grad, vjp((1.0, 0.0, 0.0))[0], "d loss / d pred")


def _circle_inputs(rng, k=96, n_valid=80):
    a = rng.uniform(-70, 70, (k, 3)).astype(np.float32)
    lengths = np.concatenate([_near(POS, k // 3, rng),
                              _near(SAFE, k // 3, rng),
                              rng.uniform(0, 1.5, k - 2 * (k // 3))])
    b = _at(a[rng.permutation(k)], lengths.astype(np.float32), rng)
    b[: k // 2] = _at(a[: k // 2], lengths[: k // 2].astype(np.float32), rng)
    cd = np.asarray(jax.jit(
        lambda a, b: jnp.sqrt(ref._sq_dist_coords(a, b)))(a, b))
    fd = rng.uniform(0.05, 1.6, (k, k)).astype(np.float32)
    valid = np.arange(k) < n_valid
    cd = np.where(valid[:, None] & valid[None, :], cd,
                  np.float32(0.5 * (POS + SAFE)))
    return cd, fd, valid


def test_circle_loss_and_recall_match(rng):
    cd, fd, valid = _circle_inputs(rng)
    assert ((cd < np.float32(POS)).sum(1) > 0).sum() > 10

    def ref_loss(f):
        return ref.circle_loss(jnp.asarray(cd), f, POS, SAFE,
                               valid=jnp.asarray(valid))

    want, vjp = jax.vjp(jax.jit(ref_loss), fd)
    f = T(fd).requires_grad_()
    got = circle.circle_loss(T(cd), f, POS, SAFE, valid=T(valid))
    _close(got.detach(), want)
    got.backward()
    _close(f.grad, vjp(jnp.float32(1.0))[0], "d loss / d feats_dist")
    assert float(np.abs(f.grad.numpy()).max()) > 1e-4

    fr = np.where(valid[None, :], fd, np.inf).astype(np.float32)
    fr[3, :5] = fr[3, 5]              # an argmin tie: the first one wins
    want_r = jax.jit(ref.feature_match_recall, static_argnums=2)(cd, fr, POS)
    _close(circle.feature_match_recall(T(cd), T(fr), POS), want_r)


def test_padded_picks_change_nothing(rng):
    """Padded rows and columns (valid False, any distances) leave the
    circle loss and its gradient as they are on the valid block alone."""
    cd, fd, valid = _circle_inputs(rng, k=96, n_valid=80)
    f = T(fd).requires_grad_()
    padded = circle.circle_loss(T(cd), f, POS, SAFE, valid=T(valid))
    padded.backward()
    g = T(fd[:80, :80]).requires_grad_()
    alone = circle.circle_loss(T(cd[:80, :80]), g, POS, SAFE)
    alone.backward()
    _close(padded.detach(), alone.detach())
    _close(f.grad[:80, :80], g.grad)
    assert float(f.grad[80:].abs().max()) == 0.0
    assert float(f.grad[:, 80:].abs().max()) == 0.0


# --- the whole MetricLoss --------------------------------------------------

def _metric_inputs(seed, n=700, m=650, n_pad=0):
    """One pair's arrays: sources at LiDAR range, targets at straddling
    and random distances from the warped sources, correspondences with
    cap 2, unit-norm features correlated across matches, scores in
    (0, 1).  ``n_pad`` padded rows (garbage, masked) end each cloud."""
    rng = np.random.default_rng(seed)
    t_gt = _rigid(rng)
    src = rng.uniform(-70, 70, (n, 3)).astype(np.float32)
    warp = np.asarray(jax.jit(lambda p, t: p @ t[:3, :3].T + t[:3, 3])(
        src, t_gt))
    k = min(n, m)
    lengths = np.concatenate([_near(POS - 0.001, k // 4, rng),
                              _near(MATCH, k // 4, rng),
                              rng.uniform(0, 0.6, k - 2 * (k // 4))])
    tgt = np.concatenate([_at(warp[:k], lengths.astype(np.float32), rng),
                          rng.uniform(-70, 70, (m - k, 3))]).astype(np.float32)
    perm = rng.permutation(m)
    tgt = tgt[perm]
    inv = np.argsort(perm)
    corr_src = np.repeat(np.arange(n), 2).astype(np.int32)
    corr_tgt = np.stack([inv[np.minimum(np.arange(n), k - 1)],
                         rng.integers(0, m, n)], 1).reshape(-1).astype(
        np.int32)
    corr_mask = np.stack([np.arange(n) < k, rng.random(n) < 0.3], 1
                         ).reshape(-1) & (rng.random(2 * n) < 0.9)
    fs = rng.normal(size=(n, 16)).astype(np.float32)
    ft = rng.normal(size=(m, 16)).astype(np.float32)
    ft[inv[:k]] = fs[:k] + rng.normal(0, 0.7, (k, 16))
    fs /= np.linalg.norm(fs, axis=1, keepdims=True)
    ft /= np.linalg.norm(ft, axis=1, keepdims=True)
    ms, mt = rng.random(n) < 0.95, rng.random(m) < 0.95
    o0, s0 = (np.where(ms, rng.uniform(0.01, 0.99, n), 0).astype(np.float32)
              for _ in range(2))
    o1, s1 = (np.where(mt, rng.uniform(0.01, 0.99, m), 0).astype(np.float32)
              for _ in range(2))
    fs, ft = fs * ms[:, None], ft * mt[:, None]
    arrays = [src, tgt, ms, mt, fs, ft, corr_src, corr_tgt, corr_mask, t_gt,
              o0, o1, s0, s1]
    if n_pad:
        arrays = _pad(arrays, n_pad, rng)
    return arrays


def _pad(arrays, n_pad, rng):
    """``n_pad`` masked garbage rows at the end of each cloud's buffers
    and ``2 * n_pad`` masked correspondences at the end of the set."""
    src, tgt, ms, mt, fs, ft, cs, ct, cm, t_gt, o0, o1, s0, s1 = arrays

    def grow(x, fill):
        return np.concatenate([x, fill(n_pad, x)]).astype(x.dtype)

    garbage = (lambda k, x: rng.normal(0, 30, (k,) + x.shape[1:]))
    src, tgt, fs, ft = (grow(x, garbage) for x in (src, tgt, fs, ft))
    o0, o1, s0, s1 = (grow(x, lambda k, x: rng.uniform(0, 1, k))
                      for x in (o0, o1, s0, s1))
    ms, mt = (grow(x, lambda k, x: np.zeros(k, bool)) for x in (ms, mt))
    n, m = len(src), len(tgt)
    cs = np.concatenate([cs, rng.integers(0, n, 2 * n_pad)]).astype(np.int32)
    ct = np.concatenate([ct, rng.integers(0, m, 2 * n_pad)]).astype(np.int32)
    cm = np.concatenate([cm, np.zeros(2 * n_pad, bool)])
    return [src, tgt, ms, mt, fs, ft, cs, ct, cm, t_gt, o0, o1, s0, s1]


KW = dict(pos_radius=POS, safe_radius=SAFE, matchability_radius=MATCH,
          max_points=256)
DIFF = (4, 5, 10, 11, 12, 13)      # features and the four score vectors


def _replayed(monkeypatch, key, n_corr):
    scores = np.asarray(jax.random.uniform(key, (n_corr,)))

    def sample(generator, mask, num):
        return contrastive.top_valid(T(scores.copy()), mask, num)
    monkeypatch.setattr(contrastive, "_sample_without_replacement", sample)


def _port(arrays, monkeypatch, key, weights):
    _replayed(monkeypatch, key, len(arrays[6]))
    ts = [T(a) for a in arrays]
    for i in DIFF:
        ts[i].requires_grad_()
    out = circle.metric_loss(None, *ts, **KW)
    sum(w * out[k] for k, w in weights.items()).backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            [ts[i].grad.numpy() for i in DIFF])


def _reference(arrays, key, weights):
    def f(*diff):
        a = list(map(jnp.asarray, arrays))
        for i, d in zip(DIFF, diff):
            a[i] = d
        out = ref.metric_loss(key, *a, overlap_radius=0.45, **KW)
        return sum(w * out[k] for k, w in weights.items()), out

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(len(DIFF))),
                                         has_aux=True)(
        *(arrays[i] for i in DIFF))
    return {k: float(v) for k, v in out.items()}, [np.asarray(g)
                                                   for g in grads]


WEIGHTS = dict(circle_loss=1.0, overlap_loss=1.0, saliency_loss=0.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_loss_matches_with_replayed_draws(monkeypatch, seed):
    arrays = _metric_inputs(seed)
    key = jax.random.PRNGKey(seed + 40)
    want, want_g = _reference(arrays, key, WEIGHTS)
    got, got_g = _port(arrays, monkeypatch, key, WEIGHTS)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    for g, w, i in zip(got_g, want_g, DIFF):
        _close(g, w, f"gradient of input {i}")
    assert want["circle_loss"] > 0 and 0 < want["saliency_recall"] < 1
    assert want["recall"] > 0


def test_metric_loss_padded_rows_change_nothing(monkeypatch):
    """Masked garbage rows in both clouds and masked correspondences
    leave every output and the valid rows' gradients as they were (the
    draws replayed over the longer correspondence buffer agree on the
    real ones)."""
    arrays = _metric_inputs(0)
    padded = _pad(list(arrays), 64, np.random.default_rng(5))
    key = jax.random.PRNGKey(3)
    base, base_g = _port(arrays, monkeypatch, key, WEIGHTS)
    scores = np.asarray(jax.random.uniform(key, (len(arrays[6]),)))
    ext = np.concatenate([scores, np.full(128, 2.0, np.float32)])

    def sample(generator, mask, num):
        return contrastive.top_valid(T(ext.copy()), mask, num)
    monkeypatch.setattr(contrastive, "_sample_without_replacement", sample)
    ts = [T(a) for a in padded]
    for i in DIFF:
        ts[i].requires_grad_()
    out = circle.metric_loss(None, *ts, **KW)
    sum(w * out[k] for k, w in WEIGHTS.items()).backward()
    for k in base:
        _close(float(out[k].detach()), base[k], k)
    for i, g in zip(DIFF, base_g):
        _close(ts[i].grad.numpy()[:len(g)], g, f"gradient of input {i}")
        assert float(ts[i].grad[len(g):].abs().max()) == 0.0


def test_mutual_argmax_in_chunks_keeps_the_lower_index(rng, monkeypatch):
    """The saliency's mutual best matches, computed in row chunks, equal
    jnp.argmax over the whole masked score matrix: ties (duplicated
    features) to the lower index, an empty set to 0."""
    f0 = rng.normal(size=(300, 8)).astype(np.float32)
    f1 = rng.normal(size=(200, 8)).astype(np.float32)
    f0[150:] = f0[:150]                         # tied rows across chunks
    f1[100:] = f1[:100]                         # tied columns
    in0, in1 = rng.random(300) < 0.7, rng.random(200) < 0.6
    in0[[0, 150]] = True
    in1[[0, 100]] = True
    scores = f0 @ f1.T
    want1 = np.asarray(jnp.argmax(jnp.where(in1[None, :], scores, -jnp.inf),
                                  axis=1))
    want0 = np.asarray(jnp.argmax(jnp.where(in0[:, None], scores, -jnp.inf),
                                  axis=0))
    monkeypatch.setattr(circle, "_SCORE_ELEMS", 7 * 200)   # 7-row chunks
    got1, got0 = circle._mutual_argmax(*map(T, (f0, f1, in0, in1)))
    np.testing.assert_array_equal(got1.numpy(), want1)
    np.testing.assert_array_equal(got0.numpy(), want0)
    # a winner from the copies wins only where its twin is masked out,
    # and some twin pairs did tie
    upper = want0 >= 150
    assert not in0[want0[upper] - 150].any()
    assert (~upper & in0[np.minimum(want0 + 150, 299)]).any()
    none1, none0 = circle._mutual_argmax(
        T(f0), T(f1), T(np.zeros(300, bool)), T(np.zeros(200, bool)))
    assert not none1.any() and not none0.any()
