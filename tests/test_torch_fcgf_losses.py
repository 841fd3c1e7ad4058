"""The random-negative contrastive loss and the triplet loss (random and
hardest negatives) of apr_torch against apr_tpu's, with the reference's
draws replayed, on numpy inputs made from a seed.

Tolerances: loss values rtol 1e-5; gradients with respect to both feature
sets rtol 1e-4 with an absolute floor of 1e-6 of the largest entry (float32
sums over 16 channels in another order, and the hardest negative's
pairwise expansion).  A positive pair at zero feature distance makes the
reference's gradient not finite (``jnp.linalg.norm`` at a zero vector); the
port's must be too, on the same rows, so that the trainers' finite gate
skips the step as the reference's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_torch.losses import contrastive
from apr_tpu.losses import contrastive as ref

N0, N1, C, P = 300, 280, 16, 120
NUM_POS, NUM_HN = 64, 32


def _inputs(seed, zero_positive):
    rng = np.random.default_rng(seed)
    f0 = rng.normal(size=(N0, C)).astype(np.float32)
    f1 = rng.normal(size=(N1, C)).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    src = rng.integers(0, N0, P).astype(np.int32)
    tgt = rng.integers(0, N1, P).astype(np.int32)
    pmask = rng.random(P) < 0.8
    m1 = rng.random(N1) < 0.9
    if zero_positive:
        # every valid positive at distance zero (one of them is sampled);
        # their cloud-1 points leave the negative candidates, whose
        # distance to the copy would be the rounding noise of the
        # pairwise expansion
        f1[tgt[pmask]] = f0[src[pmask]]
        m1[tgt[pmask]] = False
    return f0, f1, src, tgt, pmask, m1


def _reference(kind, key, f0, f1, src, tgt, pmask, m1):
    def loss(a, b):
        if kind == "random":
            p, n = ref.contrastive_loss_random_negatives(
                key, a, b, src, tgt, pmask, m1, num_pos=NUM_POS,
                num_neg=NUM_POS)
            return p + n, (p, n)
        out = ref.triplet_loss(key, a, b, src, tgt, pmask, m1,
                               num_pos=NUM_POS, num_hn_samples=NUM_HN,
                               hardest=kind == "hardest")
        return out, (out,)

    (total, parts), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(f0), jnp.asarray(f1))
    return ([float(x) for x in parts],
            [np.asarray(g) for g in grads])


def _draws(kind, key):
    """The reference's uniform scores and (triplet) picks for ``key``."""
    if kind == "random":
        k_pos, k_neg = jax.random.split(key)
        return [np.asarray(jax.random.uniform(k_pos, (P,))),
                np.asarray(jax.random.uniform(k_neg, (N1,)))], []
    k_pos, k_neg, k_pick = jax.random.split(key, 3)
    scores = [np.asarray(jax.random.uniform(k_pos, (P,))),
              np.asarray(jax.random.uniform(k_neg, (N1,)))]
    picks = ([] if kind == "hardest" else [np.asarray(jax.random.randint(
        k_pick, (NUM_POS,), 0, NUM_HN))])
    return scores, picks


def _port(kind, monkeypatch, draws, f0, f1, src, tgt, pmask, m1):
    scores, picks = draws

    def sample(generator, mask, num):
        return contrastive.top_valid(torch.from_numpy(scores.pop(0).copy()),
                                     mask, num)

    def pick(generator, num, high, device):
        out = torch.from_numpy(picks.pop(0).astype(np.int64))
        assert out.shape == (num,) and int(out.max()) < high
        return out

    monkeypatch.setattr(contrastive, "_sample_without_replacement", sample)
    monkeypatch.setattr(contrastive, "_random_picks", pick)
    a = torch.tensor(f0, requires_grad=True)
    b = torch.tensor(f1, requires_grad=True)
    args = (None, a, b, torch.from_numpy(src), torch.from_numpy(tgt),
            torch.from_numpy(pmask), torch.from_numpy(m1))
    if kind == "random":
        parts = contrastive.contrastive_loss_random_negatives(
            *args, num_pos=NUM_POS, num_neg=NUM_POS)
    else:
        parts = (contrastive.triplet_loss(*args, num_pos=NUM_POS,
                                          num_hn_samples=NUM_HN,
                                          hardest=kind == "hardest"),)
    sum(parts).backward()
    assert not scores and not picks          # every draw was taken
    return ([float(x.detach()) for x in parts],
            [a.grad.numpy(), b.grad.numpy()])


@pytest.mark.parametrize("zero_positive", [False, True],
                         ids=["random_features", "zero_distance_positive"])
@pytest.mark.parametrize("kind", ["random", "triplet", "hardest"])
def test_loss_and_gradients_match_the_reference(kind, zero_positive,
                                                monkeypatch):
    inputs = _inputs(3, zero_positive)
    key = jax.random.PRNGKey(5)
    want_vals, want_grads = _reference(kind, key, *inputs)
    got_vals, got_grads = _port(kind, monkeypatch, _draws(kind, key),
                                *inputs)
    np.testing.assert_allclose(got_vals, want_vals, rtol=1e-5)
    assert all(np.isfinite(v) for v in got_vals)
    for got, want in zip(got_grads, want_grads):
        bad_want = ~np.isfinite(want).all(1)
        bad_got = ~np.isfinite(got).all(1)
        np.testing.assert_array_equal(bad_got, bad_want)
        assert bad_want.any() == zero_positive
        good = ~bad_want
        scale = float(np.abs(want[good]).max())
        np.testing.assert_allclose(got[good], want[good], rtol=1e-4,
                                   atol=1e-6 * scale)
