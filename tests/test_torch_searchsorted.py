"""Kernel K1's plain version (the CPU path of apr_torch's searchsorted_left)
against the Pallas kernel in interpret mode.  Integer results: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apr_tpu.ops.hashing import INVALID_KEY
from apr_tpu.ops.pallas.searchsorted import searchsorted_left as ref_search
from apr_torch.ops.searchsorted import searchsorted_left


def _port(sup, q):
    """Port on a batch of one cloud: support [S], queries [G, C]."""
    return searchsorted_left(torch.from_numpy(sup)[None],
                             torch.from_numpy(q)[None])[0].numpy()


def _check(sup, q, **kw):
    want = np.asarray(ref_search(jnp.asarray(sup), jnp.asarray(q),
                                 interpret=True, **kw))
    np.testing.assert_array_equal(_port(sup, q), want)
    np.testing.assert_array_equal(
        want, np.searchsorted(sup, q, side="left").astype(np.int32))


def _holes_and_padding(rng):
    s_valid, s_cap, g, c = 700, 1024, 5, 512
    sup = np.sort(rng.choice(100000, s_valid, replace=False)).astype(np.int32)
    sup = np.concatenate(
        [sup, np.full(s_cap - s_valid, INVALID_KEY, np.int32)])
    rows = []
    for _ in range(g):
        q = np.sort(rng.choice(110000, c, replace=False)).astype(np.int32)
        q[rng.random(c) < 0.1] = INVALID_KEY  # mid-row invalid holes
        q[-40:] = INVALID_KEY                 # padded tail
        rows.append(q)
    return [(sup, np.stack(rows), {})]


def _multi_slab(rng):
    sup = np.arange(0, 131072, 2, dtype=np.int32)[:8192]
    q = np.arange(0, 128 * 512 * 2, 512, dtype=np.int32)[None, :128]
    return [(sup, np.broadcast_to(q, (2, 128)).copy(), dict(window=128))]


def _extremes_and_duplicates(rng):
    sup = np.sort(rng.integers(100, 200, 512).astype(np.int32))  # many dups
    q = np.sort(rng.integers(0, 300, 256).astype(np.int32))[None, :]
    return [(sup, q.copy(), {}),
            (sup, np.zeros((1, 128), np.int32), {}),
            (sup, np.full((1, 128), 250, np.int32), {})]


def _empty_support(rng):
    sup = np.full(128, INVALID_KEY, np.int32)
    return [(sup, np.arange(128, dtype=np.int32)[None, :], {})]


@pytest.mark.parametrize("case", [_holes_and_padding, _multi_slab,
                                  _extremes_and_duplicates, _empty_support])
def test_contract_cases_match_pallas(case, rng):
    for sup, q, kw in case(rng):
        _check(sup, q, **kw)


def _sorted_rows_with_holes(rng, b, g, c, s, s_valid):
    sup = np.full((b, s), INVALID_KEY, np.int32)
    q = np.empty((b, g, c), np.int32)
    for i in range(b):
        sup[i, :s_valid] = np.sort(rng.choice(1 << 20, s_valid, replace=False))
        for j in range(g):
            row = np.sort(rng.integers(0, (1 << 20) + 10, c)).astype(np.int32)
            row[rng.random(c) < 0.2] = INVALID_KEY
            q[i, j] = row
    return sup, q


@pytest.mark.parametrize("b,g,c,s,s_valid", [
    (3, 9, 200, 300, 250),    # S and C not multiples of 128
    (2, 4, 128, 1000, 1000),  # no padding
    (4, 2, 77, 1, 1),         # one support key
    (2, 3, 64, 5, 0),         # all-padding support
])
def test_random_batched_matches_numpy(rng, b, g, c, s, s_valid):
    sup, q = _sorted_rows_with_holes(rng, b, g, c, s, s_valid)
    got = searchsorted_left(torch.from_numpy(sup), torch.from_numpy(q))
    assert got.dtype == torch.int32 and got.shape == (b, g, c)
    for i in range(b):
        np.testing.assert_array_equal(
            got[i].numpy(), np.searchsorted(sup[i], q[i], side="left"))


def test_empty_shapes_and_checks():
    sup = torch.zeros((2, 0), dtype=torch.int32)
    q = torch.full((2, 3, 4), INVALID_KEY, dtype=torch.int32)
    assert (searchsorted_left(sup, q) == 0).all()
    with pytest.raises(TypeError):
        searchsorted_left(sup.long(), q.long())
    with pytest.raises(ValueError):
        searchsorted_left(sup[0], q)
