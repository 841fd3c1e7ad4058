"""``apr_torch/ops/sort.py`` against ``jax.jit`` of ``apr_tpu/ops/sort.py``
on the same numpy keys: the cases of tests/test_sort.py (n = 8 / 256 /
4096, INVALID padding, the argsort permutation, batched [8, 512], heavy
ties).  Both networks compare strictly in the same places, so keys AND
the carried payload (argsort's order) are held exactly, ties included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_torch.ops.hashing import INVALID_KEY
from apr_torch.ops.sort import bitonic_argsort, bitonic_sort
from apr_tpu.ops import sort as ref


def _keys(seed, shape, high=1 << 30, pad_from=None):
    x = np.random.default_rng(seed).integers(0, high, size=shape)
    x = x.astype(np.int32)
    if pad_from is not None:
        x[..., pad_from:] = int(INVALID_KEY)
    return x


CASES = {
    "n8": (_keys(0, 8), "sort"),
    "n256": (_keys(0, 256), "sort"),
    "n4096": (_keys(0, 4096), "sort"),
    "invalid_padding": (_keys(1, 1024, pad_from=700), "sort"),
    "argsort_permutation": (_keys(2, 2048), "argsort"),
    "batched_8x512": (_keys(3, (8, 512)), "argsort"),
    "heavy_ties": (_keys(4, 4096, high=50), "argsort"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_bitonic_matches_the_jitted_reference(name):
    x, kind = CASES[name]
    if kind == "sort":
        got, none = bitonic_sort(torch.from_numpy(x))
        want, _ = jax.jit(ref.bitonic_sort)(jnp.asarray(x))
        assert none is None
    else:
        got, order = bitonic_argsort(torch.from_numpy(x))
        want, want_o = jax.jit(ref.bitonic_argsort)(jnp.asarray(x))
        assert order.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(), np.asarray(want_o))
        o = order.numpy()
        np.testing.assert_array_equal(np.sort(o, axis=-1),
                                      np.broadcast_to(np.arange(x.shape[-1]),
                                                      x.shape))
        np.testing.assert_array_equal(np.take_along_axis(x, o, -1),
                                      np.sort(x, axis=-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.sort(x, axis=-1))
    if name == "invalid_padding":
        assert np.all(got.numpy()[-324:] == int(INVALID_KEY))


@pytest.mark.parametrize("n", [3, 6, 1000])
def test_a_length_that_is_not_a_power_of_two_raises(n):
    with pytest.raises(ValueError, match="power of 2"):
        bitonic_sort(torch.zeros(2, n, dtype=torch.int32))
    with pytest.raises(ValueError, match="power of 2"):
        bitonic_argsort(torch.zeros(n, dtype=torch.int32))
