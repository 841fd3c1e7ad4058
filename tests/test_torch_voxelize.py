"""apr_torch key packing and voxelize_lean against apr_tpu.  Exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.ops import hashing as ref_hashing
from apr_tpu.ops.voxelize import unique_of_sorted as ref_unique
from apr_tpu.ops.voxelize import voxelize_lean as ref_voxelize_lean
from apr_torch.ops.hashing import INVALID_KEY, pack_coords, unpack_coords
from apr_torch.ops.voxelize import unique_of_sorted, voxelize_lean


def test_invalid_key_is_the_reference_sentinel():
    assert INVALID_KEY == int(ref_hashing.INVALID_KEY) == 2**31 - 1


def test_pack_unpack_match_reference_with_clipping(rng):
    coords = rng.integers(-700, 700, (5000, 3)).astype(np.int32)
    got = pack_coords(torch.from_numpy(coords)).numpy()
    want = np.array(ref_hashing.pack_coords(jnp.asarray(coords)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        unpack_coords(torch.from_numpy(want)).numpy(),
        np.asarray(ref_hashing.unpack_coords(jnp.asarray(want))))
    # in-range coords round-trip; out-of-range ones clip to [-512, 511]
    back = unpack_coords(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, np.clip(coords, -512, 511))


# the reference build runs jitted (make_pair_batch), where XLA folds the
# division by the voxel size into a multiplication by its reciprocal
_ref_lean = jax.jit(ref_voxelize_lean, static_argnums=(1, 2))


@pytest.mark.parametrize("n,capacity,voxel", [
    (3000, 2048, 0.5),   # masked points, negative coords, room to spare
    (3000, 256, 0.3),    # overflow: the largest keys drop
    (500, 512, 1e-2),    # tiny voxels: coords clip at the field edge
])
def test_voxelize_lean_matches_reference(rng, n, capacity, voxel):
    b = 3
    pts = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    pts[1, :50] = pts[1, 50:100]            # duplicate points
    mask = rng.random((b, n)) > 0.2
    got = voxelize_lean(torch.from_numpy(pts), voxel, capacity,
                        torch.from_numpy(mask))
    for i in range(b):
        want = _ref_lean(jnp.asarray(pts[i]), voxel, capacity,
                         jnp.asarray(mask[i]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert got[3].dtype == torch.int32 and got[1].dtype == torch.int32


def test_unique_of_sorted_matches_reference(rng):
    keys = np.sort(rng.integers(0, 50, (2, 300)).astype(np.int32), axis=1)
    keys[:, -30:] = INVALID_KEY
    uniq, seg = unique_of_sorted(torch.from_numpy(keys), 32)
    for i in range(2):
        wu, ws = ref_unique(jnp.asarray(keys[i]), 32)
        np.testing.assert_array_equal(uniq[i].numpy(), np.asarray(wu))
        np.testing.assert_array_equal(seg[i].numpy(), np.asarray(ws))
