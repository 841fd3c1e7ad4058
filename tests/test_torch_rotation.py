"""The port's numpy rotations against the scipy calls they replace in the
data loaders, over many draws, with the differing bits counted.

Tolerances: ``euler_matrix``, ``rotvec_matrix`` and ``vector_norm`` equal
scipy bit for bit.  ``expm`` of the loaders' skew matrices differs from
scipy's by at most 2 ulps of 1.0 (scipy's compiled products and LU solve
round in another order), and every float32 cast of it, which is all the
loaders use, is equal.
"""

import numpy as np
import pytest
from scipy.linalg import expm as scipy_expm
from scipy.linalg import norm as scipy_norm
from scipy.spatial.transform import Rotation

from apr_torch.geometry.rotation import euler_matrix, expm, rotvec_matrix, \
    vector_norm

N_DRAWS = 4000


@pytest.mark.parametrize("seq", ["zyx", "xyz", "ZYX", "z"])
def test_euler_matrix_bits(seq):
    rng = np.random.RandomState(0)
    differ = 0
    for _ in range(N_DRAWS):
        ang = (rng.rand(len(seq)) - 0.5) * np.pi * 4
        differ += int(np.count_nonzero(
            euler_matrix(seq, ang) != Rotation.from_euler(seq, ang)
            .as_matrix()))
    assert differ == 0, f"{differ} of {9 * N_DRAWS} entries differ"


def test_rotvec_matrix_bits():
    rng = np.random.RandomState(1)
    differ = 0
    for k in range(N_DRAWS):
        # both of scipy's branches: below 1e-3 rad its Taylor series
        v = rng.normal(size=3) * (1e-4 if k % 4 == 0 else rng.rand() * 3)
        differ += int(np.count_nonzero(
            rotvec_matrix(v) != Rotation.from_rotvec(v).as_matrix()))
    assert differ == 0, f"{differ} of {9 * N_DRAWS} entries differ"


def test_vector_norm_bits():
    rng = np.random.RandomState(2)
    vs = rng.rand(N_DRAWS, 3) - 0.5
    got = np.array([vector_norm(v) for v in vs])
    want = np.array([scipy_norm(v) for v in vs])
    assert np.count_nonzero(got != want) == 0
    # np.linalg.norm rounds differently: the extended sum is what matters
    assert np.count_nonzero(np.linalg.norm(vs, axis=1) != want) > 0


@pytest.mark.parametrize("rotation_range", [np.pi * 2, np.pi / 4])
def test_expm_of_loader_skew_matrices(rotation_range):
    """The draws of data/kitti.py::_sample_random_trans (the complement
    branch's 2*pi and the test branch's pi/4, both fed as degrees)."""
    rng = np.random.RandomState(3)
    exact = f32_differ = 0
    worst = 0.0
    for _ in range(N_DRAWS):
        axis = rng.rand(3) - 0.5
        theta = rotation_range * np.pi / 180.0 * (rng.rand(1) - 0.5)
        a = np.cross(np.eye(3), axis / vector_norm(axis) * theta)
        got, want = expm(a), scipy_expm(a)
        exact += bool(np.array_equal(got, want))
        worst = max(worst, float(np.abs(got - want).max()))
        f32_differ += int(np.count_nonzero(
            got.astype(np.float32) != want.astype(np.float32)))
    print(f"expm: {exact} of {N_DRAWS} bit-identical, worst "
          f"{worst / np.spacing(1.0):.1f} ulps of 1.0")
    assert worst <= 2 * np.spacing(1.0)
    assert f32_differ == 0


@pytest.mark.parametrize("scale", [0.5, 3.0, 30.0])
def test_expm_general_matrices(scale):
    """Every Padé order and the squaring phase, against scipy, within
    1e-11 of the largest entry (squaring amplifies rounding at large
    norms)."""
    rng = np.random.RandomState(4)
    for _ in range(50):
        a = rng.normal(size=(3, 3)) * scale / 3
        want = scipy_expm(a)
        np.testing.assert_allclose(expm(a), want, rtol=0,
                                   atol=1e-11 * np.abs(want).max())
