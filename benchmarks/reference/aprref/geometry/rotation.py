# Frozen copy of apr_torch/geometry/rotation.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Rotation helpers in numpy, in place of the scipy calls of the data loaders.

The reference's loaders build rotations with scipy:
``Rotation.from_euler(...).as_matrix()`` (``apr_tpu/data/kitti.py:367,479``,
``indoor.py:78``), ``Rotation.from_rotvec(...).as_matrix()``
(``modelnet.py:161``) and ``scipy.linalg.expm`` of a skew matrix built with
``scipy.linalg.norm`` (``kitti.py:672-676``).  The port may not import
scipy, so these follow scipy's own route, operation for operation where
that is known:

- :func:`euler_matrix`: one elementary quaternion per axis (libm ``sin`` /
  ``cos`` of half the angle), composed in scipy's order (extrinsic: the
  new axis on the left), then the quaternion's matrix;
- :func:`rotvec_matrix`: the quaternion of the rotation vector (scipy's
  Taylor branch below 1e-3 rad), then its matrix;
- :func:`vector_norm`: BLAS ``nrm2`` as scipy's norm calls it: the squares
  summed and rooted in extended precision, then rounded once;
- :func:`expm`: Al-Mohy and Higham's scaling and squaring with Padé orders
  3, 5, 7, 9 and 13 and exact one-norms, as scipy chooses them.

The first three give scipy's bits (``tests/test_torch_rotation.py`` counts
them).  :func:`expm` agrees within a few float64 ulps: scipy's compiled
products and LU solve round in an order numpy does not reproduce.  Every
caller casts its transform to float32 before using it, where a few float64
ulps do not show.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_AXES = {"x": 0, "y": 1, "z": 2}


def _elementary(axis: int, angle: float):
    q = [0.0, 0.0, 0.0, math.cos(angle / 2.0)]
    q[axis] = math.sin(angle / 2.0)
    return q


def _compose(p, q):
    """The quaternion product p * q ([x, y, z, w] order)."""
    c0 = p[1] * q[2] - p[2] * q[1]
    c1 = p[2] * q[0] - p[0] * q[2]
    c2 = p[0] * q[1] - p[1] * q[0]
    return [p[3] * q[0] + q[3] * p[0] + c0,
            p[3] * q[1] + q[3] * p[1] + c1,
            p[3] * q[2] + q[3] * p[2] + c2,
            p[3] * q[3] - p[0] * q[0] - p[1] * q[1] - p[2] * q[2]]


def _quat_matrix(q) -> np.ndarray:
    """The rotation matrix of a unit quaternion [x, y, z, w]."""
    x, y, z, w = (float(v) for v in q)
    x2, y2, z2, w2 = x * x, y * y, z * z, w * w
    xy, zw, xz, yw, yz, xw = x * y, z * w, x * z, y * w, y * z, x * w
    return np.array([[x2 - y2 - z2 + w2, 2 * (xy - zw), 2 * (xz + yw)],
                     [2 * (xy + zw), -x2 + y2 - z2 + w2, 2 * (yz - xw)],
                     [2 * (xz - yw), 2 * (yz + xw), -x2 - y2 + z2 + w2]])


def euler_matrix(seq: str, angles: Sequence[float]) -> np.ndarray:
    """``Rotation.from_euler(seq, angles).as_matrix()`` for one rotation:
    lower-case ``seq`` is extrinsic, upper-case intrinsic; radians."""
    if len(seq) != len(angles) or not (seq.islower() or seq.isupper()):
        raise ValueError(f"bad Euler sequence {seq!r} for {len(angles)} "
                         f"angles")
    axes = [_AXES[a] for a in seq.lower()]
    q = _elementary(axes[0], float(angles[0]))
    for axis, angle in zip(axes[1:], angles[1:]):
        e = _elementary(axis, float(angle))
        q = _compose(q, e) if seq.isupper() else _compose(e, q)
    return _quat_matrix(q)


def rotvec_matrix(rotvec: Sequence[float]) -> np.ndarray:
    """``Rotation.from_rotvec(rotvec).as_matrix()`` for one rotation."""
    x, y, z = (float(v) for v in rotvec)
    angle = math.sqrt(x * x + y * y + z * z)
    if angle <= 1e-3:
        a2 = angle * angle
        scale = 0.5 - a2 / 48 + a2 * a2 / 3840
    else:
        scale = math.sin(angle / 2) / angle
    return _quat_matrix([x * scale, y * scale, z * scale,
                         math.cos(angle / 2)])


def vector_norm(v: np.ndarray) -> float:
    """The Euclidean norm of a float64 vector as ``scipy.linalg.norm``
    gives it (BLAS ``nrm2``: extended-precision sum of squares and root,
    one rounding)."""
    acc = np.longdouble(0.0)
    for x in np.asarray(v, np.float64):
        acc += np.longdouble(x) * np.longdouble(x)
    return float(np.sqrt(acc))


# Padé numerator / denominator coefficients b_0 .. b_m (Higham 2005)
_PADE = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240.,
        2162160., 110880., 3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600.,
         1187353796428800., 129060195264000., 10559470521600.,
         670442572800., 33522128640., 1323241920., 40840800., 960960.,
         16380., 182., 1.),
}
# the largest one-norm bound each order is accurate for (Al-Mohy & Higham)
_THETA = {3: 1.495585217958292e-002, 5: 2.539398330063230e-001,
          7: 9.504178996162932e-001, 9: 2.097847961257068e+000, 13: 4.25}
_ELL_C = {3: 100800., 5: 10059033600., 7: 4487938430976000.,
          9: 5914384781877411840000.,
          13: 113250775606021113483283660800000000.}


def _onenorm(a: np.ndarray) -> float:
    return float(np.abs(a).sum(axis=0).max())


def _ell(a: np.ndarray, m: int) -> int:
    """Extra squarings the order-m approximant needs for ``a`` (the
    backward-error bound of Al-Mohy & Higham 2009, eq. 5.2)."""
    p = np.abs(a)
    power = p
    for _ in range(2 * m):
        power = power @ p
    norm = _onenorm(power)
    if not norm:
        return 0
    alpha = norm / (_onenorm(a) * _ELL_C[m])
    return max(int(np.ceil(np.log2(alpha / 2.0 ** -53) / (2 * m))), 0)


def expm(a: np.ndarray) -> np.ndarray:
    """The matrix exponential of a square float64 matrix, by scaling and
    squaring with the Padé order that scipy's ``expm`` picks."""
    a = np.asarray(a, np.float64)
    ident = np.eye(a.shape[0])
    a2 = a @ a
    a4 = a2 @ a2
    a6 = a2 @ a4
    d4, d6 = _onenorm(a4) ** 0.25, _onenorm(a6) ** (1 / 6.)
    eta = max(d4, d6)
    powers = [ident, a2, a4, a6]
    for m in (3, 5):
        if eta < _THETA[m] and _ell(a, m) == 0:
            return _pade(a, powers, m, ident)
    a8 = a6 @ a2
    eta = max(d6, _onenorm(a8) ** 0.125)
    powers.append(a8)
    for m in (7, 9):
        if eta < _THETA[m] and _ell(a, m) == 0:
            return _pade(a, powers, m, ident)
    eta = min(eta, max(_onenorm(a8) ** 0.125,
                       _onenorm(a4 @ a6) ** 0.1))
    s = 0 if eta == 0 else max(int(np.ceil(np.log2(eta / _THETA[13]))), 0)
    s += _ell(2.0 ** -s * a, 13)
    b = _PADE[13]
    bs = [a * 2.0 ** -s] + [x * 2.0 ** (-k * s) for k, x in
                            ((2, a2), (4, a4), (6, a6))]
    b1, b2, b4, b6 = bs
    u = b1 @ (b6 @ (b[13] * b6 + b[11] * b4 + b[9] * b2)
              + b[7] * b6 + b[5] * b4 + b[3] * b2 + b[1] * ident)
    v = (b6 @ (b[12] * b6 + b[10] * b4 + b[8] * b2)
         + b[6] * b6 + b[4] * b4 + b[2] * b2 + b[0] * ident)
    x = np.linalg.solve(v - u, v + u)
    for _ in range(s):
        x = x @ x
    return x


def _pade(a, powers, m, ident):
    """r_m(a) = (V - U)^-1 (V + U) with U the odd and V the even part of
    the order-m Padé approximant; ``powers`` are I, a^2, a^4, ..."""
    b = _PADE[m]
    odd = b[m] * powers[m // 2]
    even = b[m - 1] * powers[m // 2]
    for k in range(m // 2 - 1, 0, -1):
        odd = odd + b[2 * k + 1] * powers[k]
        even = even + b[2 * k] * powers[k]
    u = a @ (odd + b[1] * ident)
    v = even + b[0] * ident
    return np.linalg.solve(v - u, v + u)
