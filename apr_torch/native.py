"""ctypes bindings for the port's host-geometry library
(``apr_torch/csrc/geometry.cpp``; port of ``apr_tpu/native.py``).

The library builds with ``g++`` at first use into
``build/apr_torch_kernels/geometry-<hash>/`` at the root of the checkout,
keyed by a hash of the source, the flags and the host's CPU (the build
targets the CPU it runs on), as ``apr_torch/kernels/build.py`` keys the
CUDA kernels.  Without a compiler each function takes the reference's numpy
fallback and says so on stderr.  These back the host side of the pipeline
(raw-scan pre-reduction, neighbour calibration, offline ICP); the training
path does the same operations on the device in ``apr_torch.ops``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "geometry.cpp"
BUILD_ROOT = SOURCE.parent.parent.parent / "build" / "apr_torch_kernels"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_id() -> bytes:
    """The host CPU's model line: ``-march=native`` code built for one CPU
    may not run on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"model name")),
                        b"")
    except OSError:
        return b""


def lib_path() -> Path:
    """Where the library for this source, these flags and this CPU
    lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS)
                            .encode() + _cpu_id()).hexdigest()[:16]
    return BUILD_ROOT / f"geometry-{digest}" / "libgeometry.so"


def _build(lib: Path) -> bool:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".libgeometry.{os.getpid()}.so"
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"apr_torch.native: building {SOURCE.name} failed ({e}); "
              f"using the numpy fallbacks", file=sys.stderr)
        return False
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library (built on the first call), or None when it
    cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib_file = lib_path()
        if not lib_file.exists() and not _build(lib_file):
            return None
        lib = ctypes.CDLL(str(lib_file))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.apr_grid_subsample.restype = ctypes.c_int32
        lib.apr_grid_subsample.argtypes = [
            f32p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_int32,
            f32p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.apr_voxel_dedup.restype = ctypes.c_int32
        lib.apr_voxel_dedup.argtypes = [
            f32p, ctypes.c_int32, ctypes.c_float, i32p, ctypes.c_int32,
        ]
        lib.apr_radius_neighbors.restype = None
        lib.apr_radius_neighbors.argtypes = [
            f32p, ctypes.c_int32, f32p, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int32, i32p,
        ]
        _lib = lib
        return _lib


def grid_subsample_numpy(points: np.ndarray, voxel: float, capacity: int,
                         features: Optional[np.ndarray] = None):
    """The fallback of :func:`grid_subsample`: voxels in lexicographic
    coordinate order, sums in float64."""
    coords = np.floor(points / voxel).astype(np.int64)
    _, inv, cnt = np.unique(coords, axis=0, return_inverse=True,
                            return_counts=True)
    inv = inv.reshape(-1)
    nv = min(len(cnt), capacity)
    acc = np.zeros((len(cnt), 3), np.float64)
    np.add.at(acc, inv, points)
    bary = (acc / cnt[:, None]).astype(np.float32)[:nv]
    if features is None:
        return bary, None
    facc = np.zeros((len(cnt), features.shape[1]), np.float64)
    np.add.at(facc, inv, features)
    return bary, (facc / cnt[:, None]).astype(np.float32)[:nv]


def grid_subsample(points: np.ndarray, voxel: float,
                   capacity: Optional[int] = None,
                   features: Optional[np.ndarray] = None):
    """Barycenter voxel subsample of points [N, 3] (and the mean of
    features [N, F]) in the order voxels first appear; returns (points
    [nv, 3], features [nv, F] or None)."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    capacity = capacity or n
    lib = get_lib()
    if lib is None:
        return grid_subsample_numpy(points, voxel, capacity, features)
    out = np.zeros((capacity, 3), np.float32)
    if features is None:
        nv = lib.apr_grid_subsample(points, n, voxel, None, 0, out, None,
                                    capacity)
        return out[:nv], None
    features = np.ascontiguousarray(features, np.float32)
    fdim = features.shape[1]
    fout = np.zeros((capacity, fdim), np.float32)
    nv = lib.apr_grid_subsample(
        points, n, voxel, features.ctypes.data_as(ctypes.c_void_p), fdim,
        out, fout.ctypes.data_as(ctypes.c_void_p), capacity)
    return out[:nv], fout[:nv]


def voxel_dedup_numpy(points: np.ndarray, voxel: float,
                      capacity: int) -> np.ndarray:
    """The fallback of :func:`voxel_dedup`."""
    coords = np.floor(points / voxel).astype(np.int64)
    _, sel = np.unique(coords, axis=0, return_index=True)
    return np.sort(sel)[:capacity].astype(np.int32)


def voxel_dedup(points: np.ndarray, voxel: float,
                capacity: Optional[int] = None) -> np.ndarray:
    """Indices of the first point of each voxel, ascending (ME
    ``sparse_quantize`` 'sel')."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    capacity = capacity or n
    lib = get_lib()
    if lib is None:
        return voxel_dedup_numpy(points, voxel, capacity)
    sel = np.zeros(capacity, np.int32)
    nv = lib.apr_voxel_dedup(points, n, voxel, sel, capacity)
    return sel[:nv]


def radius_neighbors_numpy(queries: np.ndarray, supports: np.ndarray,
                           radius: float, cap: int) -> np.ndarray:
    """The fallback of :func:`radius_neighbors`: the reference's cKDTree
    query (float64 distances, strictly below ``radius``, nearest first,
    at most ``cap``) as brute force over row blocks."""
    ns = len(supports)
    out = np.full((len(queries), cap), ns, np.int32)
    s64 = supports.astype(np.float64)
    rows = max(1, (1 << 22) // max(ns, 1))
    for lo in range(0, len(queries), rows):
        q = queries[lo:lo + rows].astype(np.float64)
        d = np.sqrt(((q[:, None, :] - s64[None]) ** 2).sum(-1))
        d = np.where(d < radius, d, np.inf)
        order = np.argsort(d, axis=1, kind="stable")[:, :cap]
        ok = np.isfinite(np.take_along_axis(d, order, 1))
        block = out[lo:lo + rows, :order.shape[1]]
        block[ok] = order[ok]
    return out


def radius_neighbors(queries: np.ndarray, supports: np.ndarray,
                     radius: float, cap: int) -> np.ndarray:
    """Distance-sorted neighbours within ``radius``, at most ``cap`` per
    query [Nq, cap]; the sentinel is len(supports)."""
    queries = np.ascontiguousarray(queries, np.float32)
    supports = np.ascontiguousarray(supports, np.float32)
    lib = get_lib()
    if lib is None:
        return radius_neighbors_numpy(queries, supports, radius, cap)
    out = np.empty((len(queries), cap), np.int32)
    lib.apr_radius_neighbors(queries, len(queries), supports, len(supports),
                             radius, cap, out)
    return out
