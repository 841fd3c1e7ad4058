"""Build the port's hand-written CUDA kernels at first use.

Every ``apr_torch/csrc/*.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries land in
``build/apr_torch_kernels/<source>-<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags, so a fresh checkout builds once
and an edited source rebuilds.  All sources build in parallel, one ``nvcc``
each.  The compiler's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside each library as ``<source>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC_DIR.parent.parent / "build" / "apr_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_built: Dict[str, Path] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _build_one(nvcc: str, src: Path) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{src.stem}-{digest}"
    lib = out_dir / f"lib{src.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    (out_dir / f"{src.stem}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def build_all() -> float:
    """Build every kernel source (in parallel); returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        nvcc = _nvcc()
        with ThreadPoolExecutor(max_workers=max(len(srcs), 1)) as ex:
            libs = list(ex.map(lambda s: _build_one(nvcc, s), srcs))
        _built.update({s.stem: lib for s, lib in zip(srcs, libs)})
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``; builds all kernels on the
    first call in a process."""
    if name not in _built:
        build_all()
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_built[name]))
        return _loaded[name]
