"""Binary little-endian PLY read / write with named vertex properties (port
of ``apr_tpu/utils/ply.py``; each reads what the other writes)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_INV_DTYPES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a binary-little-endian PLY; returns {property: column array}."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a ply file: {path}")
        props: List[Tuple[str, str]] = []
        count = 0
        fmt = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                count = int(parts[2])
            elif parts[0] == "property" and parts[1] != "list":
                props.append((parts[2], _PLY_DTYPES[parts[1]]))
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported ply format: {fmt}")
        dtype = np.dtype([(name, "<" + d) for name, d in props])
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
    return {name: np.array(data[name]) for name, _ in props}


def write_ply(path: str, arrays: Sequence[np.ndarray],
              names: Sequence[str]) -> bool:
    """Write columns (2-D arrays contribute each of their columns) as a
    binary PLY."""
    cols: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            cols.append(a)
        else:
            cols.extend(a[:, i] for i in range(a.shape[1]))
    if len(cols) != len(names):
        raise ValueError(f"{len(cols)} columns but {len(names)} names")
    n = len(cols[0])
    dtype = np.dtype([
        (name, "<" + c.dtype.str[1:]) for name, c in zip(names, cols)
    ])
    rec = np.empty(n, dtype=dtype)
    for name, c in zip(names, cols):
        rec[name] = c
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, c in zip(names, cols):
            f.write(
                f"property {_INV_DTYPES[c.dtype.str[1:]]} {name}\n".encode()
            )
        f.write(b"end_header\n")
        f.write(rec.tobytes())
    return True
