"""3DMatch-style trajectory and information files (port of
``apr_tpu/utils/trajectory.py``): a ``.log`` file holds blocks of an
"id0 id1 total" line and a 4x4 matrix, an ``.info`` file the same header
and a 6x6 information matrix."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class CameraPose:
    meta: Tuple[int, int, int]
    pose: np.ndarray  # 4x4 (or 6x6 for info files)


def read_trajectory(path: str, dim: int = 4) -> List[CameraPose]:
    out: List[CameraPose] = []
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    i = 0
    while i < len(lines):
        meta = tuple(int(x) for x in lines[i].split()[:3])
        mat = np.array(
            [[float(v) for v in lines[i + 1 + r].split()] for r in range(dim)]
        )
        out.append(CameraPose(meta, mat))
        i += 1 + dim
    return out


def write_trajectory(path: str, poses: List[CameraPose], dim: int = 4) -> None:
    with open(path, "w") as f:
        for p in poses:
            f.write("{}\t{}\t{}\n".format(*p.meta))
            for r in range(dim):
                f.write(" ".join(f"{v:.8e}" for v in p.pose[r]) + "\n")


def read_info(path: str) -> List[CameraPose]:
    return read_trajectory(path, dim=6)
