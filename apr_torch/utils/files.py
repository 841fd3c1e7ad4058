"""File helpers (port of ``apr_tpu/utils/files.py``, the reference's
FCGF_APR/util/file.py)."""

from __future__ import annotations

import os
import re
from typing import List


def ensure_dir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def get_folder_list(path: str) -> List[str]:
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if os.path.isdir(os.path.join(path, f))
    )


def get_file_list(path: str, extension: str = "") -> List[str]:
    return sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(extension) and os.path.isfile(os.path.join(path, f))
    )


def sorted_alphanum(file_list: List[str]) -> List[str]:
    """Sort treating embedded numbers numerically."""
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(file_list, key=key)
