"""Work counts that the frozen reference adds up while it runs: the
operations and bytes that the benchmark's per-layer shares divide by.

Counting is off unless a :func:`counting` block is open; the frozen
modules call :func:`add` at the places where the work is decided (the
kernel maps' valid pairs, the neighbour lists' valid entries, the valid
points of a Chamfer), so every count is of what these inputs need and not
of the padded buffers.
"""

from __future__ import annotations

import contextlib
from collections import Counter

_open = []          # the innermost open counting block's Counter last
_paused = [0]


def add(name: str, n) -> None:
    """Add ``n`` (an int or a one-element tensor) to ``name`` in the open
    block, if any."""
    if _open and not _paused[0]:
        _open[-1][name] += int(n)


@contextlib.contextmanager
def counting():
    """A Counter that collects every :func:`add` made inside the block."""
    counts = Counter()
    _open.append(counts)
    try:
        yield counts
    finally:
        _open.pop()


@contextlib.contextmanager
def paused():
    """Inside, :func:`add` counts nothing (a caller that counts the work of
    its parts itself)."""
    _paused[0] += 1
    try:
        yield
    finally:
        _paused[0] -= 1
