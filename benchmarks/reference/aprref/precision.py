"""The rounding of the frozen reference's contractions to the
configuration's compute dtype, and the control one step below it.

``round_to(t, torch.bfloat16)`` is ``t.to(torch.bfloat16)``, as the port
rounds its sparse-conv and KPConv operands.  Inside :func:`lower` the same
call rounds to float8 e4m3 instead (one power-of-two scale per tensor, so
the largest magnitude lands at or under e4m3's 448) and returns the
rounded values in the compute dtype: the reference computed one precision
below what the configuration states, the benchmark's control for
``correct``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

_lower = [False]
E4M3_MAX = 448.0


def round_to(t: torch.Tensor, cd: Optional[torch.dtype]) -> torch.Tensor:
    if cd is None:
        return t
    if not _lower[0]:
        return t.to(cd)
    amax = float(t.detach().abs().max()) if t.numel() else 0.0
    scale = 2.0 ** math.ceil(math.log2(amax / E4M3_MAX)) if amax > 0 else 1.0
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(cd)


@contextlib.contextmanager
def lower():
    """Round every contraction to float8 e4m3 inside the block."""
    _lower[0] = True
    try:
        yield
    finally:
        _lower[0] = False
