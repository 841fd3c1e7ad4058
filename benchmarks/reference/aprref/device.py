# Frozen copy of apr_torch/device.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Device resolution for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  When no card is
present they raise instead of quietly running on the CPU: a caller that
wants the CPU asks for it with ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "reference.aprref runs on a CUDA device by default and none is present; "
            "pass device='cpu' to run on the CPU")
    return dev
