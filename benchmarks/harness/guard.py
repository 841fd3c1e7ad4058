"""What a run may not have loaded: JAX, its libraries and the JAX package
the port was made from, compared by whole top-level module names."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "apr_tpu")


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))
