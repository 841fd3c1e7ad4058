"""Model registry: reference names -> module factories.

Mirrors ``apr_tpu.models.load_model`` for the ResUNet names (the registry
of the reference, FCGF_APR/model/__init__.py); the generative MLPs come
from :func:`apr_torch.models.mlp.make_generative_mlp`.  SimpleNet arrives
with a later slice.
"""

from __future__ import annotations

from apr_torch.models.mlp import MLP_VARIANTS, GenerativeMLP, \
    make_generative_mlp
from apr_torch.models.resunet import ResUNet2, make_resunet
from apr_torch.models.resunet import _VARIANTS as RESUNET_VARIANTS
from apr_torch.models.sparse import SparseLevel, SparsePyramid

_RESUNET_NAMES = sorted(RESUNET_VARIANTS) + [
    "ResUNetIN2", "ResUNetIN2B", "ResUNetIN2C", "ResUNetIN2D", "ResUNetIN2E",
]


def load_model(name: str):
    """A factory(**kwargs) -> module for a registered name; the factory takes
    ``device=`` (default ``"cuda"``) and ``seed=`` besides the model's own
    keyword arguments."""
    if name in _RESUNET_NAMES:
        return lambda **kw: make_resunet(name, **kw)
    raise ValueError(f"unknown model name: {name} (this slice ports "
                     f"{_RESUNET_NAMES})")


__all__ = ["GenerativeMLP", "MLP_VARIANTS", "ResUNet2", "SparseLevel",
           "SparsePyramid", "load_model", "make_generative_mlp",
           "make_resunet"]
