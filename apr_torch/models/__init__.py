"""Model registry: reference names -> module factories.

Mirrors ``apr_tpu.models.load_model`` (the registry of the reference,
FCGF_APR/model/__init__.py): the ResUNet and SimpleNet names are sparse
encoders, the GenerativeMLP names the generative heads.
"""

from __future__ import annotations

from apr_torch.models.mlp import MLP_VARIANTS, GenerativeMLP, \
    make_generative_mlp
from apr_torch.models.resunet import ResUNet2, make_resunet
from apr_torch.models.resunet import _VARIANTS as RESUNET_VARIANTS
from apr_torch.models.simpleunet import SimpleUNet, make_simplenet, \
    simplenet_names
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
    if name in simplenet_names():
        return lambda **kw: make_simplenet(name, **kw)
    if name in MLP_VARIANTS:
        return lambda **kw: make_generative_mlp(name, **kw)
    raise ValueError(f"unknown model name: {name}")


def model_names():
    return _RESUNET_NAMES + simplenet_names() + sorted(MLP_VARIANTS)


__all__ = ["GenerativeMLP", "MLP_VARIANTS", "ResUNet2", "SimpleUNet",
           "SparseLevel", "SparsePyramid", "load_model",
           "make_generative_mlp", "make_resunet", "make_simplenet",
           "model_names"]
