# Frozen copy of apr_torch/models/__init__.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref, trimmed to what the cells run;
# see reference/aprref/__init__.py.
"""Model registry: reference names -> module factories.

Mirrors ``apr_tpu.models.load_model`` (the registry of the reference,
FCGF_APR/model/__init__.py): the ResUNet names are sparse encoders, the
GenerativeMLP names the generative heads (the SimpleNet encoders, which no
cell runs, are left out).
"""

from __future__ import annotations

from reference.aprref.models.mlp import MLP_VARIANTS, GenerativeMLP, \
    make_generative_mlp
from reference.aprref.models.resunet import ResUNet2, make_resunet
from reference.aprref.models.resunet import _VARIANTS as RESUNET_VARIANTS
from reference.aprref.models.sparse import SparseLevel, SparsePyramid, \
    build_pyramid, sparse_conv_apply

_RESUNET_NAMES = sorted(RESUNET_VARIANTS) + [
    "ResUNetIN2", "ResUNetIN2B", "ResUNetIN2C", "ResUNetIN2D", "ResUNetIN2E",
]


def load_model(name: str):
    """A factory(**kwargs) -> module for a registered name; the factory takes
    ``device=`` (default ``"cuda"``) and ``seed=`` besides the model's own
    keyword arguments."""
    if name in _RESUNET_NAMES:
        return lambda **kw: make_resunet(name, **kw)
    if name in MLP_VARIANTS:
        return lambda **kw: make_generative_mlp(name, **kw)
    raise ValueError(f"unknown model name: {name}")


def model_names():
    return _RESUNET_NAMES + sorted(MLP_VARIANTS)


__all__ = [
    "GenerativeMLP",
    "ResUNet2",
    "SparseLevel",
    "SparsePyramid",
    "build_pyramid",
    "sparse_conv_apply",
    "load_model",
    "make_resunet",
    "make_generative_mlp",
    "model_names",
]
