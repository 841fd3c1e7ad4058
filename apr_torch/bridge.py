"""Bridge from the flax variables to the port's modules.

A flax ``params`` / ``batch_stats`` pair (nested dicts of numpy arrays, as
``jax.device_get`` returns them) becomes a state dict of
:class:`apr_torch.models.resunet.ResUNet2`, and a trainer's whole tree
(``{"encoder": ..., "generator": ...}`` in both) loads into an
:class:`apr_torch.training.trainer.FCGFTrainer` (the generator an MLP
or, symmetric, a second ResUNet); a flax PredatorTrainer's
(``{"model": ..., "generator": ...}``, the generator an MLP or the
symmetric KPFCNNDecoder) into an
:class:`apr_torch.training.predator.PredatorTrainer`.  Names map one to one
(the GenerativeMLP keeps flax's ``Dense_i`` / ``MaskedBatchNorm_i``),
except for the ResUNet's norm layers, which flax names by call order:

- in ``ResUNet2``: ``MaskedBatchNorm_0`` .. ``_6`` are norm1, norm2, norm3,
  norm4, norm4_tr, norm3_tr, norm2_tr;
- in a block: ``MaskedBatchNorm_j`` (or ``MaskedInstanceNorm_j`` in the IN
  variants) is ``norm{j + 1}``.

Every flax leaf is consumed exactly once: a leaf that maps onto a name
already taken, a leaf the model lacks and a model entry no leaf fills all
raise.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from apr_torch.models.resunet import ResUNet2, make_resunet

ENCODER_NORMS = ("norm1", "norm2", "norm3", "norm4",
                 "norm4_tr", "norm3_tr", "norm2_tr")
_NORM = re.compile(r"Masked(?:Batch|Instance)Norm_(\d+)")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), np.asarray(sub)


def _torch_name(path: Tuple[str, ...]) -> str:
    names = list(path)
    top = _NORM.fullmatch(names[0])
    if top:
        names[0] = ENCODER_NORMS[int(top.group(1))]
    elif names[0].startswith("block") and len(names) > 2:
        inner = _NORM.fullmatch(names[1])
        if inner:
            names[1] = f"norm{int(inner.group(1)) + 1}"
    return ".".join(names)


def _state_dict(params: Mapping, batch_stats: Mapping,
                name_of) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, leaf in _leaves(tree):
            name = name_of(path)
            if name in out:
                raise ValueError(f"flax leaf {'/'.join(path)} maps onto "
                                 f"{name}, which another leaf already filled")
            out[name] = torch.from_numpy(np.array(leaf, np.float32))
    return out


def resunet_state_dict(params: Mapping,
                       batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`ResUNet2` from flax variables (float32)."""
    return _state_dict(params, batch_stats, _torch_name)


def mlp_state_dict(params: Mapping,
                   batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`apr_torch.models.mlp.GenerativeMLP` from flax
    variables (float32); names map one to one."""
    return _state_dict(params, batch_stats, ".".join)


def load_flax_resunet_(model: ResUNet2, params: Mapping,
                       batch_stats: Mapping) -> ResUNet2:
    """Copy flax variables into ``model`` in place (strict: every model
    entry filled, every leaf used)."""
    model.load_state_dict(resunet_state_dict(params, batch_stats),
                          strict=True)
    return model


def resunet_from_flax(name: str, params: Mapping, batch_stats: Mapping,
                      device="cuda", **kwargs) -> ResUNet2:
    """A shipped ResUNet variant on ``device`` with bridged flax weights."""
    return load_flax_resunet_(make_resunet(name, device=device, **kwargs),
                              params, batch_stats)


def kpfcnn_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of :class:`apr_torch.models.kpfcnn.KPFCNN` from a flax
    KPFCNN's ``params`` (float32).  Names map one to one: the port names
    its submodules as flax does (``UnaryBlock``'s unnamed ``Dense_0`` and
    ``MaskedInstanceNorm_0`` included), its ``Dense`` keeps flax's [in, out]
    kernel layout, and the frozen ``kernel_points`` and the scalar
    ``epsilon`` are parameters on both sides."""
    return _state_dict(params, {}, ".".join)


def load_flax_predator_(trainer, params: Mapping, batch_stats: Mapping):
    """Copy a flax PredatorTrainer's ``params`` / ``batch_stats`` (each with
    a ``model`` and a ``generator`` subtree) into ``trainer``'s modules in
    place, strictly: every subtree, entry and leaf is used.  The KPFCNN has
    no batch stats, nor has a symmetric trainer's generator (a
    ``KPFCNNDecoder``, whose names map one to one as the KPFCNN's do)."""
    for tree in (params, batch_stats):
        if set(tree) != {"model", "generator"}:
            raise ValueError(f"flax Predator tree has {sorted(tree)}, the "
                             f"trainer wants ['generator', 'model']")
    stateless = ["model"] + (["generator"] if trainer.symmetric else [])
    for name in stateless:
        if batch_stats[name]:
            raise ValueError(f"the flax {name} has batch stats; the port's "
                             f"has none")
    trainer.model.load_state_dict(kpfcnn_state_dict(params["model"]),
                                  strict=True)
    trainer.generator.load_state_dict(
        kpfcnn_state_dict(params["generator"]) if trainer.symmetric
        else mlp_state_dict(params["generator"], batch_stats["generator"]),
        strict=True)
    return trainer


def load_flax_train_state_(trainer, params: Mapping, batch_stats: Mapping):
    """Copy a flax trainer's ``params`` / ``batch_stats`` (each with an
    ``encoder`` and, for the generative trainer, a ``generator`` subtree:
    a GenerativeMLP, or a ResUNet for a symmetric trainer) into
    ``trainer``'s modules in place, strictly: every subtree, entry and leaf
    is used.  The optimizer state is left as it is."""
    want = {"encoder"} | ({"generator"} if trainer.generator is not None
                          else set())
    for tree in (params, batch_stats):
        if set(tree) != want:
            raise ValueError(f"flax trainer tree has {sorted(tree)}, the "
                             f"trainer wants {sorted(want)}")
    load_flax_resunet_(trainer.encoder, params["encoder"],
                       batch_stats["encoder"])
    if trainer.generator is not None:
        to_torch = (resunet_state_dict if trainer.symmetric
                    else mlp_state_dict)
        trainer.generator.load_state_dict(
            to_torch(params["generator"], batch_stats["generator"]),
            strict=True)
    return trainer
