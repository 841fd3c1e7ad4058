"""The two sides of a comparison, built alike from a configuration's
fields: the program (``apr_torch``, the port under test) and the frozen
reference (``reference.aprref``); and the weights that the benchmark
draws from the seed and hands to both."""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import torch

PROGRAM = "apr_torch"
REFERENCE = "reference.aprref"


class Side:
    """A trainer and its tester of package ``pkg`` for ``fields``."""

    def __init__(self, pkg: str, fields: Dict, device: torch.device):
        cfg = importlib.import_module(pkg + ".config").APRConfig.from_dict(
            fields)
        self.pkg, self.config, self.device = pkg, cfg, device
        self.predator = cfg.trainer == "PredatorTrainer"
        if self.predator:
            trainer = importlib.import_module(
                pkg + ".training.predator").PredatorTrainer
            tester = importlib.import_module(
                pkg + ".eval.predator_tester").PredatorTester
        else:
            trainer = importlib.import_module(
                pkg + ".training.trainer").FCGFTrainer
            tester = importlib.import_module(
                pkg + ".eval.tester").FeatureTester
        self.trainer = trainer(cfg, device=device, seed=0)
        self.tester = tester(cfg, self.trainer, device=device)

    def named_parameters(self) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(f"{i}.{n}", p) for i, m in enumerate(self.trainer.modules())
                for n, p in m.named_parameters()]


def draw_weights(side: Side, seed: int) -> Dict[str, torch.Tensor]:
    """Weights from ``seed``, made on the side's device in one draw: every
    kernel (sparse conv [K, Ci, Co], KPConv [K, Ci, Co], dense [Ci, Co])
    normal with variance 1 / fan-in, every norm scale 1 and every bias 0.
    Other leaves (KPConv's kernel points, Predator's epsilon) are fixed
    constants of the architecture that each side makes for itself."""
    named = sorted(side.named_parameters())
    kernels = [(n, p) for n, p in named
               if n.rsplit(".", 1)[-1] in ("kernel", "weights")]
    gen = torch.Generator(device=side.device).manual_seed(
        int(seed) % (1 << 63))
    flat = torch.randn(sum(p.numel() for _, p in kernels), generator=gen,
                       device=side.device)
    out, off = {}, 0
    for n, p in kernels:
        k = p.numel()
        out[n] = flat[off:off + k].view(p.shape) / math.sqrt(
            k // p.shape[-1])
        off += k
    for n, p in named:
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "scale":
            out[n] = torch.ones_like(p)
        elif leaf == "bias":
            out[n] = torch.zeros_like(p)
    return out


@torch.no_grad()
def load_weights(side: Side, weights: Dict[str, torch.Tensor]) -> None:
    named = dict(side.named_parameters())
    missing = sorted(set(weights) - set(named))
    if missing:
        raise KeyError(f"{side.pkg} has no parameter {missing[0]}")
    for n, w in weights.items():
        named[n].copy_(w)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested tuple / NamedTuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in leaves(x)]
    return []


def host_leaves(tree) -> List[torch.Tensor]:
    return [t.detach().to("cpu", copy=True) for t in leaves(tree)]
