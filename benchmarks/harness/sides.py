"""The two sides of a comparison, built alike from a configuration's
fields: the program (``apr_torch``, the port under test) and the frozen
reference that the configuration names (``reference.aprref`` where it
names none); and the weights that the benchmark draws from the seed and
hands to both.

A configuration names the classes that both sides run, and how they take
a pair, under the top-level key ``"side"`` of its file::

    "side": {"trainer": "training.predator:PredatorTrainer",
             "tester": "eval.predator_tester:PredatorTester",
             "pairs": "one"}

Each path is ``module:Class`` relative to the package, so the program
resolves it under ``apr_torch.`` and the reference under its own package
(:func:`reference_of`), and both always run the same class path.  Where
the key is absent, ``fields.trainer == "PredatorTrainer"`` gives
:data:`PREDATOR` and every other trainer :data:`FCGF`.

What the loops call, whatever ``pairs`` says:

- the trainer: ``Trainer(config, device=, seed=0)``; ``modules()``, whose
  parameters are the weights (:func:`draw_weights`); ``optimizer``, the
  ``torch.optim.Optimizer`` that a step that is not skipped steps once;
  ``build_batch(raw)``, a nested tuple of tensors; ``train_step(batch,
  generator)``, a dict with ``loss`` and ``skipped_nonfinite``;
  ``state_dict()`` / ``load_state_dict(state)``; and ``loss_fn(batch,
  generator)``, (loss, metrics), which ``faults.unchanged`` calls;
- the tester: ``Tester(config, trainer, device=)``;
  ``_bucketed_batch(pair)``, a nested tuple of tensors; ``step(batch,
  generator)``, (4x4 pose, RTE, RRE, fitness), which calls ``eval_one``
  (``faults.answer`` alters its pose).

``"pairs": "one"``: a step takes one pair unbatched (``raw`` is the nine
arrays of ``harness/inputs.py::PaddedPool.raw`` without their batch dim).
The tester's ``forward(batch)`` gives the encoder's outputs, a tuple whose
members alternate cloud 0 and cloud 1, each with the rows of level 0 of
``batch.pyr0`` or ``batch.pyr1``, whose ``mask`` picks the rows compared;
``eval_one(outputs, batch, generator)`` registers the pair from them.

``"pairs": "group"``: a step takes ``batch_size`` pairs with a leading
batch dim.  The trainer's ``_encode_pair(batch, train=False)`` gives
(f0, f1), [B, N, C] each; the tester's ``eval_one(f0, f1, xyz0, xyz1, m0,
m1, t_gt, generator)`` registers one pair from the first of each, with
``batch.xyz0`` / ``xyz1``, ``batch.pyramid0`` / ``pyramid1.levels[0].mask``
and ``batch.t_gt``; ``loss_fn`` takes ``batch.feats0``'s leading dim as
the pairs (``faults.half_batch``)."""

from __future__ import annotations

import importlib
import math
from types import ModuleType
from typing import Dict, List, NamedTuple, Tuple

import torch

PROGRAM = "apr_torch"
REFERENCE = "reference.aprref"
PAIRS = ("one", "group")


class Reference(NamedTuple):
    """A frozen reference package: its trainer and tester make the
    reference ``Side`` (``Side(pkg, ...)``), its ``precision.lower`` the
    control, and its ``tally`` counts the work that the shares of a peak
    divide by, so the three always come from one package."""
    pkg: str
    precision: ModuleType
    tally: ModuleType


def reference_of(cell) -> Reference:
    """The reference of ``cell``'s configuration: the package that its
    file names under the top-level key ``"reference"``, else
    ``reference.aprref``.  A name that does not import, or that names the
    program, stops the run here, before its set-up."""
    pkg = cell.config.get("reference", REFERENCE)
    try:
        if not isinstance(pkg, str) or pkg.split(".")[0] == PROGRAM:
            raise ImportError("not a reference package")
        importlib.import_module(pkg)
        precision = importlib.import_module(pkg + ".precision")
        tally = importlib.import_module(pkg + ".tally")
    except ImportError as e:
        raise SystemExit(f"{cell.config_file}: the reference {pkg!r} does "
                         f"not import: {e}") from e
    return Reference(pkg, precision, tally)


class Roles(NamedTuple):
    """What a configuration's ``"side"`` names: its trainer's and its
    tester's ``module:Class`` paths relative to a package, and how they
    take a pair (:data:`PAIRS`)."""
    trainer: str
    tester: str
    pairs: str

    def classes(self, pkg: str) -> Tuple[type, type]:
        """The trainer and tester classes under package ``pkg``."""
        return _class(pkg, self.trainer), _class(pkg, self.tester)


PREDATOR = Roles("training.predator:PredatorTrainer",
                 "eval.predator_tester:PredatorTester", "one")
FCGF = Roles("training.trainer:FCGFTrainer", "eval.tester:FeatureTester",
             "group")


def _class(pkg: str, path: str) -> type:
    module, _, name = path.partition(":")
    cls = getattr(importlib.import_module(f"{pkg}.{module}"), name)
    if not isinstance(cls, type):
        raise TypeError(f"{pkg}.{module}.{name} is not a class")
    return cls


def roles_of(cell) -> Roles:
    """The roles that ``cell``'s configuration names under ``"side"``,
    else today's by ``fields.trainer``.  Each class resolves in the
    program and in the configuration's reference here, so a path that does
    not import, a missing class or an unknown ``pairs`` stops the run
    before its set-up, naming the file and the key."""
    side = cell.config.get("side")
    if side is None:
        trainer = cell.config["fields"].get("trainer")
        return PREDATOR if trainer == "PredatorTrainer" else FCGF

    def stop(key: str, why: str):
        raise SystemExit(f"{cell.config_file}: {key} {why}")

    if not isinstance(side, dict):
        stop('"side"', f"is {side!r}, not an object")
    for key in sorted(set(side) ^ set(Roles._fields)):
        stop(f'"side".{key}', "is not one of trainer, tester, pairs"
             if key in side else "is missing")
    roles = Roles(**side)
    if roles.pairs not in PAIRS:
        stop('"side".pairs',
             f"{roles.pairs!r} is not one of {', '.join(PAIRS)}")
    pkgs = (PROGRAM, reference_of(cell).pkg)
    for key in ("trainer", "tester"):
        path = getattr(roles, key)
        if not isinstance(path, str) or path.count(":") != 1:
            stop(f'"side".{key}', f"{path!r} is not a module:Class path")
        for pkg in pkgs:
            try:
                _class(pkg, path)
            except (ImportError, AttributeError, TypeError, ValueError) as e:
                stop(f'"side".{key}',
                     f"{path!r} does not resolve under {pkg}: {e}")
    return roles


class Side:
    """The trainer and tester that ``roles`` name, of package ``pkg``, for
    ``fields``."""

    def __init__(self, pkg: str, fields: Dict, device: torch.device,
                 roles: Roles):
        cfg = importlib.import_module(pkg + ".config").APRConfig.from_dict(
            fields)
        self.pkg, self.config, self.device = pkg, cfg, device
        self.pairs = roles.pairs
        trainer, tester = roles.classes(pkg)
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
