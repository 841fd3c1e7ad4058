"""The train state both trainers share: the optimizer with its gradient
accumulation, the non-finite gate, the learning-rate schedule, and the
state dict a checkpoint holds.

A trainer's state is its modules and its optimizer, updated in place (the
reference's ``TrainState`` of params, batch stats, optimizer state, step
and lr).  ``iter_size > 1`` is the reference's ``optax.MultiSteps(
every_k_schedule=iter_size)`` around the optimizer:

- the gradients accumulate as a running mean, ``acc += (g - acc) / (n +
  1)`` after mini-step ``n``;
- parameters and the optimizer's state stay as they are on mini-steps
  1 .. k-1; on the k-th the optimizer steps once on the mean (weight decay
  applies once) and the mean starts again from zero;
- running statistics update on every mini-step, and ``step`` counts every
  mini-step;
- a mini-step whose loss or a gradient is not finite changes nothing: not
  the parameters, the optimizer, the running stats, the mean or the
  mini-step counter.

Under a data-parallel mesh (:meth:`TrainerState.use_mesh`) each rank's
gradients are its share of the global loss's: the gated update sums them
over the mesh (one flat buffer per dtype), judges finiteness on the global
loss and the summed gradients with a MIN over the mesh, so every rank
steps or skips together and restores the same running stats, and the
accumulation folds in the summed gradients.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from apr_torch.parallel.collectives import all_reduce_, all_reduce_flat_
from apr_torch.parallel.mesh import replicate
from apr_torch.utils.profiling import span


class GradientAccumulation:
    """The running mean of the gradients of the mini-steps since the last
    optimizer step, and their count."""

    def __init__(self, params: List[torch.nn.Parameter], every_k: int):
        self.every_k = every_k
        self.mini_step = 0
        self.grads = ([torch.zeros_like(p) for p in params] if every_k > 1
                      else [])

    @torch.no_grad()
    def step(self, params: List[torch.nn.Parameter],
             optimizer: torch.optim.Optimizer) -> None:
        """Fold the parameters' gradients into the mean; on the k-th
        mini-step, step ``optimizer`` on the mean and start again."""
        if self.every_k == 1:
            optimizer.step()
            return
        n = self.mini_step
        for p, acc in zip(params, self.grads):
            acc.add_((p.grad - acc) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        for p, acc in zip(params, self.grads):
            p.grad.copy_(acc)
            acc.zero_()
        optimizer.step()
        self.mini_step = 0

    def state_dict(self) -> Dict:
        return {"every_k": self.every_k, "mini_step": self.mini_step,
                "grads": [g.clone() for g in self.grads]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if state["every_k"] != self.every_k or len(state["grads"]) != len(
                self.grads):
            raise ValueError(f"accumulation over {state['every_k']} "
                             f"mini-steps and {len(state['grads'])} tensors "
                             f"cannot load into one over {self.every_k} and "
                             f"{len(self.grads)}")
        self.mini_step = int(state["mini_step"])
        for acc, g in zip(self.grads, state["grads"]):
            acc.copy_(g)


class TrainerState:
    """Mixin of :class:`apr_torch.training.trainer.FCGFTrainer` and
    :class:`apr_torch.training.predator.PredatorTrainer`.  A trainer
    provides ``config``, ``modules()`` and ``_make_optimizer()``."""

    mesh = None

    def use_mesh(self, mesh) -> None:
        """Train data parallel over ``mesh``: the state is replicated from
        the mesh's first member and the gated update sums the gradients
        over the mesh.  Every member must call it."""
        self.mesh = mesh
        replicate(self, mesh)

    def parameters(self) -> List[torch.nn.Parameter]:
        """The trainable parameters (frozen ones, such as KPConv's kernel
        points, stay out of the optimizer and its weight decay)."""
        return [p for m in self.modules() for p in m.parameters()
                if p.requires_grad]

    def buffers(self) -> List[torch.Tensor]:
        return [b for m in self.modules() for b in m.buffers()]

    def reset_optimizer(self, keep_lr: bool = True) -> None:
        """A fresh optimizer and accumulation over the current parameters;
        the learning rate stays unless ``keep_lr`` is false (then it is the
        config's)."""
        lr = self.lr if keep_lr else self.config.lr
        self.optimizer = self._make_optimizer()
        self.accumulation = GradientAccumulation(self.parameters(),
                                                 self.config.iter_size)
        self._set_group_lr(lr)

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def _set_group_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def epoch_lr(self, epoch: int) -> float:
        """ExponentialLR parity: lr * gamma^epoch (stepped per epoch)."""
        return self.config.lr * (self.config.exp_gamma ** epoch)

    def set_lr(self, epoch: int) -> float:
        lr = self.epoch_lr(epoch)
        self._set_group_lr(lr)
        return lr

    def _gated_update(self, loss: torch.Tensor, saved: List[torch.Tensor],
                      metrics: Dict[str, torch.Tensor], sharded: bool = True
                      ) -> Dict[str, torch.Tensor]:
        """The (accumulated) optimizer step unless the loss or a gradient
        is not finite: then parameters, optimizer, accumulation and running
        stats (restored from ``saved``) stay as they were.  Trainable
        parameters that got no gradient get a zero one, so weight decay
        still reaches them.  ``step`` counts the call either way.  Under a
        mesh (and ``sharded``: each rank's gradients are its share) the
        gradients are summed over the mesh first and ``loss`` is the
        global loss.  One ``train.update`` span: the finite test with its
        host sync, then the step or the restore."""
        with span("train.update"):
            params = self.parameters()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh = self.mesh if sharded else None
            if mesh is not None:
                all_reduce_flat_([p.grad for p in params], mesh)
            finite = torch.isfinite(loss) & torch.stack(
                [torch.isfinite(p.grad).all() for p in params]).all()
            if mesh is not None:
                flag = finite.to(torch.int32).reshape(1)
                finite = all_reduce_(flag, mesh, op="min",
                                     kind="finite")[0] > 0
            if bool(finite):
                self.accumulation.step(params, self.optimizer)
            else:
                with torch.no_grad():
                    for b, old in zip(self.buffers(), saved):
                        b.copy_(old)
            self.step += 1
            metrics["skipped_nonfinite"] = 1.0 - finite.float()
            return metrics

    # --- checkpoints ----------------------------------------------------

    def state_dict(self) -> Dict:
        """Everything a resume needs: every module's parameters and
        buffers, the optimizer's state, the accumulation, step and lr."""
        return {"modules": [m.state_dict() for m in self.modules()],
                "optimizer": self.optimizer.state_dict(),
                "accumulation": self.accumulation.state_dict(),
                "step": self.step, "lr": self.lr}

    def load_state_dict(self, state: Dict, weights_only: bool = False
                        ) -> None:
        """Load :meth:`state_dict`'s output in place (strict).  With
        ``weights_only`` only the parameters and running stats load, and
        the optimizer and accumulation start fresh (the step and the
        learning rate stay the trainer's own)."""
        modules = self.modules()
        if len(state["modules"]) != len(modules):
            raise ValueError(f"the state holds {len(state['modules'])} "
                             f"modules, the trainer has {len(modules)}")
        for m, sd in zip(modules, state["modules"]):
            m.load_state_dict(sd, strict=True)
        if weights_only:
            self.reset_optimizer()
            return
        self.optimizer.load_state_dict(state["optimizer"])
        self.accumulation.load_state_dict(state["accumulation"])
        self.step = int(state["step"])
        self._set_group_lr(float(state["lr"]))
