"""Checkpoints of a trainer's whole state (port of
``apr_tpu/training/checkpoints.py``, on ``torch.save`` in place of orbax).

Layout, as the reference's: numbered checkpoints in
``out_dir/checkpoints/<epoch>/`` (the newest ``max_to_keep`` kept) and
tagged ones ("best", "best_loss", "best_recall") in
``out_dir/checkpoints_<tag>/<epoch>/`` (one per tag, surviving any number of
later numbered saves).  Each holds ``state.pt``, the trainer's
:meth:`~apr_torch.training.train_state.TrainerState.state_dict` (modules,
optimizer, accumulation, step, lr), and ``meta.json``, ``{"epoch": ...}``
plus the caller's scalars.  A resume restores everything;
``restore_weights_only`` (the reference's finetune_restart) restores the
parameters and running stats with a fresh optimizer.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch


def _ckpt_dir(out_dir: str) -> str:
    return os.path.abspath(os.path.join(out_dir, "checkpoints"))


class CheckpointManager:
    """Save and restore a trainer's state with scalar metadata."""

    def __init__(self, out_dir: str, max_to_keep: int = 3):
        self.path = _ckpt_dir(out_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.path, exist_ok=True)

    def _root(self, tag: Optional[str]) -> str:
        return self.path + f"_{tag}" if tag else self.path

    def _epochs(self, tag: Optional[str]):
        root = self._root(tag)
        if not os.path.isdir(root):
            return []
        return sorted(int(d) for d in os.listdir(root) if d.isdigit()
                      and os.path.isfile(os.path.join(root, d, "meta.json")))

    def save(self, epoch: int, trainer, extra: Optional[Dict] = None,
             tag: Optional[str] = None) -> None:
        """Write ``trainer``'s state as ``epoch`` (under ``tag`` if given),
        then drop the checkpoints beyond the slot count (3 numbered, 1 per
        tag).  The directory appears whole: it is written under a
        temporary name and renamed."""
        root = self._root(tag)
        os.makedirs(root, exist_ok=True)
        final = os.path.join(root, str(epoch))
        tmp = os.path.join(root, f".{epoch}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(trainer.state_dict(), os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(dict(epoch=epoch, **(extra or {})), f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        keep = 1 if tag else self.max_to_keep
        for old in self._epochs(tag)[:-keep]:
            shutil.rmtree(os.path.join(root, str(old)))

    def latest_epoch(self, tag: Optional[str] = None) -> Optional[int]:
        epochs = self._epochs(tag)
        return epochs[-1] if epochs else None

    def _read(self, trainer, epoch: Optional[int], tag: Optional[str]):
        epoch = epoch if epoch is not None else self.latest_epoch(tag)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self._root(tag)}")
        d = os.path.join(self._root(tag), str(epoch))
        state = torch.load(os.path.join(d, "state.pt"),
                           map_location=trainer.device, weights_only=True)
        with open(os.path.join(d, "meta.json")) as f:
            return state, json.load(f)

    def restore(self, trainer, epoch: Optional[int] = None,
                tag: Optional[str] = None):
        """Load the newest (or ``epoch``'s) checkpoint into ``trainer`` in
        place; returns (trainer, meta)."""
        state, meta = self._read(trainer, epoch, tag)
        trainer.load_state_dict(state)
        return trainer, meta

    def restore_weights_only(self, trainer, epoch: Optional[int] = None,
                             tag: Optional[str] = None):
        """finetune_restart: parameters and running stats only, with a
        fresh optimizer and accumulation; returns (trainer, meta)."""
        state, meta = self._read(trainer, epoch, tag)
        trainer.load_state_dict(state, weights_only=True)
        return trainer, meta
