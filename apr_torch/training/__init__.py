"""Batch assembly and the trainers of the FCGF and Predator paths (the
names of ``apr_tpu.training``; ``TrainState`` is the port's trainer state,
:class:`apr_torch.training.train_state.TrainerState`)."""

from apr_torch.training.batching import PairBatch, make_pair_batch
from apr_torch.training.train_state import TrainerState as TrainState
from apr_torch.training.trainer import FCGFTrainer, get_trainer

__all__ = [
    "PairBatch",
    "make_pair_batch",
    "FCGFTrainer",
    "TrainState",
    "get_trainer",
]
