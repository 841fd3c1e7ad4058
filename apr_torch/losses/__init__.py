"""Training losses of the FCGF and Predator paths (port of
``apr_tpu/losses``; the names of ``apr_tpu.losses``)."""

from apr_torch.losses.contrastive import contrastive_loss_random_negatives, \
    hardest_contrastive_loss, triplet_loss
from apr_torch.losses.generative import npr_reconstruction, \
    offset_regularization

__all__ = [
    "hardest_contrastive_loss",
    "contrastive_loss_random_negatives",
    "triplet_loss",
    "offset_regularization",
    "npr_reconstruction",
]
