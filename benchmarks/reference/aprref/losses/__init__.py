# Frozen copy of apr_torch/losses/__init__.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""Training losses of the FCGF and Predator paths (port of
``apr_tpu/losses``; the names of ``apr_tpu.losses``)."""

from reference.aprref.losses.contrastive import contrastive_loss_random_negatives, \
    hardest_contrastive_loss, triplet_loss
from reference.aprref.losses.generative import npr_reconstruction, \
    offset_regularization

__all__ = [
    "hardest_contrastive_loss",
    "contrastive_loss_random_negatives",
    "triplet_loss",
    "offset_regularization",
    "npr_reconstruction",
]
