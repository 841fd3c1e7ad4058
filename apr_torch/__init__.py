"""apr_torch: the PyTorch / CUDA port of apr_tpu.

It runs the FCGF-APR registration eval (voxelize -> sparse pyramid ->
ResUNet encoder -> feature NN -> RANSAC -> RTE/RRE) through
``apr_torch.eval.FeatureTester``, the FCGF-APR training step
(GenerativePairTrainer) through ``apr_torch.training.trainer.FCGFTrainer``,
the Predator-APR eval (KP pyramids -> KPFCNN -> overlap * saliency
sampling -> RANSAC) through ``apr_torch.eval.PredatorTester`` and its
train step through ``apr_torch.training.predator.PredatorTrainer``, and
both training loops through ``python -m apr_torch.train`` and ``python -m
apr_torch.main <yaml>``.
Entry points run on the card unless the caller passes ``device="cpu"``.
Two hand-written CUDA kernels carry them: the merge-path searchsorted
behind every kernel map (``csrc/searchsorted.cu``) and the nearest-neighbour
min of the Chamfer loss (``csrc/nn_min.cu``).

The package imports torch, numpy and the standard library only.
"""

import torch

from apr_torch.device import resolve_device

# The 128-d feature NN is a float32 matmul expansion that the reference runs
# at full precision, and the f32 encoder is held to the reference at ~1e-4:
# TF32 (about three decimal digits) stays off for matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
