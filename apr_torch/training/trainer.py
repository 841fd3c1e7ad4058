"""FCGF-path trainer: the part the registration eval needs (port of
``apr_tpu/training/trainer.py``: encoder construction and
``_encode_pair`` in eval mode).  The losses, the optimizer and the train
step arrive with the training slice (slice 2)."""

from __future__ import annotations

import torch

from apr_torch.config import APRConfig
from apr_torch.device import resolve_device
from apr_torch.models import load_model
from apr_torch.training.batching import PairBatch


def _zip_tree(fn, a, c):
    """Apply ``fn`` leafwise to two trees of tensors of the same structure."""
    if isinstance(a, torch.Tensor):
        return fn(a, c)
    items = [_zip_tree(fn, x, y) for x, y in zip(a, c)]
    return type(a)(*items) if hasattr(a, "_fields") else tuple(items)


class FCGFTrainer:
    """Holds the encoder of an FCGF-path trainer (loss selected by name)."""

    LOSS_MODES = (
        "ContrastiveLossTrainer",
        "HardestContrastiveLossTrainer",
        "TripletLossTrainer",
        "HardestTripletLossTrainer",
        "GenerativePairTrainer",
    )

    def __init__(self, config: APRConfig, device="cuda", seed: int = 0):
        if config.trainer not in self.LOSS_MODES:
            raise ValueError(f"unknown trainer {config.trainer!r}")
        self.config = config
        self.device = resolve_device(device)
        cd = (None if config.compute_dtype in (None, "float32")
              else config.compute_dtype)
        # batching feeds masked ones as input features (the FCGF
        # convention), so conv1 runs as a validity matmul with no gather
        self.encoder = load_model(config.model)(
            in_channels=1,
            ones_input=True,
            out_channels=config.model_n_out,
            normalize_feature=config.normalize_feature,
            conv1_kernel_size=config.conv1_kernel_size,
            bn_momentum=config.bn_momentum,
            compute_dtype=cd,
            device=self.device,
            seed=seed,
        )

    @torch.inference_mode()
    def _encode_pair(self, batch: PairBatch, train: bool = False):
        """Encode both clouds of a PairBatch in one 2B-cloud forward;
        returns (f0, f1), each [B, C0, model_n_out].

        The two sides are interleaved (not concatenated) so pair i's clouds
        are adjacent, the layout the train-mode pair fold of the norms needs.
        """
        if train:
            raise NotImplementedError(
                "train-mode encoding arrives with the training slice "
                "(slice 2)")
        b = batch.feats0.shape[0]

        def weave(a, c):
            return torch.stack([a, c], 1).reshape((2 * b,) + a.shape[1:])

        feats = weave(batch.feats0, batch.feats1)
        pyr = _zip_tree(weave, batch.pyramid0, batch.pyramid1)
        f = self.encoder(feats, pyr)
        f = f.reshape((b, 2) + f.shape[1:])
        return f[:, 0], f[:, 1]
