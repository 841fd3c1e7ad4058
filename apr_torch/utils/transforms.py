"""Feature transforms of the FCGF data path (port of
``apr_tpu/utils/transforms.py``): Compose, Jitter (gaussian noise on the
features with probability p) and ChromaticShift.  Each draws from the
``np.random.Generator`` its caller passes, as the reference does, so the
same generator gives the same bits."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = transforms

    def __call__(self, rng: np.random.Generator, feats: np.ndarray):
        for t in self.transforms:
            feats = t(rng, feats)
        return feats


class Jitter:
    """Additive gaussian noise on features, applied with probability p."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.01, p: float = 0.95):
        self.mu = mu
        self.sigma = sigma
        self.p = p

    def __call__(self, rng: np.random.Generator, feats: np.ndarray):
        if rng.random() < self.p:
            feats = feats + rng.normal(
                self.mu, self.sigma, feats.shape
            ).astype(feats.dtype)
        return feats


class ChromaticShift:
    """Uniform global shift of (colour) features, applied with probability
    p."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.1, p: float = 0.95):
        self.mu = mu
        self.sigma = sigma
        self.p = p

    def __call__(self, rng: np.random.Generator, feats: np.ndarray):
        if rng.random() < self.p:
            feats = feats + rng.normal(self.mu, self.sigma, (1, feats.shape[1])
                                       ).astype(feats.dtype)
        return feats
