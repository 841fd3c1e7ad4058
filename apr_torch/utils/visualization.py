"""Per-point features as RGB colours (t-SNE when sklearn is installed, else
PCA) and coloured PLY dumps (port of ``apr_tpu/utils/visualization.py``).
Host numpy, like the reference."""

from __future__ import annotations

import numpy as np


def _normalize_01(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(0, keepdims=True), x.max(0, keepdims=True)
    return (x - lo) / np.maximum(hi - lo, 1e-12)


def embed_features_rgb(
    features: np.ndarray,
    method: str = "tsne",
    max_points: int = 5000,
    seed: int = 0,
) -> np.ndarray:
    """[N, C] features -> [N, 3] colours in [0, 1]; at most ``max_points``
    drawn rows are embedded, the others get 0.5."""
    rng = np.random.default_rng(seed)
    n = len(features)
    if n > max_points:
        sel = rng.choice(n, max_points, replace=False)
    else:
        sel = np.arange(n)

    if method == "tsne":
        try:
            from sklearn.manifold import TSNE

            emb = TSNE(
                n_components=3, random_state=seed, init="random",
                perplexity=min(30, max(5, len(sel) // 10)),
            ).fit_transform(features[sel])
        except ImportError:
            method = "pca"
    if method == "pca":
        centered = features[sel] - features[sel].mean(0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        emb = centered @ vt[:3].T

    colors = np.zeros((n, 3), np.float32)
    colors[sel] = _normalize_01(emb).astype(np.float32)
    if n > len(sel):
        colors[colors.sum(1) == 0] = 0.5
    return colors


def save_colored_ply(path: str, points: np.ndarray, colors01: np.ndarray):
    """Write points + uint8 RGB to a binary PLY."""
    from apr_torch.utils.ply import write_ply

    rgb = (np.clip(colors01, 0, 1) * 255).astype(np.uint8)
    write_ply(
        path,
        [points.astype(np.float32), rgb],
        ["x", "y", "z", "red", "green", "blue"],
    )
