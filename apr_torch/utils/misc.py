"""Misc utilities (port of ``apr_tpu/utils/misc.py``, the reference's
FCGF_APR/util/misc.py):

- ``hash_pairs``: row hash of index pairs by a seed multiplier (the
  reference's ``_hash`` that keeps positive pairs out of mined negatives);
- ``extract_features``: featurize one cloud with a trained FCGF-path
  encoder (voxelize, the pyramid build with its one K1 launch, the encoder),
  on the trainer's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def hash_pairs(arr: np.ndarray, seed: int) -> np.ndarray:
    """Row-hash [N, d] int arrays: sum_i arr[:, i] * seed^i."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    hash_vec = np.zeros(arr.shape[0], dtype=np.int64)
    for d in range(arr.shape[1]):
        hash_vec += arr[:, d].astype(np.int64) * (seed ** d)
    return hash_vec


def extract_features(
    trainer,
    points: np.ndarray,
    voxel_size: float = 0.3,
    capacities: Tuple[int, ...] = (16384, 8192, 4096, 2048),
    conv1_kernel_size: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz_down [nv, 3], features [nv, C]) over the occupied voxels of
    ``points`` [N, 3], each voxel at its lowest-index point, from the
    encoder of an FCGF trainer (its own weights: the port's trainers hold
    their state, where the reference passes ``state``)."""
    from apr_torch.models.sparse import build_pyramid
    from apr_torch.ops.voxelize import voxelize

    n = len(points)
    cap = capacities[0]
    pts = np.zeros((max(n, 1), 3), np.float32)
    pts[:n] = points[:n]
    grid = voxelize(torch.from_numpy(pts)[None].to(trainer.device),
                    voxel_size, cap)
    pyr = build_pyramid(grid, capacities, conv1_kernel_size)
    feats_in = pyr.levels[0].mask[..., None].float()
    with torch.inference_mode():
        out = trainer._encode(feats_in, pyr, False)
    mask = pyr.levels[0].mask[0].cpu().numpy()
    rep = grid.rep[0].cpu().numpy()
    xyz = pts[np.minimum(rep, n - 1)]
    return xyz[mask], out[0].float().cpu().numpy()[mask]
