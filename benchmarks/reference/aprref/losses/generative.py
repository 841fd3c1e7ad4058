# Frozen copy of apr_torch/losses/generative.py at commit bc3af59, the benchmark's plain
# reference: imports renamed to reference.aprref; see reference/aprref/__init__.py.
"""NPR generative-branch losses: offset regularizers and the APC
reconstruction Chamfer (port of ``apr_tpu/losses/generative.py``), per cloud
over a leading batch.

    generated   = MLP(feats) * voxel_size                  # [N, ratio*3]
    reg         = L2 | RepelL2 | RepelL1 over generated offsets
    reconstruct = (generated + anchors.repeat(ratio)).reshape(-1, 3)
    loss        = chamfer(reconstruct, apc) + reg * reg_strength
"""

from __future__ import annotations

from typing import Optional

import torch


def offset_regularization(offsets: torch.Tensor, mask: torch.Tensor,
                          reg_type: str = "L2",
                          alpha: float = 1.0) -> torch.Tensor:
    """[B] regularizer over offsets [B, N, ratio, 3] (masked mean).

    L2:      mean ||o||^2
    RepelL2: mean ||o||^2 + mean 1 / (||o||^2 + alpha)
    RepelL1: mean ((||o||^2 + 1e-5)^0.25 - 1)^2
    """
    sq = (offsets * offsets).sum(dim=-1)                  # [B, N, ratio]
    w = mask.to(offsets.dtype)[..., None]
    n = torch.clamp(w.sum(dim=(1, 2)) * sq.shape[2], min=1.0)

    def wmean(x):
        return (x * w).sum(dim=(1, 2)) / n

    if reg_type == "L2":
        return wmean(sq)
    if reg_type == "RepelL2":
        return wmean(sq) + wmean(1.0 / (sq + alpha))
    if reg_type == "RepelL1":
        lengths = torch.pow(sq + 1e-5, 0.25) - 1.0
        return wmean(lengths * lengths)
    raise ValueError(f"unknown regularization_type: {reg_type}")


def npr_reconstruction(
    mlp_output: torch.Tensor,     # [B, N, ratio*3] raw MLP output
    anchor_points: torch.Tensor,  # [B, N, 3] metric positions of the features
    apc_points: torch.Tensor,     # [B, M, 3] aggregated point cloud target
    feat_mask: torch.Tensor,      # [B, N]
    apc_mask: Optional[torch.Tensor] = None,
    voxel_size: float = 1.0,
    reg_type: str = "L2",
    reg_strength: float = 0.01,
    alpha: float = 1.0,
    chamfer_mode: str = "exact",
    chamfer_cell_size: float = 1.2,
):
    """(chamfer + reg * strength, chamfer, reg, clamp_frac), each [B].

    ``chamfer_mode``: "pallas" runs kernel K2 (``ops/distance.py``),
    "exact" the plain brute force (``ops/chamfer.py``), "window" the
    cell-sorted windowed Chamfer (``ops/chamfer_window.py``), whose
    ``clamp_frac`` is the fraction of points beyond its 2-cell clamp (zero
    in the other modes).
    """
    b, n = mlp_output.shape[:2]
    ratio = mlp_output.shape[2] // 3
    offsets = (mlp_output * voxel_size).reshape(b, n, ratio, 3)
    reg = offset_regularization(offsets, feat_mask, reg_type, alpha)

    recon = (offsets + anchor_points[:, :, None, :]).reshape(b, n * ratio, 3)
    recon_mask = torch.repeat_interleave(feat_mask, ratio, dim=1)
    clamp_frac = torch.zeros(b, dtype=torch.float32, device=recon.device)
    if chamfer_mode == "window":
        from reference.aprref.ops.chamfer_window import chamfer_distance_window_stats

        cd, clamp_frac = chamfer_distance_window_stats(
            recon, apc_points, recon_mask, apc_mask,
            cell_size=chamfer_cell_size)
    elif chamfer_mode == "pallas":
        from reference.aprref.ops.distance import chamfer_distance_pallas

        cd = chamfer_distance_pallas(recon, apc_points, recon_mask, apc_mask)
    elif chamfer_mode == "exact":
        from reference.aprref.ops.chamfer import chamfer_distance

        cd = chamfer_distance(recon, apc_points, recon_mask, apc_mask)
    else:
        raise ValueError(f"unknown chamfer_mode: {chamfer_mode!r} "
                         "(expected window | pallas | exact)")
    return cd + reg * reg_strength, cd, reg, clamp_frac
