"""Device-side batch assembly for registration pairs (port of
``apr_tpu/training/batching.py``): voxelize, pyramids, GT correspondences
and the APC target dedup.

Both sides of every pair ride one 2B-cloud build: one voxelization and one
pyramid build whose kernel-map searches each serve all 2B clouds in a
single launch, and one APC dedup.  A build is three spans
(:func:`apr_torch.utils.profiling.span`): ``build.voxelize`` (the copies
in, the voxels and their points), ``build.maps`` (the pyramid and its
kernel maps) and ``build.corr`` (the GT correspondences and the APC
targets).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from apr_torch.device import resolve_device
from apr_torch.models.sparse import SparseLevel, SparsePyramid, \
    build_pyramid_from_level
from apr_torch.ops.voxelize import dedup_points, voxelize_lean
from apr_torch.registration.matching import gt_correspondences
from apr_torch.utils.profiling import span


class PairBatch(NamedTuple):
    """One batch of pairs; every tensor has leading dim B."""

    pyramid0: SparsePyramid
    pyramid1: SparsePyramid
    feats0: torch.Tensor     # [B, C0, 1] input features (ones on voxels)
    feats1: torch.Tensor
    xyz0: torch.Tensor       # [B, C0, 3] representative point per voxel
    xyz1: torch.Tensor
    pos_src: torch.Tensor    # [B, P] GT correspondence indices into voxels
    pos_tgt: torch.Tensor
    pos_mask: torch.Tensor   # [B, P]
    apc0: torch.Tensor       # [B, M, 3] aggregated point cloud targets
    apc0_mask: torch.Tensor
    apc1: torch.Tensor
    apc1_mask: torch.Tensor
    t_gt: torch.Tensor       # [B, 4, 4] ground truth, cloud0 -> cloud1


def _slice_tree(tree, sl):
    """``tree`` (tensors in nested tuples / NamedTuples) sliced on dim 0."""
    if isinstance(tree, torch.Tensor):
        return tree[sl]
    items = [_slice_tree(x, sl) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def make_pair_batch(
    points0, mask0, points1, mask1,   # [B, N, 3], [B, N]
    apc0, apc0_mask, apc1, apc1_mask,  # [B, M, 3], [B, M]
    t_gt,                              # [B, 4, 4]
    voxel_size: float = 0.3,
    capacities=(16384, 8192, 4096, 2048),
    conv1_kernel_size: int = 5,
    corr_cap: int = 1,
    search_multiplier: float = 1.5,
    with_correspondences: bool = True,
    device="cuda",
) -> PairBatch:
    """Voxelize both clouds of every pair, build their pyramids, find the
    GT correspondences and dedup the APC targets.

    Inputs may be numpy arrays or tensors; they move to ``device``.  The GT
    match radius is ``voxel_size * search_multiplier`` (the reference's
    positive_pair_search_voxel_size_multiplier), ``corr_cap`` matches per
    source voxel.  ``with_correspondences=False`` (test time) skips the GT
    search; APC buffers of 8 rows or fewer (test-time placeholders) skip
    the dedup.
    """
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    with span("build.voxelize"):
        p0, p1 = put(points0, torch.float32), put(points1, torch.float32)
        m0, m1 = put(mask0, torch.bool), put(mask1, torch.bool)
        t_gt = put(t_gt, torch.float32)
        b, n = p0.shape[:2]
        pts = torch.cat([p0, p1], dim=0)
        coords, keys, vmask, rep = voxelize_lean(
            pts, voxel_size, capacities[0], torch.cat([m0, m1], dim=0))
        # representative point per voxel (ME sparse_quantize 'sel' parity)
        xyz = torch.gather(pts, 1, rep.clamp(max=n - 1).long()[..., None]
                           .expand(-1, -1, 3))
        xyz = torch.where((rep < n)[..., None], xyz, 0.0)
        feats = vmask[..., None].to(torch.float32)

    with span("build.maps"):
        pyr = build_pyramid_from_level(SparseLevel(coords, keys, vmask),
                                       capacities, conv1_kernel_size)

    with span("build.corr"):
        if with_correspondences:
            corr = gt_correspondences(
                xyz[:b], xyz[b:], t_gt, radius=voxel_size * search_multiplier,
                cap_per_point=corr_cap, mask0=vmask[:b], mask1=vmask[b:])
            pos_src, pos_tgt, pos_mask = corr
        else:
            pos_src = pos_tgt = torch.zeros((b, 1), dtype=torch.int32,
                                            device=dev)
            pos_mask = torch.zeros((b, 1), dtype=torch.bool, device=dev)

        apc0, apc1 = put(apc0, torch.float32), put(apc1, torch.float32)
        apc0_mask, apc1_mask = put(apc0_mask, torch.bool), put(apc1_mask,
                                                               torch.bool)
        if apc0.shape[1] > 8:
            # voxel-dedup the APC targets (reference sel_nghb
            # quantization), both sides in one call
            apc, apc_mask = dedup_points(torch.cat([apc0, apc1], dim=0),
                                         voxel_size,
                                         torch.cat([apc0_mask, apc1_mask], 0))
            apc0, apc1 = apc[:b], apc[b:]
            apc0_mask, apc1_mask = apc_mask[:b], apc_mask[b:]

    return PairBatch(
        pyramid0=_slice_tree(pyr, slice(0, b)),
        pyramid1=_slice_tree(pyr, slice(b, 2 * b)),
        feats0=feats[:b], feats1=feats[b:],
        xyz0=xyz[:b], xyz1=xyz[b:],
        pos_src=pos_src, pos_tgt=pos_tgt, pos_mask=pos_mask,
        apc0=apc0, apc0_mask=apc0_mask, apc1=apc1, apc1_mask=apc1_mask,
        t_gt=t_gt,
    )
