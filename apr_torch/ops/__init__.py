"""Tensor ops of the port: key packing, voxelization, kernel K1, NN search,
the Chamfer distance and segment pooling (the names of
``apr_tpu.ops``)."""

from apr_torch.ops.chamfer import chamfer_distance, nn_distances
from apr_torch.ops.hashing import COORD_BITS, COORD_RANGE, pack_coords, \
    unpack_coords
from apr_torch.ops.neighbors import knn, radius_neighbors
from apr_torch.ops.pooling import segment_mean_capped
from apr_torch.ops.voxelize import VoxelGrid, grid_subsample, \
    voxel_down_sample, voxelize

__all__ = [
    "pack_coords",
    "unpack_coords",
    "COORD_BITS",
    "COORD_RANGE",
    "VoxelGrid",
    "voxelize",
    "voxel_down_sample",
    "grid_subsample",
    "radius_neighbors",
    "knn",
    "nn_distances",
    "chamfer_distance",
    "segment_mean_capped",
]
