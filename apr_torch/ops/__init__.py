"""Tensor ops of the port: key packing, voxelization, kernel K1, NN search."""
