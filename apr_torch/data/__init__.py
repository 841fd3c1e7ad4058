"""Data sources of the port (numpy): synthetic LiDAR-like pairs (the
names of ``apr_tpu.data``)."""

from apr_torch.data.synthetic import synthetic_lidar_frame, synthetic_pair

__all__ = ["synthetic_lidar_frame", "synthetic_pair"]
