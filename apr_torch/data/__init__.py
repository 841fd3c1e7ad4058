"""Data sources of the port (numpy): synthetic LiDAR-like pairs."""
