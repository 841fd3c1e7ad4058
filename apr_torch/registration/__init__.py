"""Correspondences, RANSAC and registration metrics of the port."""
