"""Rigid-transform math of the port."""
