"""Batch assembly and the encoder side of the FCGF trainer."""
