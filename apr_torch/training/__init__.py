"""Batch assembly and the trainers of the FCGF and Predator paths."""
