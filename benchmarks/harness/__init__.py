"""The benchmark's harness: cells found by name, inputs and weights from
the seed, the measured window, the traced window and the comparison with
the frozen reference that decides ``correct``."""
