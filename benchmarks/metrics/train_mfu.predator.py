"""predator-apr.train's reading of ``train_mfu`` (that metric's reader):
the cell reports no end-to-end throughput, so its per-layer metrics carry
names of their own (PERF.md, section 2)."""

from harness.cells import metric_reader

read = metric_reader("train_mfu")
