"""predator-apr.train's reading of ``device_idle.train`` (that metric's reader):
the cell reports no end-to-end throughput, so its per-layer metrics carry
names of their own (PERF.md, section 2)."""

from harness.cells import metric_reader

read = metric_reader("device_idle.train")
