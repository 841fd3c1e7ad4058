"""Kernel launches of one registered pair, the mean over the traced
pairs."""


def read(run):
    if run.kind != "reg":
        return None
    return run.unit_mean("launches")
