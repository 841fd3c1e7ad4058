"""Device-busy ms inside one batch build: the union of the kernels'
intervals within the build's span, the mean over the traced steps."""


def read(run):
    if run.kind != "train":
        return None
    return run.stage_mean("build", "busy_s") * 1e3
