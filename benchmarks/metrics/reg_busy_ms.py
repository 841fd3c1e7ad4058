"""Device-busy ms of one registered pair (build, encoder, subsample,
matching, RANSAC, errors), the mean over the traced pairs."""


def read(run):
    if run.kind != "reg":
        return None
    return run.unit_mean("busy_s") * 1e3
