"""Device-busy ms of the program's update span in one train step
(``apr::train.update``: the finite test with its host sync, then the
optimizer step or the restore), the mean over the traced steps; None
where the program opens no such span."""


def read(run):
    if run.kind != "train":
        return None
    return run.span_mean("train.update", "busy_ms")
