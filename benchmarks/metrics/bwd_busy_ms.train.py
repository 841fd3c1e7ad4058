"""Device-busy ms of the program's backward span in one train step
(``apr::train.backward``: the kernels launched while it is open, from the
autograd worker thread too), the mean over the traced steps; None where
the program opens no such span."""


def read(run):
    if run.kind != "train":
        return None
    return run.span_mean("train.backward", "busy_ms")
