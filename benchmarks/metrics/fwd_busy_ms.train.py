"""Device-busy ms of the program's forward span in one train step
(``apr::train.forward``: the running stats' snapshot, ``zero_grad`` and
the loss, the nested ``apr::encode`` included), the mean over the traced
steps; None where the program opens no such span."""


def read(run):
    if run.kind != "train":
        return None
    return run.span_mean("train.forward", "busy_ms")
