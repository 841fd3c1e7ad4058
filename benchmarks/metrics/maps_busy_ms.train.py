"""Device-busy ms of the program's map span in one batch build
(``apr::build.maps``: the pyramid and its kernel maps with K1, or the KP
pyramid's neighbour searches with K3), the mean over the traced steps;
None where the program opens no such span."""


def read(run):
    if run.kind != "train":
        return None
    return run.span_mean("build.maps", "busy_ms")
