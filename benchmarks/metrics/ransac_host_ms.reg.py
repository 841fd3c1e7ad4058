"""Host ms of the program's RANSAC span (``apr::ransac``, its
duration on the host under the profiler) in one registered pair, the mean
over the traced pairs; None where the program opens no such span."""


def read(run):
    if run.kind != "reg":
        return None
    return run.span_mean("ransac", "host_ms")
