"""Device activities launched inside the program's encoder span
(``apr::encode``) in one registered pair, the mean over the traced pairs;
None where the program opens no such span."""


def read(run):
    if run.kind != "reg":
        return None
    return run.span_mean("encode", "launches")
