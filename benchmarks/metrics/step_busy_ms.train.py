"""Device-busy ms inside one ``train_step`` (forward, backward, optimizer,
finite gate), the mean over the traced steps."""


def read(run):
    if run.kind != "train":
        return None
    return run.stage_mean("step", "busy_s") * 1e3
