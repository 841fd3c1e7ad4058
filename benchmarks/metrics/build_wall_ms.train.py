"""Wall ms of one batch build (``trainer.build_batch``) on the host's
clock, unprofiled: builds of the feed's batches run back to back and
timed together, the card synchronised at both ends only."""


def read(run):
    if run.kind != "train" or run.build_wall_s is None:
        return None
    return run.build_wall_s * 1e3
