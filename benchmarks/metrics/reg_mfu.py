"""One registered pair's share of the H100's dense bf16 peak, in %: the
encoder's forward over both clouds, the feature matching and RANSAC's
scoring of its hypotheses over the valid correspondences (the reference's
count), over the host-clock time of a pair as the window registers them,
unprofiled (pairs run back to back and timed together)."""

from frozen.bounds import mfu_percent


def read(run):
    if run.kind != "reg" or not run.work.get("flops") \
            or run.unit_wall_s is None:
        return None
    return mfu_percent(run.work["flops"], run.unit_wall_s)
