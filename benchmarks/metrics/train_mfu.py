"""The whole training step's share of the H100's dense bf16 peak, in %:
the operations the step needs for these inputs (the reference's count over
its own kernel maps and neighbour lists: sparse convs over valid pairs,
KPConvs over valid neighbours, dense layers, attention; the backward twice
the forward) over the host-clock time of a build and a step as the window
runs them, unprofiled (steps run back to back and timed together)."""

from frozen.bounds import mfu_percent


def read(run):
    if run.kind != "train" or not run.work.get("flops") \
            or run.unit_wall_s is None:
        return None
    return mfu_percent(run.work["flops"], run.unit_wall_s)
