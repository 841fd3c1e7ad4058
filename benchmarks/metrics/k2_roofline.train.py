"""Kernel K2's share of its roofline in one train step, in %: the exact
all-pairs search over the valid points (8 float32 operations a valid pair
at 3.35e13/s, or its bytes at 3.35e12 B/s, whichever is larger; the
reference's count of the step's four Chamfer searches) over the device
time of the step's K2 launches (``nn_min_kernel`` in the trace)."""

from frozen.bounds import k2_bound_s


def read(run):
    if run.kind != "train" or not run.work.get("k2_pairs"):
        return None
    times = run.kernel_s("step", "nn_min_kernel")
    if not times:
        return None
    bound = k2_bound_s(run.work["k2_pairs"], run.work["k2_bytes"])
    return 100.0 * bound / (sum(times) / len(times))
