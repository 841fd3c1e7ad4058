"""Kernel K1's share of its roofline in one batch build, in %: its bytes
bound (every support, query and result byte once at 3.35e12 B/s, the
reference's count of the build's searches) over the device time of the
build's K1 launches (``searchsorted_many_kernel`` in the trace)."""

from frozen.bounds import k1_bound_s


def read(run):
    if run.kind != "reg" or not run.work.get("k1_bytes"):
        return None
    times = run.kernel_s("build", "searchsorted_many_kernel")
    if not times:
        return None
    return 100.0 * k1_bound_s(run.work["k1_bytes"]) / (sum(times) / len(times))
