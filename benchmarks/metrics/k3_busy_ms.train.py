"""Device ms of kernel K3 in one batch build: the kernels whose name holds
``radius_select`` inside the build's span (the KP build's radius and
k-nearest selection), the mean over the traced steps.  None where no build
launches it: the FCGF cells, and a program without the kernel."""


def read(run):
    if run.kind != "train":
        return None
    times = run.kernel_s("build", "radius_select")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
