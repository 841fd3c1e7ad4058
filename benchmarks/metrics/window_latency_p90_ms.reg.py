"""The 90th percentile of every pair's latency in the timed window, from
hand-in to the pose on the host, from the window that the traced run runs
unprofiled before its trace.  fcgf-apr.reg's host-paced pairs spread too
widely from process to process for an end-to-end bound (PERF.md, section
2), so the cell reports the tail here."""


def read(run):
    if run.kind != "reg":
        return None
    return run.window.get("reg_latency_p90_ms")
