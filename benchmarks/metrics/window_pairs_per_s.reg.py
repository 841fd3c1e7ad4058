"""Pairs registered a second over the whole timed window (pairs over the
window's host-clock seconds), from the window that the traced run runs
unprofiled before its trace.  fcgf-apr.reg's host-paced pairs spread too
widely from process to process for an end-to-end bound (PERF.md, section
2), so the cell reports the rate here."""


def read(run):
    if run.kind != "reg":
        return None
    return run.window.get("reg_pairs_per_s")
