"""Pairs trained a second over the whole timed window, as the end-to-end
``train_pairs_per_s`` reads it (steps x B over the window's host-clock
seconds, builds included), from the window that the traced run runs
unprofiled before its trace.  predator-apr.train's host-paced steps spread
too widely from process to process for an end-to-end bound (PERF.md,
section 2), so the cell reports the rate here."""


def read(run):
    if run.kind != "train":
        return None
    return run.window.get("train_pairs_per_s")
