"""The share of the traced window, in %, in which no kernel ran on the
card (the window from the first span's start to the last span's end)."""


def read(run):
    if run.kind != "reg" or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
