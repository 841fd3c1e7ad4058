"""Calls that block the host until the card has caught up (stream,
device and event synchronisations, blocking copies) inside the
program's ``apr::`` spans in one train step, the mean over the traced
steps (``harness/program.py``); None where the program opens no span."""

from harness import program


def read(run):
    return program.metric_values(run.kind, run.program).get(
        "host_syncs.train")
