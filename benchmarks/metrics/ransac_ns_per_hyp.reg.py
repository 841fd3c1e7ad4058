"""Device-busy ns of the program's RANSAC span (``apr::ransac``) per
hypothesis that it scored, counted by the program
(``ransac_from_draws.hypotheses``) over the traced pairs; None where the
program opens no such span or counts no hypotheses."""

from harness import program


def read(run):
    return program.metric_values(run.kind, run.program).get(
        "ransac_ns_per_hyp.reg")
