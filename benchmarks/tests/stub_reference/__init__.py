"""A reference package for the benchmark's tests, named by a
configuration's ``"reference"`` key: ``reference.aprref``'s FCGF trainer
and tester, control and work counts, each of which records in
:data:`USED` that a loop took it from here."""

USED = []      # "side", "precision", "tally", in the order they were used
