import contextlib

from reference.aprref import tally
from stub_reference import USED


@contextlib.contextmanager
def counting():
    USED.append("tally")
    with tally.counting() as counts:
        yield counts
