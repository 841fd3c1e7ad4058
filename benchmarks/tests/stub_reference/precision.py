import contextlib

from reference.aprref import precision
from stub_reference import USED


@contextlib.contextmanager
def lower():
    USED.append("precision")
    with precision.lower():
        yield
