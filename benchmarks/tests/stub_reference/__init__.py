"""A reference package for the benchmark's tests, named by a
configuration's ``"reference"`` key: ``reference.aprref``'s FCGF trainer
and tester, control and work counts, each of which records in
:data:`USED` that a loop took it from here; and recording Predator
classes that a configuration's ``"side"`` can name."""

USED = []      # "side", "precision", "tally", in the order they were used


def recording(cls, side: str, methods):
    """A subclass of ``cls`` that appends ``(side, "<cls>.<method>")`` to
    :data:`USED` on each call of the methods ``methods``."""
    def wrap(name):
        fn = getattr(cls, name)

        def call(self, *args, **kw):
            USED.append((side, f"{cls.__name__}.{name}"))
            return fn(self, *args, **kw)
        return call

    return type("Recording" + cls.__name__, (cls,),
                {n: wrap(n) for n in methods})


TRAINER_CALLS = ("__init__", "train_step")
TESTER_CALLS = ("__init__", "eval_one")
