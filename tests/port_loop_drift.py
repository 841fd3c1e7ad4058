"""How far the port's FCGF training loop on two gloo ranks moves from the
same loop in one process, per seed: free, and with every ReLU decision of
the one-process loop pinned to the ranks' (test_torch_rank_bodies.
ReluDecisions).  The loop is tests/test_torch_rank_bodies.py's LOOP_FIELDS
on TINY["fcgf"]; the counterpart of tests/reference_loop_drift.py.

    python tests/port_loop_drift.py 0 1 2 3 4 5 6 7 8 9

Prints per seed the largest conv-kernel move (max |2 ranks - 1 process|
over that kernel's largest entry) free and pinned, and for each ReLU
call whose decisions the pins changed, the largest changed input over
the call's largest input.  Imports no JAX; ~1 minute a seed on the CPU.
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import apr_torch.training.loop as loopmod  # noqa: E402
from apr_torch.config import APRConfig  # noqa: E402
from apr_torch.parallel.launch import spawn  # noqa: E402
from test_torch_rank_bodies import LOOP_FIELDS, TINY, ReluDecisions, \
    kernel_move, module_states, tiny_datasets  # noqa: E402


def fcgf_loop(seed, out_dir, num_devices=1, pins=None):
    """(the trainer's module states, its ReluDecisions) after the loop at
    ``seed``."""
    tiny_datasets(*TINY["fcgf"])
    made = []
    real = loopmod.get_trainer

    def make(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    loopmod.get_trainer = make
    try:
        with ReluDecisions(pins) as relus:
            loopmod.run_training(APRConfig(**LOOP_FIELDS).replace(
                seed=seed, out_dir=out_dir, num_devices=num_devices),
                device="cpu")
    finally:
        loopmod.get_trainer = real
    return module_states(made[-1]), relus


def rank(mesh, seed, tmp):
    states, relus = fcgf_loop(seed, os.path.join(tmp, str(mesh.rank)), 2)
    return states, relus.masks


def main(seeds):
    torch.set_num_threads(1)
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn(rank, 2, args=(seed, tmp), devices="cpu",
                          timeout=120, deadline=900,
                          init_file=os.path.join(tmp, "rdzv"))
            free, _ = fcgf_loop(seed, os.path.join(tmp, "one"))
            pinned, relus = fcgf_loop(
                seed, os.path.join(tmp, "pinned"),
                pins=list(zip(*(masks for _, masks in ranks))))
        two = ranks[0][0]
        print(f"port loop, seed {seed}: the largest conv-kernel move of 2 "
              f"ranks from 1 process {kernel_move(two, free)!r}, with the "
              f"ReLU decisions pinned {kernel_move(two, pinned)!r}; pinned "
              f"ties {relus.ties!r}", flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0])
