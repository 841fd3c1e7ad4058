"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
small widths and capacities, small frames; the traffic and the
comparison are the cells' own."""

import dataclasses
import time

import torch

from harness.cells import load_cell
from harness.report import run_cell

FCGF = dict(model="ResUNetBN2", model_n_out=16, conv1_kernel_size=3,
            generator_model="GenerativeMLP_54", point_generation_ratio=2,
            batch_size=2, voxel_size=1.0, point_capacity=2048,
            capacities=[1024, 512, 256, 128], apc_capacity=2048,
            test_subsample=256, test_num_ransac_hypotheses=512,
            num_pos_per_batch=64, num_hn_samples_per_batch=32)
PREDATOR = dict(first_feats_dim=32, gnn_feats_dim=32, final_feats_dim=16,
                point_capacity=8192, apc_capacity=8192,
                kp_capacities=[2048, 1024, 512, 256],
                neighborhood_limits=[16, 16, 16, 16], test_subsample=256,
                test_num_ransac_hypotheses=512, max_points=64,
                generator_model="GenerativeMLP_54",
                point_generation_ratio=2)
SEED = 2**31 + 12345


def cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a tiny size; ``predator-apr.reg``,
    which BENCHMARK.json leaves out, from its configuration and mix with
    ``fcgf-apr.reg``'s limits."""
    if name == "predator-apr.reg":
        c = load_cell("fcgf-apr.reg")
        pred = load_cell("predator-apr.train")
        c = dataclasses.replace(c, name=name, config=pred.config)
    else:
        c = load_cell(name)
    predator = name.startswith("predator")
    c.config["fields"].update(PREDATOR if predator else FCGF)
    pts = 6000 if predator else 2000
    c.config["frames"] = {"train": {"points": pts, "apc_points": pts},
                          "reg": {"points": pts}}
    c.mix = dict(c.mix, trace_steps=2, trace_pairs=4, checked_pairs=2,
                 pool_pairs=4, pace_steps=2, pace_pairs=2)
    return c


def run(name: str, trace: bool = False, control: bool = False,
        seed: int = SEED, seconds: float = 1.0):
    torch.manual_seed(0)
    return run_cell(cell(name), seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter(), control=control)
