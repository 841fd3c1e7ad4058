"""The frozen reference against the port at a tiny size on the CPU: from
the same weights and inputs, the same batches, features, train steps and
registrations bit for bit (only tests import both)."""

import torch

import tiny
from harness.common import derived_seed, generator
from harness.sides import PROGRAM, REFERENCE, Side, draw_weights, \
    leaves, load_weights, roles_of
from harness.cells import loop_module

Feed = loop_module("train").Feed


def sides(name):
    c = tiny.cell(name)
    dev = torch.device("cpu")
    prog, ref = (Side(p, c.config["fields"], dev, roles_of(c))
                 for p in (PROGRAM, REFERENCE))
    w = draw_weights(prog, derived_seed(tiny.SEED, 0))
    load_weights(prog, w)
    load_weights(ref, w)
    return c, prog, ref


def test_train_steps_agree_bit_for_bit():
    c, prog, ref = sides("fcgf-apr.train")
    feed = Feed(prog, c.mix, c.config["frames"]["train"], tiny.SEED)
    gp, gr = generator(prog.device, 5), generator(ref.device, 5)
    for k in range(2):
        raw = feed.raw(k)
        bp, br = prog.trainer.build_batch(raw), ref.trainer.build_batch(raw)
        for a, b in zip(leaves(bp), leaves(br)):
            assert torch.equal(a, b)
        mp = prog.trainer.train_step(bp, gp)
        mr = ref.trainer.train_step(br, gr)
        assert float(mp["loss"]) == float(mr["loss"])
    for (n, a), (_, b) in zip(prog.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(a, b), n


def test_predator_encoder_agrees_bit_for_bit():
    c, prog, ref = sides("predator-apr.reg")
    from frozen.synthetic import synthetic_pair

    pair = synthetic_pair(seed=3, n_points=6000, apc_points=4, distance=40.0)
    bp = prog.tester._pair_to_batch(pair)
    br = ref.tester._pair_to_batch(pair)
    for a, b in zip(leaves(bp), leaves(br)):
        assert torch.equal(a, b)
    op, orf = prog.tester.forward(bp), ref.tester.forward(br)
    assert torch.equal(op.feats0, orf.feats0)
    assert torch.equal(op.feats1, orf.feats1)


def test_weights_reach_both_sides():
    _, prog, ref = sides("fcgf-apr.train")
    for (n, a), (_, b) in zip(prog.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(a, b), n
