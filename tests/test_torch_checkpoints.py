"""The port's CheckpointManager (torch.save in place of orbax): a trainer's
whole state round-trips bit for bit (modules, optimizer, the gradient
accumulation of ``iter_size``, step, lr) and a resume in the middle of an
accumulation continues it exactly; the slots (3 numbered, 1 per tag) and
the layout are the reference's; ``restore_weights_only`` starts a fresh
optimizer."""

import os

import pytest
import torch

from apr_torch.config import APRConfig
from apr_torch.data.pipeline import collate_pairs
from apr_torch.data.synthetic import synthetic_pair
from apr_torch.training.checkpoints import CheckpointManager
from apr_torch.training.trainer import FCGFTrainer
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)

FIELDS = dict(
    trainer="GenerativePairTrainer", model="ResUNetBN2", model_n_out=8,
    conv1_kernel_size=3, generator_model="GenerativeMLP_54",
    point_generation_ratio=2, batch_size=1, num_pos_per_batch=32,
    num_hn_samples_per_batch=16, voxel_size=1.0, point_capacity=768,
    capacities=(256, 128, 64, 32), apc_capacity=512,
    compute_dtype="float32", iter_size=2)


@pytest.fixture(scope="module")
def batch():
    pair = synthetic_pair(0, n_points=700, apc_points=500, distance=4.0,
                          extent=14.0)
    return collate_pairs([pair], APRConfig(**FIELDS), device="cpu")


def _flat(tree, prefix=""):
    """Every leaf of a state dict tree, by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def _step(trainer, batch, seed):
    return trainer.train_step(batch, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_full_state_round_trip_mid_accumulation(tmp_path, batch, optimizer):
    cfg = APRConfig(**FIELDS, optimizer=optimizer)
    trainer = FCGFTrainer(cfg, device="cpu", seed=0)
    for s in range(3):            # an optimizer step, then one mini-step
        assert float(_step(trainer, batch, s)["skipped_nonfinite"]) == 0.0
    assert trainer.accumulation.mini_step == 1
    assert any(bool(g.abs().sum() > 0) for g in trainer.accumulation.grads)
    trainer.set_lr(3)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(1, trainer, extra={"best_val": 0.5})
    assert os.path.isfile(tmp_path / "checkpoints" / "1" / "state.pt")

    other = FCGFTrainer(cfg, device="cpu", seed=9)
    _, meta = CheckpointManager(str(tmp_path)).restore(other)
    assert meta == {"epoch": 1, "best_val": 0.5}
    _assert_bitwise(other.state_dict(), trainer.state_dict())
    assert (other.step, other.accumulation.mini_step) == (3, 1)
    assert other.lr == trainer.lr == cfg.lr * cfg.exp_gamma ** 3
    # the resumed accumulation completes exactly as the original's
    _step(trainer, batch, 7)
    _step(other, batch, 7)
    assert trainer.accumulation.mini_step == other.accumulation.mini_step == 0
    _assert_bitwise(other.state_dict(), trainer.state_dict())


def test_slots_tags_and_layout(tmp_path, batch):
    trainer = FCGFTrainer(APRConfig(**FIELDS), device="cpu", seed=0)
    mngr = CheckpointManager(str(tmp_path))
    assert mngr.latest_epoch() is None
    with pytest.raises(FileNotFoundError):
        mngr.restore(trainer)
    mngr.save(2, trainer, extra={"best_val": 0.1}, tag="best")
    for epoch in range(1, 6):
        trainer.step = epoch          # tell the saves apart
        mngr.save(epoch, trainer, extra={"best_val": 0.1})
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["3", "4", "5"]
    assert os.listdir(tmp_path / "checkpoints_best") == ["2"]
    assert mngr.latest_epoch() == 5 and mngr.latest_epoch("best") == 2
    mngr.save(4, trainer, extra={"best_val": 0.2}, tag="best")
    assert os.listdir(tmp_path / "checkpoints_best") == ["4"]
    fresh = FCGFTrainer(APRConfig(**FIELDS), device="cpu", seed=1)
    _, meta = mngr.restore(fresh, epoch=4)
    assert meta["epoch"] == 4 and fresh.step == 4
    _, meta = mngr.restore(fresh, tag="best")
    assert meta == {"epoch": 4, "best_val": 0.2}


def test_restore_weights_only_starts_a_fresh_optimizer(tmp_path, batch):
    cfg = APRConfig(**FIELDS)
    trainer = FCGFTrainer(cfg, device="cpu", seed=0)
    for s in range(3):
        _step(trainer, batch, s)
    CheckpointManager(str(tmp_path)).save(1, trainer)

    fresh = FCGFTrainer(cfg, device="cpu", seed=5)
    fresh.set_lr(2)
    CheckpointManager(str(tmp_path)).restore_weights_only(fresh)
    for a, b in zip(fresh.modules(), trainer.modules()):
        _assert_bitwise(a.state_dict(), b.state_dict())
    assert fresh.optimizer.state_dict()["state"] == {}
    assert fresh.accumulation.mini_step == 0
    assert all(not bool(g.any()) for g in fresh.accumulation.grads)
    assert fresh.step == 0 and fresh.lr == cfg.lr * cfg.exp_gamma ** 2
    # the fresh optimizer drives the restored parameters
    before = [p.clone() for p in fresh.parameters()]
    _step(fresh, batch, 1)
    _step(fresh, batch, 2)
    assert any(not torch.equal(a, b)
               for a, b in zip(before, fresh.parameters()))
