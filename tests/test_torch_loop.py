"""The port's training loops and entry points run whole on the CPU, at
tests/test_loop.py's tiny config: ``python -m apr_torch.train``'s
``main`` writes the reference's artifacts and records, a fused loop walks
the same losses as an unfused one (tests/test_fused_build.py's contract,
rtol 1e-5), a resume starts from the saved state bit for bit, the
Predator loop calibrates, latches the saliency weight, weights padding
pairs zero and keeps its best tags, and ``apr_torch.main`` evaluates in
test mode.  The parts are held to the reference in the other
tests/test_torch_*.py files.

``one_torch_thread`` runs a module on one torch CPU thread: these tests
launch many small ops (from two threads in the loops), and when the suite
runs in parallel workers, torch's per-thread OpenMP pools spin against
each other and the other workers and slow the module several times over;
on one thread its time barely depends on the load."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import apr_torch.data.datasets as dsmod
import apr_torch.training.loop as loopmod
import apr_torch.training.predator_loop as ploop
from apr_torch import main as main_entry
from apr_torch import train as train_entry
from apr_torch.config import APRConfig
from apr_torch.training.checkpoints import CheckpointManager
from apr_torch.training.predator import PredatorTrainer, select_pair

ARGV = ["--device", "cpu", "--trainer", "GenerativePairTrainer",
        "--model", "ResUNetBN2", "--model_n_out", "16",
        "--conv1_kernel_size", "3", "--generator_model", "GenerativeMLP_54",
        "--point_generation_ratio", "2", "--dataset", "synthetic",
        "--batch_size", "2", "--num_pos_per_batch", "64",
        "--num_hn_samples_per_batch", "32", "--voxel_size", "1.0",
        "--point_capacity", "2048", "--capacities", "1024", "512", "256",
        "128", "--apc_capacity", "2048", "--max_epoch", "1",
        "--stat_freq", "2", "--pair_min_dist", "4.0", "--pair_max_dist",
        "8.0", "--compute_dtype", "float32"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(n_train, n_val, n_points=1500, apc_points=1500):
    class Tiny(dsmod.SyntheticPairDataset):
        def __init__(self, **kw):
            kw["num_pairs"] = {"train": n_train}.get(kw["phase"], n_val)
            kw.update(n_points=n_points, apc_points=apc_points, extent=25.0)
            super().__init__(**kw)
    return Tiny


def _capture_trainers(monkeypatch, module, name):
    """Record every trainer ``module.<name>`` makes, with its state dict
    (cloned) just before its first train step."""
    made = []
    real = getattr(module, name)

    def make(*args, **kw):
        trainer = real(*args, **kw)
        entry = {"trainer": trainer, "first": None}
        made.append(entry)
        for step in ("train_step", "train_step_batched"):
            inner = getattr(trainer, step, None)
            if inner is None:
                continue

            def wrapped(*a, _inner=inner, **k):
                if entry["first"] is None:
                    entry["first"] = _clone(trainer.state_dict())
                return _inner(*a, **k)
            setattr(trainer, step, wrapped)
        return trainer

    monkeypatch.setattr(module, name, make)
    return made


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _assert_bitwise(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise(x, y)
    else:
        assert a == b


@pytest.fixture(scope="module")
def fcgf_runs(tmp_path_factory):
    """A fused 1-epoch run through the CLI, its resume to 2 epochs and an
    unfused 1-epoch run; the trainers each made."""
    tmp = tmp_path_factory.mktemp("loop")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(dsmod, "SyntheticPairDataset", _tiny(6, 2))
        made = _capture_trainers(mp, loopmod, "get_trainer")
        out = str(tmp / "fused")
        fused = train_entry.main(ARGV + ["--out_dir", out,
                                         "--fused_build", "true"])
        resumed = train_entry.main(["--resume_dir", out, "--max_epoch", "2",
                                    "--device", "cpu"])
        plain = train_entry.main(ARGV + ["--out_dir", str(tmp / "plain")])
    finally:
        mp.undo()
    return dict(out=out, tmp=tmp, fused=fused, resumed=resumed, plain=plain,
                made=made)


def test_run_training_writes_the_reference_artifacts(fcgf_runs):
    s, out = fcgf_runs["fused"], fcgf_runs["out"]
    assert s["steps"] == 3
    assert np.isfinite(s["last_train"]["loss"])
    assert s["last_train"]["skipped_nonfinite"] == 0.0
    assert np.isfinite(s["last_val"]["loss"]) and "best_val" in s
    saved = json.load(open(os.path.join(out, "config.json")))
    assert saved["fused_build"] is True and saved["capacities"] == [
        1024, 512, 256, 128]
    records = [json.loads(l) for l in open(os.path.join(out,
                                                        "metrics.jsonl"))]
    assert [r["phase"] for r in records] == [
        "train", "train_epoch", "val", "train_epoch", "val"]
    assert all({"phase", "step", "t"} <= set(r) for r in records)
    assert {"loss", "lr", "data_time", "step_time"} <= set(records[0])
    assert {"feat_match_ratio", "rte", "rre", "success"} <= set(records[2])
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["1", "2"]
    assert os.listdir(os.path.join(out, "checkpoints_best"))
    assert fcgf_runs["resumed"]["steps"] == 6


def test_fused_loop_matches_unfused(fcgf_runs):
    f, p = fcgf_runs["fused"], fcgf_runs["plain"]
    assert f["steps"] == p["steps"] == 3
    np.testing.assert_allclose(f["last_train"]["loss"],
                               p["last_train"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(f["last_val"]["loss"], p["last_val"]["loss"],
                               rtol=1e-5)


def test_resume_starts_from_the_saved_state(fcgf_runs):
    first, second = fcgf_runs["made"][:2]
    saved, resumed = first["trainer"].state_dict(), second["first"]
    for key in ("modules", "accumulation", "step"):
        _assert_bitwise(resumed[key], saved[key])
    _assert_bitwise(resumed["optimizer"]["state"], saved["optimizer"]["state"])
    assert resumed["step"] == 3
    # the one change before the first step: epoch 1's learning rate
    cfg = first["trainer"].config
    assert saved["lr"] == cfg.lr
    assert resumed["lr"] == pytest.approx(cfg.lr * cfg.exp_gamma)
    meta = json.load(open(os.path.join(fcgf_runs["out"], "checkpoints", "1",
                                       "meta.json")))
    assert meta["epoch"] == 1 and "best_val" in meta


def test_weights_finetune_and_the_one_device_rule(fcgf_runs, monkeypatch,
                                                  caplog):
    monkeypatch.setattr(dsmod, "SyntheticPairDataset", _tiny(2, 1))
    made = _capture_trainers(monkeypatch, loopmod, "get_trainer")
    cfg = train_entry.config_from_args(ARGV[2:] + [
        "--out_dir", str(fcgf_runs["tmp"] / "ft"),
        "--weights", fcgf_runs["out"], "--val_epoch_freq", "5"])
    summary = loopmod.run_training(cfg, device="cpu")
    assert summary["steps"] == 1 and "last_val" not in summary
    first = made[0]["first"]
    ref = fcgf_runs["made"][1]["trainer"].state_dict()
    _assert_bitwise(first["modules"], ref["modules"])
    assert first["optimizer"]["state"] == {} and first["step"] == 0
    # one process is one device: more devices or a builder split than
    # there are fall back to it, the split with the reference's warning
    for more, warned in ((dict(mesh_n_builders=2), True),
                         (dict(num_devices=2), False)):
        with caplog.at_level(logging.WARNING, logger=loopmod.__name__):
            caplog.clear()
            summary = loopmod.run_training(cfg.replace(**more),
                                           device="cpu")
        assert summary["steps"] == 1
        assert ("falling back to serial DP" in caplog.text) == warned


def test_a_loader_failure_fails_the_loop(tmp_path, monkeypatch):
    """An error in the loader's producer thread reaches the loop."""
    base = _tiny(4, 1)

    class Broken(base):
        def get_pair(self, index):
            if index == 2:
                raise OSError("unreadable pair 2")
            return super().get_pair(index)

    monkeypatch.setattr(dsmod, "SyntheticPairDataset", Broken)
    cfg = train_entry.config_from_args(ARGV[2:] + [
        "--out_dir", str(tmp_path / "broken"), "--batch_size", "1"])
    with pytest.raises(OSError, match="unreadable pair 2"):
        loopmod.run_training(cfg, device="cpu")


PRED_YAML = """misc:
  mode: {mode}
  trainer: PredatorTrainer
  out_dir: {out}
  seed: 42
model:
  first_feats_dim: 16
  final_feats_dim: 8
  first_subsampling_dl: 1.0
  conv_radius: 2.5
  compute_dtype: float32
gnn:
  gnn_feats_dim: 16
  dgcnn_k: 4
  num_head: 2
generator:
  generator_model: GenerativeMLP_4
  point_generation_ratio: 2
loss:
  pos_radius: 1.0
  safe_radius: 2.5
  overlap_radius: 1.2
  matchability_radius: 1.2
  max_points: 64
optimizer:
  lr: 0.01
  sgd_momentum: 0.98
  max_epoch: 2
  stat_freq: 2
dataset:
  dataset: synthetic
  pair_min_dist: 4.0
  pair_max_dist: 8.0
  point_capacity: 2500
  apc_capacity: 1024
  kp_capacities: [1024, 512, 256, 128]
  chamfer_mode: pallas
  fused_build: {fused}
"""


def _write(tmp, name, **kw):
    path = tmp / name
    path.write_text(PRED_YAML.format(**kw) + kw.get("extra", ""))
    return str(path)


@pytest.fixture(scope="module")
def predator_run(tmp_path_factory):
    """main(yaml) with no pinned limits (calibration), 3 train and 2 val
    pairs, 2 epochs, the fused path, val recall forced above 0.3 in epoch
    0; then main in test mode on that run's weights."""
    tmp = tmp_path_factory.mktemp("predator")
    out = str(tmp / "run")
    mp = pytest.MonkeyPatch()
    seen = {"limits": [], "w": [], "val": 0}
    try:
        mp.setattr(dsmod, "SyntheticPairDataset", _tiny(3, 2, 2000, 500))
        real_make = ploop.make_kp_pair_batch

        def spy_make(*a, **kw):
            seen["limits"].append(kw["neighbor_limits"])
            return real_make(*a, **kw)
        mp.setattr(ploop, "make_kp_pair_batch", spy_make)
        made = _capture_trainers(mp, ploop, "PredatorTrainer")
        real_valid = PredatorTrainer.valid_step_batched
        real_step = PredatorTrainer.train_step_batched

        def valid(self, batch, gen=None, w_saliency=0.0):
            m = real_valid(self, batch, gen, w_saliency)
            seen["val"] += 1
            if seen["val"] <= 2:       # epoch 0: recall above the latch
                m["recall"] = torch.tensor(0.5)
            return m

        def step(self, batch, gen=None, w_saliency=0.0, pair_weights=None):
            seen["w"].append(w_saliency)
            return real_step(self, batch, gen, w_saliency, pair_weights)
        mp.setattr(PredatorTrainer, "valid_step_batched", valid)
        mp.setattr(PredatorTrainer, "train_step_batched", step)
        summary = main_entry.main(_write(tmp, "train.yaml", mode="train",
                                         out=out, fused="true"),
                                  device="cpu")
        test = main_entry.main(_write(
            tmp, "test.yaml", mode="test", out=str(tmp / "test"),
            fused="false", extra=f"  weights: {out}\n"), device="cpu")
    finally:
        mp.undo()
    return dict(out=out, tmp=tmp, summary=summary, test=test, seen=seen,
                made=made)


def test_predator_loop_calibrates_before_building(predator_run):
    cfg = predator_run["made"][0]["trainer"].config
    limits = tuple(cfg.neighborhood_limits)
    assert limits != (40, 40, 40, 40) and max(limits) < 40
    assert not cfg.neighborhood_limits_pinned
    saved = json.load(open(os.path.join(predator_run["out"],
                                        "config.json")))
    assert tuple(saved["neighborhood_limits"]) == limits
    assert predator_run["seen"]["limits"]          # per-pair val builds
    assert all(tuple(x) == limits for x in predator_run["seen"]["limits"])


def test_predator_loop_saliency_latch_and_best_tags(predator_run):
    s, out = predator_run["summary"], predator_run["out"]
    # 3 pairs a group of one: 3 steps an epoch, the last one carried
    assert s["steps"] == 6 and predator_run["seen"]["w"] == [0.0] * 3 + [
        1.0] * 3
    assert s["w_saliency"] == 1.0
    mngr = CheckpointManager(out)
    metas = [json.load(open(os.path.join(out, "checkpoints", e,
                                         "meta.json"))) for e in ("1", "2")]
    # the latch follows the epoch's save: epoch 1's meta trained at 0
    assert [m["w_saliency"] for m in metas] == [0.0, 1.0]
    records = [json.loads(l) for l in open(os.path.join(out,
                                                        "metrics.jsonl"))]
    val = [r for r in records if r["phase"] == "val"]
    best = min(range(2), key=lambda e: val[e]["circle_loss"])
    assert mngr.latest_epoch("best_loss") == best + 1
    assert metas[best]["best_loss"] == pytest.approx(val[best]
                                                     ["circle_loss"])
    assert mngr.latest_epoch("best_recall") == 1     # the forced 0.5
    assert s["best_recall"] == 0.5
    assert all(np.isfinite(r["loss"]) for r in records
               if r["phase"] == "train_epoch")


def test_predator_test_mode_writes_results(predator_run):
    t = predator_run["test"]
    assert t["n_pairs"] == 2 and 0.0 <= t["recall"] <= 1.0
    test_dir = predator_run["tmp"] / "test"
    res = np.load(test_dir / "results.npz")
    assert res["rte"].shape == (2,) and np.isfinite(res["rre"]).all()
    assert (test_dir / "success_dists.npy").exists()
    assert (test_dir / "fail_dists.npy").exists()


def test_padded_tail_pairs_weigh_nothing(predator_run):
    """A group of 2 over 3 pairs pads its tail with the last pair, and the
    loop's weights (1, 0) make that padded group step exactly as a group
    of its one real pair."""
    cfg = APRConfig.load_json(os.path.join(predator_run["out"],
                                           "config.json"))
    ds = _tiny(3, 2, 2000, 500)(seed=cfg.seed, phase="train",
                                min_dist=4.0, max_dist=8.0)
    groups = list(ploop._group_iter(ds, [2, 0, 1], cfg, 2, device="cpu"))
    assert [n for _, n in groups] == [2, 1]
    padded, n_real = groups[1]
    assert torch.equal(padded.t_gt[0], padded.t_gt[1])
    pw = ploop.pair_weights(n_real, 2, "cpu")
    assert pw.tolist() == [1.0, 0.0]
    single = ploop.stack_trees([select_pair(padded, 0)])
    a = PredatorTrainer(cfg, device="cpu", seed=1)
    b = PredatorTrainer(cfg, device="cpu", seed=1)
    ma = a.train_step_batched(padded, torch.Generator().manual_seed(0),
                              0.0, pw)
    mb = b.train_step_batched(single, torch.Generator().manual_seed(0), 0.0)
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                               rtol=1e-6)
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)
