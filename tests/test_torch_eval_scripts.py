"""The eval entry points ``python -m apr_torch.scripts.test_apr`` and
``python -m apr_torch.scripts.test_fcgf`` against ``scripts/test_apr.py``
and ``scripts/test_fcgf.py``.

- The effective config (config.json rehydrated, the flags, the entry's
  defaults) equals the reference script's on every field the port has,
  for the same config.json and argv: each script's config is captured
  where it makes its trainer.
- Each port script runs end to end on the CPU on a run directory that
  ``python -m apr_torch.train --device cpu`` wrote on a KITTI-format tree,
  and writes results.npz.
"""

import dataclasses
import os

import numpy as np
import pytest

from apr_torch.config import APRConfig
from apr_torch.data.synthetic import write_kitti_tree
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)


class _Captured(Exception):
    pass


def _capture(monkeypatch, target):
    """Replace the trainer factory ``target`` with one that records the
    config it is given and stops the script there."""
    seen = []

    def fake(cfg, *args, **kw):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(target, fake)
    return seen


SAVED = {  # config.json contents: unset entry defaults, and pinned ones
    "unset": dict(model="ResUNetBN2", dataset="PairComplementKittiDataset",
                  kitti_root="/data/kitti", LoKITTI=False, seed=5),
    "pinned": dict(model="SimpleNetBN2E", test_ransac_escalation_factor=0,
                   test_capacity_buckets=0, test_subsample=3000,
                   random_rotation=False, random_scale=True),
}
ARGVS = {
    "none": [],
    "overrides": ["--LoKITTI", "true", "--num_pairs", "4", "--pair_min_dist",
                  "40", "--pair_max_dist", "50", "--kitti_root", "/elsewhere",
                  "--dataset", "KITTIRandDistPairDataset",
                  "--test_ransac_escalation_factor", "4",
                  "--test_capacity_buckets", "1"],
}
EXTRA = {"test_apr": ["--downsample_single", "0.5", "--LoNUSCENES", "false"],
         "test_fcgf": ["--num_points", "2000"]}


@pytest.mark.parametrize("argv", list(ARGVS))
@pytest.mark.parametrize("saved", list(SAVED))
@pytest.mark.parametrize("script", ["test_apr", "test_fcgf"])
def test_effective_config_equals_the_reference(monkeypatch, tmp_path,
                                               script, saved, argv):
    import importlib

    from apr_tpu.config import APRConfig as RefConfig

    RefConfig(**SAVED[saved]).save_json(str(tmp_path / "config.json"))
    args = ["--save_dir", str(tmp_path)] + ARGVS[argv] + (
        EXTRA[script] if argv == "overrides" else [])
    ref_seen = _capture(monkeypatch, "apr_tpu.training.get_trainer")
    with pytest.raises(_Captured):
        importlib.import_module(f"scripts.{script}").main(args)
    seen = _capture(monkeypatch, "apr_torch.training.trainer.get_trainer")
    with pytest.raises(_Captured):
        importlib.import_module(f"apr_torch.scripts.{script}").main(
            args + ["--device", "cpu"])
    ours, ref = seen[0].to_dict(), ref_seen[0].to_dict()
    assert ours == {f.name: ref[f.name] for f in dataclasses.fields(
        APRConfig)}
    assert ours["random_rotation"] is True and ours["random_scale"] is False


TRAIN_ARGV = ["--device", "cpu", "--model_n_out", "16",
              "--conv1_kernel_size", "3", "--generator_model",
              "GenerativeMLP_54", "--point_generation_ratio", "2",
              "--dataset", "PairComplementKittiDataset", "--batch_size", "2",
              "--num_pos_per_batch", "64", "--num_hn_samples_per_batch", "32",
              "--voxel_size", "1.0", "--point_capacity", "2048",
              "--capacities", "1024", "512", "256", "128", "--apc_capacity",
              "2048", "--max_epoch", "1", "--pair_min_dist", "5.0",
              "--pair_max_dist", "10.0", "--complement_pair_dist", "4.0",
              "--num_complement_one_side", "2", "--compute_dtype", "float32",
              "--test_num_ransac_hypotheses", "256", "--test_subsample",
              "500"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_tree(root, {0: 48, 6: 34, 8: 34}, n_points=1500, step=2.0,
                     radius=30.0)
    np.save(os.path.join(root, "file_LoKITTI_50.npy"),
            np.array([[8, 10, 16], [8, 14, 20], [8, 18, 24]]))
    return root


@pytest.mark.parametrize("script,trainer,model", [
    ("test_apr", "GenerativePairTrainer", "ResUNetBN2"),
    ("test_fcgf", "HardestContrastiveLossTrainer", "SimpleNetBN2E"),
])
def test_scripts_run_on_a_trained_run(tree, tmp_path, script, trainer,
                                      model):
    """An APR run evaluated on LoKITTI and an FCGF baseline run (a
    SimpleNet, its best-validation checkpoint) on the test walk."""
    import importlib

    from apr_torch.train import main as train_main

    run = str(tmp_path / "run")
    summary = train_main(TRAIN_ARGV + ["--kitti_root", tree, "--out_dir",
                                       run, "--trainer", trainer, "--model",
                                       model])
    assert summary["steps"] > 0 and np.isfinite(summary["last_val"]["loss"])
    extra = (["--LoKITTI", "true"] if script == "test_apr"
             else ["--num_points", "400"])
    s = importlib.import_module(f"apr_torch.scripts.{script}").main(
        ["--save_dir", run, "--device", "cpu", "--num_pairs", "2"] + extra)
    res = np.load(os.path.join(run, "results.npz"))
    assert s["n_pairs"] == 2 and res["rte"].shape == (2,)
    assert np.isfinite(res["rre"]).all()
    assert os.path.exists(os.path.join(run, "success_dists.npy"))


@pytest.mark.parametrize("entry", ["apr_torch.scripts.test_apr",
                                   "apr_torch.scripts.test_fcgf",
                                   "apr_torch.import_checkpoint"])
def test_entries_default_to_the_card(monkeypatch, tmp_path, entry):
    """Without a card and without --device cpu, each entry raises."""
    import importlib

    import torch

    APRConfig().save_json(str(tmp_path / "config.json"))
    torch.save({"state_dict": {}}, tmp_path / "ckpt.pth")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--pth", str(tmp_path / "ckpt.pth"), "--config",
             str(tmp_path / "config.json"), "--out_dir", str(tmp_path)]
            if entry.endswith("import_checkpoint")
            else ["--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(entry).main(argv)
