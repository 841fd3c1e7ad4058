"""apr_torch imports torch, numpy and the standard library only (neither
jax nor apr_tpu, nor yaml, scipy or orbax; h5py only when a ModelNet
dataset is made), and its entry points run on the card unless asked for
the CPU."""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import apr_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import apr_torch
names = ["apr_torch"] + [m.name for m in pkgutil.walk_packages(
    apr_torch.__path__, "apr_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "yaml",
                                    "scipy", "orbax", "h5py")
             or m.startswith("apr_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_every_module_imports_without_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert {"apr_torch.eval.tester", "apr_torch.ops.searchsorted",
            "apr_torch.kernels.build", "apr_torch.bridge",
            "apr_torch.eval.predator_tester", "apr_torch.models.gcn",
            "apr_torch.models.kernel_points", "apr_torch.models.kpconv",
            "apr_torch.models.kpfcnn", "apr_torch.ops.neighbors",
            "apr_torch.ops.pooling", "apr_torch.training.predator",
            "apr_torch.data.datasets", "apr_torch.data.pipeline",
            "apr_torch.training.checkpoints", "apr_torch.training.loop",
            "apr_torch.training.predator_loop", "apr_torch.train",
            "apr_torch.main", "apr_torch.data.kitti",
            "apr_torch.data.nuscenes", "apr_torch.data.indoor",
            "apr_torch.data.modelnet", "apr_torch.geometry.rotation",
            "apr_torch.models.simpleunet", "apr_torch.import_checkpoint",
            "apr_torch.scripts.test_apr",
            "apr_torch.scripts.test_fcgf"} <= set(res["modules"])
    assert len(res["modules"]) == len(list(pkgutil.walk_packages(
        apr_torch.__path__, "apr_torch."))) + 1


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _entry_points():
    import tempfile

    from apr_torch.bridge import resunet_from_flax
    from apr_torch.config import APRConfig
    from apr_torch.data.pipeline import PairLoader, collate_raw
    from apr_torch.eval import FeatureTester, PredatorTester
    from apr_torch.eval.predator_tester import calibrate_neighbors
    from apr_torch.models import load_model
    from apr_torch.training.batching import make_pair_batch
    from apr_torch.training.predator import PredatorTrainer, \
        make_kp_pair_batch
    from apr_torch.training.loop import run_training
    from apr_torch.training.predator_loop import run_predator_training
    from apr_torch.training.trainer import FCGFTrainer, get_trainer

    cfg = APRConfig(model="ResUNetBN2", model_n_out=8, conv1_kernel_size=3)
    kp_cfg = APRConfig(first_feats_dim=8, gnn_feats_dim=8, final_feats_dim=4,
                       generator_model="GenerativeMLP_4",
                       kp_capacities=(8, 4, 2, 2), point_capacity=8)
    z3, zm = np.zeros((1, 4, 3), np.float32), np.zeros((1, 4), bool)

    class _NoPairs:
        def __len__(self):
            return 0

    def no_epochs(config):
        # the loops set up (trainer, loaders, checkpoints) and train for
        # zero epochs
        return config.replace(dataset="synthetic", max_epoch=0,
                              out_dir=tempfile.mkdtemp())

    return {
        "PredatorTrainer": lambda **kw: PredatorTrainer(kp_cfg, **kw),
        "PredatorTester": lambda **kw: PredatorTester(kp_cfg, None, **kw),
        "make_kp_pair_batch": lambda **kw: make_kp_pair_batch(
            z3[0], zm[0], z3[0], zm[0], z3[0, :1], zm[0, :1], z3[0, :1],
            zm[0, :1], np.eye(4, dtype=np.float32), capacities=(4, 2, 2, 2),
            **kw),
        "calibrate_neighbors": lambda **kw: calibrate_neighbors(
            _NoPairs(), kp_cfg, **kw),
        "FCGFTrainer": lambda **kw: FCGFTrainer(cfg, **kw),
        "FeatureTester": lambda **kw: FeatureTester(cfg, None, **kw),
        "load_model": lambda **kw: load_model("ResUNetBN2")(
            out_channels=8, **kw),
        "resunet_from_flax": lambda **kw: resunet_from_flax(
            "ResUNetBN2", {}, {}, **kw),
        "make_pair_batch": lambda **kw: make_pair_batch(
            z3, zm, z3, zm, z3[:, :1], zm[:, :1], z3[:, :1], zm[:, :1],
            np.eye(4, dtype=np.float32)[None], capacities=(4, 2, 2, 2),
            conv1_kernel_size=3, with_correspondences=False, **kw),
        "get_trainer": lambda **kw: get_trainer(cfg, **kw),
        "run_training": lambda **kw: run_training(no_epochs(cfg), **kw),
        "run_predator_training": lambda **kw: run_predator_training(
            no_epochs(kp_cfg), **kw),
        "PairLoader": lambda **kw: PairLoader(_NoPairs(), cfg, **kw),
        "collate_raw": lambda **kw: collate_raw(
            [dict(points0=z3[0], points1=z3[0], apc0=z3[0], apc1=z3[0],
                  t_gt=np.eye(4, dtype=np.float32))],
            cfg.replace(point_capacity=8, apc_capacity=8), **kw),
    }


@pytest.mark.parametrize("name", ["FCGFTrainer", "FeatureTester",
                                  "load_model", "resunet_from_flax",
                                  "make_pair_batch", "PredatorTrainer",
                                  "PredatorTester", "make_kp_pair_batch",
                                  "calibrate_neighbors", "get_trainer",
                                  "run_training", "run_predator_training",
                                  "PairLoader", "collate_raw"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without a card, an entry point given no device raises; device='cpu'
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if name != "resunet_from_flax":   # empty flax trees fail the bridge
        make(device="cpu")
