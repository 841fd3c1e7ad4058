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
            "apr_torch.scripts.test_fcgf", "apr_torch.geometry.icp",
            "apr_torch.geometry.pose_graph", "apr_torch.data.multiway",
            "apr_torch.tools.prepare_icp_cache", "apr_torch.tools.cal_overlap",
            "apr_torch.utils.pointcloud", "apr_torch.utils.misc",
            "apr_torch.utils.trajectory", "apr_torch.utils.files",
            "apr_torch.utils.logging_utils", "apr_torch.utils.ply",
            "apr_torch.utils.transforms", "apr_torch.utils.visualization",
            "apr_torch.eval.benchmark3dmatch",
            "apr_torch.registration.benchmark_utils",
            "apr_torch.parallel", "apr_torch.parallel.mesh",
            "apr_torch.parallel.collectives", "apr_torch.parallel.chamfer_sp",
            "apr_torch.parallel.pipeline", "apr_torch.parallel.launch",
            "apr_torch.dryrun", "apr_torch.native",
            "apr_torch.tools.validate_convergence",
            "apr_torch.tools.validate_predator_convergence",
            "apr_torch.tools.validate_apr_gain",
            "apr_torch.tools.pool_apr_gain",
            "apr_torch.tools.sweep_ransac", "apr_torch.ops.sort",
            "apr_torch.utils.profiling", "apr_torch.tools.profile_build",
            "apr_torch.tools.profile_pyramid",
            "apr_torch.tools.profile_train_step",
            "apr_torch.tools.profile_predator",
            "apr_torch.tools.profile_predator_sustained",
            "apr_torch.tools.profile_sort",
            "apr_torch.tools.probe_radius_select",
            "apr_torch.tools.export_nuscenes_kitti"} <= set(res["modules"])
    assert len(res["modules"]) == len(list(pkgutil.walk_packages(
        apr_torch.__path__, "apr_torch."))) + 1


LAUNCHERS = [f"{kind}_{family}_{data}.sh" for kind in ("train", "test")
             for family in ("apr", "fcgf") for data in ("kitti", "nuscenes")]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launchers_call_the_port_only(name):
    """Each port launcher calls ``python -m apr_torch...`` and neither the
    root ``train.py`` nor the root ``scripts`` package."""
    with open(os.path.join(_ROOT, "apr_torch", "scripts", name)) as f:
        calls = [line.strip() for line in f
                 if line.strip().startswith("python")]
    assert len(calls) == 1
    assert calls[0].startswith("python -m apr_torch.")
    assert "train.py" not in calls[0] and " scripts." not in calls[0]


PROFILERS = ["profile_build", "profile_pyramid", "profile_train_step",
             "profile_predator", "profile_predator_sustained",
             "profile_sort", "probe_radius_select"]


@pytest.mark.parametrize("name", PROFILERS)
def test_profilers_default_to_the_card(name, monkeypatch):
    """Without a card a profiler given no --device raises before any
    work, as every entry point does."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"apr_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])


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

    from apr_torch.data.multiway import _voxel_dedup, \
        multiway_complement_transforms
    from apr_torch.geometry.icp import information_matrix, registration_icp
    from apr_torch.tools import cal_overlap, prepare_icp_cache
    from apr_torch.utils.pointcloud import compute_overlap_ratio, \
        evaluate_feature_match, get_matching_indices

    cloud = np.random.default_rng(0).uniform(-1, 1, (20, 3))
    empty = tempfile.mkdtemp()

    def tool(main, argv):
        return lambda device="cuda": main(argv + ["--device", device])

    def mesh_of_one(device="cuda"):
        import torch.distributed as dist

        from apr_torch.parallel import make_mesh

        mesh = make_mesh(device, rank=0, world_size=1)
        dist.destroy_process_group()
        return mesh

    return {
        "registration_icp": lambda **kw: registration_icp(
            cloud, cloud, 0.2, **kw),
        "information_matrix": lambda **kw: information_matrix(
            cloud, cloud, 0.2, np.eye(4), **kw),
        "multiway_complement_transforms": lambda **kw:
            multiway_complement_transforms(
                cloud, [cloud, cloud], [np.eye(4)] * 2, 1, **kw),
        "_voxel_dedup": lambda **kw: _voxel_dedup(cloud, 0.05, **kw),
        "compute_overlap_ratio": lambda **kw: compute_overlap_ratio(
            cloud, cloud, np.eye(4), 0.1, **kw),
        "get_matching_indices": lambda **kw: get_matching_indices(
            cloud, cloud, np.eye(4), 0.1, **kw),
        "evaluate_feature_match": lambda **kw: evaluate_feature_match(
            cloud, cloud, cloud, cloud, np.eye(4), **kw),
        "prepare_icp_cache": tool(prepare_icp_cache.main,
                                  ["--kitti_root", empty]),
        "cal_overlap": tool(cal_overlap.main, [
            "--dir", empty, "--out", os.path.join(empty, "overlaps.txt")]),
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
        "make_mesh": mesh_of_one,
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
                                  "PairLoader", "collate_raw",
                                  "registration_icp", "information_matrix",
                                  "multiway_complement_transforms",
                                  "_voxel_dedup", "compute_overlap_ratio",
                                  "get_matching_indices",
                                  "evaluate_feature_match",
                                  "prepare_icp_cache", "cal_overlap",
                                  "make_mesh"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without a card, an entry point given no device raises; device='cpu'
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if name != "resunet_from_flax":   # empty flax trees fail the bridge
        make(device="cpu")


def test_the_dryrun_needs_its_cards(monkeypatch):
    """The dry run on the card raises with fewer cards than ranks; it
    never stands CPU processes in for them."""
    from apr_torch.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices and has 0"):
        dryrun_multichip(2)

