"""``python -m apr_torch.tools.export_nuscenes_kitti`` against the root
``tools/export_nuscenes_kitti.py`` on a stub nuScenes devkit.

The stub (``nuscenes.nuscenes.NuScenes`` and
``nuscenes.utils.splits.create_splits_logs`` in ``sys.modules``) holds two
logs of the split and one outside it, three key frames a scene, random
unit quaternions and translations, and ``.bin`` sweeps of 5 float32 values
a point written from a seed.  Both tools write the same tree: every
velodyne ``.bin`` equal byte for byte and every ``poses.npy`` equal
exactly (float64).  Without the devkit both stop with the same
``SystemExit``.
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest

from apr_torch.tools import export_nuscenes_kitti as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = (("scene-0001", "log-a"), ("scene-0002", "log-b"),
          ("scene-0003", "log-elsewhere"))
FRAMES = 3


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_export_nuscenes_kitti",
        os.path.join(ROOT, "tools", "export_nuscenes_kitti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables(root):
    """The devkit's tables of the stub dataset; writes its sweeps."""
    rng = np.random.default_rng(0)
    tables = {k: {} for k in ("scene", "log", "sample", "sample_data",
                              "ego_pose", "calibrated_sensor")}
    os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)

    def pose():
        q = rng.normal(size=4)
        return dict(translation=list(rng.uniform(-500, 500, 3)),
                    rotation=list(q / np.linalg.norm(q)))

    scenes = []
    for s, (name, logfile) in enumerate(SCENES):
        tables["log"][f"L{s}"] = dict(logfile=logfile)
        tokens = [f"S{s}_{f}" for f in range(FRAMES)]
        for f, tok in enumerate(tokens):
            fname = f"sweeps/{name}_{f}.pcd.bin"
            n = int(rng.integers(50, 200))
            rng.normal(scale=20.0, size=(n, 5)).astype(np.float32).tofile(
                os.path.join(root, fname))
            tables["ego_pose"][f"E{tok}"] = pose()
            tables["calibrated_sensor"][f"C{tok}"] = pose()
            tables["sample_data"][f"D{tok}"] = dict(
                filename=fname, ego_pose_token=f"E{tok}",
                calibrated_sensor_token=f"C{tok}")
            tables["sample"][tok] = dict(
                data={"LIDAR_TOP": f"D{tok}"},
                next=tokens[f + 1] if f + 1 < FRAMES else "")
        scenes.append(dict(name=name, log_token=f"L{s}",
                           first_sample_token=tokens[0]))
    return scenes, tables


@pytest.fixture
def devkit(tmp_path, monkeypatch):
    root = str(tmp_path / "nusc")
    scenes, tables = _tables(root)
    made = []

    class NuScenes:
        def __init__(self, version, dataroot):
            made.append((version, dataroot))
            self.scene = scenes

        def get(self, table, token):
            return tables[table][token]

    def create_splits_logs(split, nusc):
        assert split == "val"
        return ["log-a", "log-b"]

    pkg = types.ModuleType("nuscenes")
    mods = {"nuscenes": pkg,
            "nuscenes.nuscenes": types.ModuleType("nuscenes.nuscenes"),
            "nuscenes.utils": types.ModuleType("nuscenes.utils"),
            "nuscenes.utils.splits": types.ModuleType(
                "nuscenes.utils.splits")}
    mods["nuscenes.nuscenes"].NuScenes = NuScenes
    mods["nuscenes.utils.splits"].create_splits_logs = create_splits_logs
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return root, made


def _files(top):
    out = {}
    for d, _, names in os.walk(top):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, top)] = p
    return out


def test_port_writes_the_references_tree(devkit, tmp_path, monkeypatch):
    root, made = devkit
    argv = ["--nusc_root", root, "--version", "v1.0-mini", "--split", "val"]
    monkeypatch.setattr(sys, "argv", ["export_nuscenes_kitti.py", *argv,
                                      "--out_root", str(tmp_path / "ref")])
    _reference().main()
    port.main(argv + ["--out_root", str(tmp_path / "port")])
    assert made == [("v1.0-mini", root)] * 2
    ref, ours = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(ours) == sorted(ref)
    assert len(ours) == 2 * (FRAMES + 1)       # the third log is not in val
    assert "val/sequences/scene-0001/velodyne/000002.bin" in ours
    for rel, path in ref.items():
        if rel.endswith(".bin"):
            with open(path, "rb") as a, open(ours[rel], "rb") as b:
                assert a.read() == b.read()
        else:
            want, got = np.load(path), np.load(ours[rel])
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)
            assert got.shape == (FRAMES, 4, 4)
            np.testing.assert_allclose(
                got[:, :3, :3] @ got[:, :3, :3].transpose(0, 2, 1),
                np.broadcast_to(np.eye(3), (FRAMES, 3, 3)), atol=1e-12)


def test_pose_helpers_equal_the_references():
    ref = _reference()
    rng = np.random.default_rng(1)
    for _ in range(5):
        q = rng.normal(size=4)
        t = rng.uniform(-10, 10, 3)
        np.testing.assert_array_equal(port.pose_matrix(t, q),
                                      ref.pose_matrix(t, q))
    np.testing.assert_array_equal(port.quaternion_matrix(0, 0, 0, 0),
                                  np.eye(3))


def test_missing_devkit_stops_with_the_references_message(tmp_path,
                                                          monkeypatch):
    for name in ("nuscenes", "nuscenes.nuscenes", "nuscenes.utils",
                 "nuscenes.utils.splits"):
        monkeypatch.setitem(sys.modules, name, None)
    argv = ["--nusc_root", str(tmp_path), "--out_root", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["export_nuscenes_kitti.py", *argv])
    with pytest.raises(SystemExit) as want:
        _reference().main()
    with pytest.raises(SystemExit) as got:
        port.main(argv)
    assert str(got.value) == str(want.value)
    assert "nuscenes-devkit is required" in str(got.value)
