"""The port's nuScenes, 3DMatch (indoor) and ModelNet loaders against
apr_tpu's on trees written here.

Tolerance: none.  Pair lists and labels are equal exactly, clouds and
``t_gt`` bit for bit.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from apr_torch.data.synthetic import write_kitti_sequence

FIELDS = dict(pair_min_dist=5.0, pair_max_dist=10.0, complement_pair_dist=4.0,
              num_complement_one_side=2, seed=0)
LOGS = {"train": ("log-0001", "log-0002"), "test": ("log-0100",)}


def write_nuscenes(root, frames=60, n_points=2000):
    """{root}/{phase}/sequences/<log>/velodyne/*.bin with poses.npy (lidar
    -> world); returns {log: poses}."""
    poses = {}
    for phase, logs in LOGS.items():
        for k, log_name in enumerate(logs):
            seq = os.path.join(root, phase, "sequences", log_name)
            poses[log_name] = write_kitti_sequence(
                seq, frames, n_points=n_points, step=2.0, radius=25.0,
                seed=10 + k)
            np.save(os.path.join(seq, "poses.npy"), poses[log_name])
    return poses


@pytest.fixture(scope="module")
def nuscenes(tmp_path_factory):
    """A converted nuScenes tree with an ICP cache under
    {root}/icp_nuscenes/ for every other pair of the train walk."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.nuscenes import NuscenesComplementDataset

    root = str(tmp_path_factory.mktemp("nuscenes"))
    poses = write_nuscenes(root)
    ref = NuscenesComplementDataset(RefConfig(kitti_root=root, **FIELDS),
                                    "train")
    os.makedirs(os.path.join(root, "icp_nuscenes"))
    for log_name, t0, t1, c0, _ in ref.files[::2]:
        for a, b in [(t0, t1)] + [(int(c), t0) for c in c0]:
            m = np.linalg.inv(poses[log_name][b]) @ poses[log_name][a]
            m[:3, 3] += 0.01
            np.save(os.path.join(root, "icp_nuscenes",
                                 "%s_%d_%d.npy" % (log_name, a, b)), m)
    return root


def _pair(ref_cls, port_cls, root, phase, **over):
    from apr_tpu.config import APRConfig as RefConfig

    from apr_torch.config import APRConfig

    kw = dict(FIELDS, kitti_root=root, **over)
    return ref_cls(RefConfig(**kw), phase), port_cls(APRConfig(**kw), phase)


def _items_equal(ref, ours, indices):
    for i in indices:
        a, b = ref.get_pair(i), ours.get_pair(i)
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("phase", ["train", "test"])
def test_nuscenes(nuscenes, phase):
    """Log-name sequences, poses.npy, the ICP cache where present, the
    train split's files[::3][:1200]."""
    from apr_tpu.data.nuscenes import NuscenesComplementDataset as Ref

    from apr_torch.data.nuscenes import NuscenesComplementDataset

    ref, ours = _pair(Ref, NuscenesComplementDataset, nuscenes, phase)
    assert len(ours) > 0 and ours.files == ref.files
    assert {f[0] for f in ours.files} <= set(LOGS[phase])
    _items_equal(ref, ours, range(min(3, len(ref))))


@pytest.mark.parametrize("where", ["root", "packaged"])
def test_lonuscenes(nuscenes, tmp_path, where):
    from apr_tpu.data.nuscenes import NuscenesComplementDataset as Ref

    from apr_torch.data.nuscenes import NuscenesComplementDataset

    root = nuscenes
    if where == "root":
        fixed = np.array([["log-0100", 10, 20], ["log-0100", 15, 26]],
                         dtype=object)
        np.save(os.path.join(root, "file_LoNUSCENES_50.npy"), fixed)
    else:
        root = str(tmp_path)
        os.symlink(os.path.join(nuscenes, "test"),
                   os.path.join(root, "test"))
    try:
        ref, ours = _pair(Ref, NuscenesComplementDataset, root, "test",
                          LoNUSCENES=True)
        assert ours.files == ref.files
        if where == "root":
            assert ours.files == [("log-0100", 10, 20), ("log-0100", 15, 26)]
            _items_equal(ref, ours, range(2))
        else:
            assert len(ours.files) == 994
    finally:
        if where == "root":
            os.remove(os.path.join(root, "file_LoNUSCENES_50.npy"))


def write_indoor(root):
    """{root}/configs/{phase}_info.pkl; fragments as torch-saved arrays
    (.pth) and .npy files."""
    from apr_torch.geometry.rotation import euler_matrix

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "frags"))
    os.makedirs(os.path.join(root, "configs"))
    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "overlap": []}
    for i in range(4):
        cloud = rng.uniform(-1, 1, (600 + 100 * i, 3)).astype(np.float32)
        rot = euler_matrix("zyx", rng.uniform(-1, 1, 3))
        trans = rng.uniform(-0.5, 0.5, (3, 1))
        tgt = (cloud @ rot.T + trans[:, 0]).astype(np.float32)
        torch.save(cloud, os.path.join(root, "frags", f"src_{i}.pth"))
        np.save(os.path.join(root, "frags", f"tgt_{i}.npy"), tgt)
        infos["rot"].append(rot)
        infos["trans"].append(trans if i % 2 else trans[:, 0])
        infos["src"].append(f"frags/src_{i}.pth")
        infos["tgt"].append(f"frags/tgt_{i}.npy")
        infos["overlap"].append(0.5 + 0.1 * i)
    for phase in ("train", "test"):
        with open(os.path.join(root, "configs", f"{phase}_info.pkl"),
                  "wb") as f:
            pickle.dump(infos, f)
    return root


@pytest.fixture(scope="module")
def indoor(tmp_path_factory):
    return write_indoor(str(tmp_path_factory.mktemp("indoor")))


@pytest.mark.parametrize("phase", ["train", "test"])
def test_indoor(indoor, phase):
    """The one-sided zyx rotation and the noise (train), the subsample of
    fragments above max_points, .pth and .npy fragments."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.indoor import IndoorDataset as Ref

    from apr_torch.config import APRConfig
    from apr_torch.data.indoor import IndoorDataset

    ref = Ref(RefConfig(kitti_root=indoor, seed=3), phase, max_points=700)
    ours = IndoorDataset(APRConfig(kitti_root=indoor, seed=3), phase,
                         max_points=700)
    assert len(ours) == len(ref) == 4
    _items_equal(ref, ours, range(4))


def test_modelnet(tmp_path):
    h5py = pytest.importorskip("h5py")
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.modelnet import ModelNetHdf as Ref

    from apr_torch.config import APRConfig
    from apr_torch.data.modelnet import ModelNetHdf

    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        with h5py.File(tmp_path / f"ply_data_{split}0.h5", "w") as f:
            f["data"] = rng.uniform(-1, 1, (5, 2048, 3)).astype(np.float32)
            f["label"] = np.arange(5).reshape(-1, 1)
    with open(tmp_path / "shape_names.txt", "w") as f:
        f.write("\n".join(f"shape{i}" for i in range(5)) + "\n")
    for phase, kw in (("train", {}),
                      ("test", dict(categories=["shape1", "shape3"]))):
        ref = Ref(RefConfig(kitti_root=str(tmp_path), seed=2), phase, **kw)
        ours = ModelNetHdf(APRConfig(kitti_root=str(tmp_path), seed=2),
                           phase, **kw)
        assert len(ours) == len(ref)
        np.testing.assert_array_equal(ours.labels, ref.labels)
        _items_equal(ref, ours, range(len(ref)))
