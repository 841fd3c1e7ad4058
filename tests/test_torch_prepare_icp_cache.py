"""``python -m apr_torch.tools.prepare_icp_cache`` against the root
tools/prepare_icp_cache.py (apr_tpu's multiway_complement_transforms /
registration_icp calls) on a small KITTI-format tree, on the CPU.

Tolerances: the same file names, each transform within 1e-6 (measured:
bit for bit, every search picks the float64 nearest); then the port's
``KittiComplementDataset(use_old_pose=True)`` reads the port's cache and
gives apr_tpu's pair over the reference's cache bit for bit, as in
tests/test_torch_kitti_data.py.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from apr_torch.data.synthetic import write_kitti_tree

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sequence 00 (train) of 1500-point frames 2 m apart: two train pairs at
# these walk settings, 13 ICPs each (2 complements a side)
FLAGS = ["--pair_min_dist", "5", "--pair_max_dist", "10",
         "--complement_pair_dist", "4", "--num_complement_one_side", "2"]
FIELDS = dict(pair_min_dist=5.0, pair_max_dist=10.0, complement_pair_dist=4.0,
              num_complement_one_side=2, seed=0, use_old_pose=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "ref_prepare_icp_cache",
        os.path.join(_ROOT, "tools", "prepare_icp_cache.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One tree, the reference tool's cache moved to ``icp_ref``, the
    port's left in ``icp``."""
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_tree(root, {0: 30}, n_points=1500, step=2.0, radius=30.0)
    argv = sys.argv
    sys.argv = ["prepare_icp_cache.py", "--kitti_root", root] + FLAGS
    try:
        _reference_tool().main()
    finally:
        sys.argv = argv
    shutil.move(os.path.join(root, "icp"), os.path.join(root, "icp_ref"))
    from apr_torch.tools import prepare_icp_cache

    summary = prepare_icp_cache.main(["--kitti_root", root, "--device",
                                      "cpu"] + FLAGS)
    return root, summary


def test_cache_matches_the_reference_tool(caches):
    root, summary = caches
    names = sorted(os.listdir(os.path.join(root, "icp")))
    assert names == sorted(os.listdir(os.path.join(root, "icp_ref")))
    assert summary["written"] >= len(names) > 10
    for name in names:
        got = np.load(os.path.join(root, "icp", name))
        want = np.load(os.path.join(root, "icp_ref", name))
        assert got.dtype == np.float64 and got.shape == (4, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_existing_files_are_kept(caches):
    root, _ = caches
    from apr_torch.tools import prepare_icp_cache

    stamp = {n: os.path.getmtime(os.path.join(root, "icp", n))
             for n in os.listdir(os.path.join(root, "icp"))}
    again = prepare_icp_cache.main(["--kitti_root", root, "--device", "cpu"]
                                   + FLAGS)
    assert again["written"] == 0
    assert stamp == {n: os.path.getmtime(os.path.join(root, "icp", n))
                     for n in os.listdir(os.path.join(root, "icp"))}


def test_pairwise_matches_the_reference_tool(tmp_path):
    """``--pairwise``: each complement's own ICP onto the key frame."""
    root = str(tmp_path)
    write_kitti_tree(root, {0: 24}, n_points=800, step=2.0, radius=30.0)
    argv = sys.argv
    sys.argv = ["prepare_icp_cache.py", "--kitti_root", root, "--pairwise"] \
        + FLAGS
    try:
        _reference_tool().main()
    finally:
        sys.argv = argv
    shutil.move(os.path.join(root, "icp"), os.path.join(root, "icp_ref"))
    from apr_torch.tools import prepare_icp_cache

    prepare_icp_cache.main(["--kitti_root", root, "--pairwise", "--device",
                            "cpu"] + FLAGS)
    names = sorted(os.listdir(os.path.join(root, "icp")))
    assert names and names == sorted(os.listdir(os.path.join(root,
                                                             "icp_ref")))
    for name in names:
        np.testing.assert_allclose(
            np.load(os.path.join(root, "icp", name)),
            np.load(os.path.join(root, "icp_ref", name)), rtol=0, atol=1e-6)


def test_odometry_pose_loader_reads_the_port_cache(caches):
    """The port's loader over the port's cache gives apr_tpu's pair over
    the reference's cache."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.kitti import KittiComplementDataset as RefDataset

    from apr_torch.config import APRConfig
    from apr_torch.data.kitti import KittiComplementDataset

    root, _ = caches
    ref_root = os.path.join(os.path.dirname(root), "ref_view")
    os.makedirs(ref_root, exist_ok=True)
    for item in ("sequences", "poses"):
        if not os.path.exists(os.path.join(ref_root, item)):
            os.symlink(os.path.join(root, item), os.path.join(ref_root, item))
    if not os.path.exists(os.path.join(ref_root, "icp")):
        os.symlink(os.path.join(root, "icp_ref"),
                   os.path.join(ref_root, "icp"))
    ds = KittiComplementDataset(APRConfig(kitti_root=root, **FIELDS),
                                "train")
    ref = RefDataset(RefConfig(kitti_root=ref_root, **FIELDS), "train")
    assert len(ds) == len(ref) == 2
    for i in range(len(ds)):
        got, want = ds.get_pair(i), ref.get_pair(i)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
