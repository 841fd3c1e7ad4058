"""The port's point-cloud utilities (apr_torch/utils/pointcloud.py) and its
``cal_overlap`` tool against apr_tpu's and the root tools/cal_overlap.py on
the CPU, from the same seeded numpy inputs.

Tolerances: none.  Matching-index sets (k=None) equal the reference's
exactly as sets of sorted rows; with k, each source point keeps the k
lowest indices of the reference's set (the reference keeps the first k of
cKDTree's tree order, which is not sorted); overlap ratios, feature-match
ratios and the overlaps.txt file are equal byte for byte.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from apr_tpu.utils import pointcloud as ref

from apr_torch.utils import pointcloud

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(seed, n0=1500, n1=1800, dtype=np.float32):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (max(n0, n1), 3))
    t = np.eye(4)
    a = 0.3
    t[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    t[:3, 3] = [0.4, -0.2, 0.1]
    p0 = base[:n0] + rng.normal(0, 0.02, (n0, 3))
    p1 = (base[:n1] @ t[:3, :3].T + t[:3, 3]) + rng.normal(0, 0.02, (n1, 3))
    return p0.astype(dtype), p1.astype(dtype), t


@pytest.mark.parametrize("seed,dtype,radius", [
    (0, np.float32, 0.1), (1, np.float64, 0.25), (2, np.float32, 0.6)])
def test_matching_indices_match(seed, dtype, radius):
    p0, p1, t = _pair(seed, 600, 700, dtype)
    want = ref.get_matching_indices(p0, p1, t, radius)
    got = pointcloud.get_matching_indices(p0, p1, t, radius, device="cpu")
    assert got.dtype == np.int64 and got.shape[1] == 2 and len(got)
    np.testing.assert_array_equal(got, want[np.lexsort(want.T[::-1])])
    for k in (1, 3):
        want_k = ref.get_matching_indices(p0, p1, t, radius, k=k)
        got_k = pointcloud.get_matching_indices(p0, p1, t, radius, k=k,
                                                device="cpu")
        # the same count per source point, and the lowest indices of the
        # full set
        np.testing.assert_array_equal(np.bincount(got_k[:, 0], minlength=600),
                                      np.bincount(want_k[:, 0], minlength=600))
        keep = np.concatenate([
            got[got[:, 0] == i][:k] for i in np.unique(got[:, 0])])
        np.testing.assert_array_equal(got_k, keep)


def test_matching_indices_radius_is_inclusive():
    """query_ball_point keeps a point at exactly the radius."""
    src = np.zeros((1, 3))
    tgt = np.array([[0.5, 0, 0], [0, 0.75, 0], [0, 0, 0.25]])
    for r in (0.25, 0.5, 0.75, 0.7):
        want = ref.get_matching_indices(src, tgt, np.eye(4), r)
        got = pointcloud.get_matching_indices(src, tgt, np.eye(4), r,
                                              device="cpu")
        np.testing.assert_array_equal(got, np.sort(want, axis=0))


@pytest.mark.parametrize("seed,dtype,voxel", [
    (3, np.float32, 0.05), (4, np.float64, 0.03), (5, np.float32, 0.2)])
def test_overlap_ratio_matches(seed, dtype, voxel):
    p0, p1, t = _pair(seed, dtype=dtype)
    for trans in (t, np.eye(4)):
        want = ref.compute_overlap_ratio(p0, p1, trans, voxel)
        got = pointcloud.compute_overlap_ratio(p0, p1, trans, voxel,
                                               device="cpu")
        assert got == want


def test_feature_match_matches():
    rng = np.random.default_rng(6)
    p0, p1, t = _pair(6, 700, 700)
    f0 = rng.normal(size=(700, 16)).astype(np.float32)
    f1 = f0 + rng.normal(0, 0.3, f0.shape).astype(np.float32)
    want = ref.evaluate_feature_match(f0, f1, p0, p1, t, 0.1)
    got = pointcloud.evaluate_feature_match(f0, f1, p0, p1, t, 0.1,
                                            device="cpu")
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_cal_overlap_file_matches(tmp_path, monkeypatch):
    """``python -m apr_torch.tools.cal_overlap`` writes the root tool's
    overlaps.txt byte for byte."""
    from apr_torch.tools import cal_overlap

    frag = tmp_path / "fragments"
    frag.mkdir()
    rng = np.random.default_rng(7)
    base = rng.uniform(-4, 4, (2500, 3))
    for i in range(4):
        sel = rng.choice(len(base), 1200, replace=False)
        cloud = base[sel] + rng.normal(0, 0.01, (1200, 3))
        np.save(frag / f"cloud_bin_{i}.npy",
                cloud.astype(np.float32 if i % 2 else np.float64))
    spec = importlib.util.spec_from_file_location(
        "ref_cal_overlap", os.path.join(_ROOT, "tools", "cal_overlap.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tmp_path / "want.txt"
    monkeypatch.setattr(sys, "argv", ["cal_overlap.py", "--dir", str(frag),
                                      "--voxel", "0.08", "--out", str(want)])
    tool.main()
    got = tmp_path / "got.txt"
    cal_overlap.main(["--dir", str(frag), "--voxel", "0.08", "--out",
                      str(got), "--device", "cpu"])
    assert got.read_bytes() == want.read_bytes()
    assert len(got.read_text().splitlines()) == 6
