"""The port's benchmark utilities (apr_torch/registration/benchmark_utils.py),
3DMatch trajectory benchmark (apr_torch/eval/benchmark3dmatch.py) and
trajectory files (apr_torch/utils/trajectory.py) against apr_tpu's on the
CPU, from the same seeded numpy inputs.

Tolerances: inlier ratios within 1e-6 (float32 sums of 0/1 weights; the
feature NN is the same float32 search on both sides); the recall sweep,
mutual selection, the benchmark_scene counts and the trajectory files
exact (byte for byte); transformation errors within 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apr_tpu.eval import benchmark3dmatch as ref_bench
from apr_tpu.registration import benchmark_utils as ref_bu
from apr_tpu.utils import trajectory as ref_traj

from apr_torch.eval import benchmark3dmatch as bench
from apr_torch.registration import benchmark_utils as bu
from apr_torch.utils import trajectory as traj


def _clouds(seed, n=400, m=450, c=16):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.3, -0.1, 0.2]
    tgt = np.concatenate([src[:m] + t[:3, 3],
                          rng.uniform(-5, 5, (max(m - n, 0), 3))])
    tgt = tgt.astype(np.float32)
    fs = rng.normal(size=(n, c)).astype(np.float32)
    ft = np.concatenate([fs[:m], rng.normal(size=(max(m - n, 0), c))])
    ft = (ft + rng.normal(0, 0.4, ft.shape)).astype(np.float32)
    return src, tgt, fs, ft, t, rng


@pytest.mark.parametrize("masked", [False, True])
def test_inlier_ratio_matches(masked):
    src, tgt, fs, ft, t, rng = _clouds(0)
    sm = rng.random(len(src)) < 0.8 if masked else None
    tm = rng.random(len(tgt)) < 0.7 if masked else None
    want = ref_bu.get_inlier_ratio(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(fs), jnp.asarray(ft),
        jnp.asarray(t), None if sm is None else jnp.asarray(sm),
        None if tm is None else jnp.asarray(tm), 0.1)
    th = torch.from_numpy
    got = bu.get_inlier_ratio(th(src), th(tgt), th(fs), th(ft), th(t),
                              None if sm is None else th(sm),
                              None if tm is None else th(tm), 0.1)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    assert 0 < float(got["inlier_ratio_mutual"]) <= 1


def test_recall_sweep_and_mutual_selection_match():
    rng = np.random.default_rng(1)
    ratios = rng.uniform(0, 0.3, 50)
    np.testing.assert_array_equal(bu.feature_match_recall_sweep(ratios),
                                  ref_bu.feature_match_recall_sweep(ratios))
    np.testing.assert_array_equal(
        bu.feature_match_recall_sweep(ratios, (0.05, 0.1)),
        ref_bu.feature_match_recall_sweep(ratios, (0.05, 0.1)))
    scores = rng.integers(0, 6, (30, 40)).astype(np.float32)   # with ties
    np.testing.assert_array_equal(
        bu.mutual_selection(torch.from_numpy(scores)).numpy(),
        np.asarray(ref_bu.mutual_selection(jnp.asarray(scores))))


def _rot(axis, angle):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def _poses(rng, n, scale=1.0):
    """Rotations by up to ``scale`` rad, translations of about ``scale``
    metres."""
    out = []
    for _ in range(n):
        p = np.eye(4)
        p[:3, :3] = _rot(rng.normal(size=3), rng.uniform(0, scale))
        p[:3, 3] = scale * rng.normal(size=3)
        out.append(p)
    return out


def test_transformation_error_matches():
    rng = np.random.default_rng(2)
    info = rng.normal(size=(6, 6))
    info = info @ info.T + np.eye(6)
    gts = _poses(rng, 12, 2.0)
    for gt in gts:
        for est in (gt @ _poses(rng, 1, 0.2)[0], gt):
            assert abs(bench.transformation_error(est, gt, info)
                       - ref_bench.transformation_error(est, gt, info)) \
                <= 1e-12
    # w < 1e-6: rotations by pi about each axis and a mixed one; and a
    # rotation past pi, where w >= 0 flips the quaternion's sign
    for axis, ang in (([1, 0, 0], np.pi), ([0, 1, 0], np.pi),
                      ([0, 0, 1], np.pi), ([1, 2, 3], np.pi),
                      ([0.3, -1, 0.2], 1.9 * np.pi)):
        est = np.eye(4)
        est[:3, :3] = _rot(axis, ang)
        est[:3, 3] = [0.1, 0.2, -0.3]
        r = est[:3, :3]
        np.testing.assert_allclose(bench._rot_to_quat(r),
                                   ref_bench._rot_to_quat(r), rtol=0,
                                   atol=1e-12)
        assert abs(bench.transformation_error(est, np.eye(4), info)
                   - ref_bench.transformation_error(est, np.eye(4), info)) \
            <= 1e-12


def _scene_files(root, rng, module, scene):
    d = root / scene
    d.mkdir(parents=True, exist_ok=True)
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    gts = _poses(rng, len(pairs), 2.0)
    infos = []
    for _ in pairs:
        a = rng.normal(size=(6, 6))
        infos.append(a @ a.T * 100 + np.eye(6) * 300)
    est = [g @ _poses(rng, 1, s)[0] for g, s in
           zip(gts, rng.choice([0.001, 0.01, 0.5], len(pairs)))]
    for name, mats, dim in (("gt.log", gts, 4), ("gt.info", infos, 6),
                            ("est.log", est, 4)):
        module.write_trajectory(
            str(d / name), [module.CameraPose((i, j, 6), m)
                            for (i, j), m in zip(pairs, mats)], dim=dim)
    return d


def test_trajectory_files_and_benchmark_match(tmp_path):
    """Both writers give the same bytes, both readers the same poses, and
    benchmark_scene / benchmark the same counts and recalls."""
    scenes = ["kitchen", "hotel"]
    for who, module in (("ref", ref_traj), ("port", traj)):
        rng = np.random.default_rng(3)
        for s in scenes:
            _scene_files(tmp_path / who, rng, module, s)
    for s in scenes:
        for name in ("gt.log", "gt.info", "est.log"):
            assert (tmp_path / "port" / s / name).read_bytes() == \
                (tmp_path / "ref" / s / name).read_bytes()
        d = tmp_path / "port" / s
        got = traj.read_trajectory(str(d / "est.log"))
        want = ref_traj.read_trajectory(str(d / "est.log"))
        assert [p.meta for p in got] == [p.meta for p in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.pose, w.pose)
        info = traj.read_info(str(d / "gt.info"))
        assert info[0].pose.shape == (6, 6)
        args = [traj.read_trajectory(str(d / "est.log")),
                traj.read_trajectory(str(d / "gt.log")),
                traj.read_info(str(d / "gt.info"))]
        got_s = bench.benchmark_scene(*args)
        want_s = ref_bench.benchmark_scene(*args)
        assert got_s == want_s
        assert 0 < got_s["n_good"] < got_s["n_gt"]
    root = str(tmp_path / "port")
    assert bench.benchmark(root, root, scenes) == ref_bench.benchmark(
        root, root, scenes)
