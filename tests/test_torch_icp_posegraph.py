"""The port's ICP, information matrix, pose graph and multiway registration
(apr_torch/geometry/{icp,pose_graph}.py, apr_torch/data/multiway.py) against
apr_tpu's on the CPU, from the same seeded numpy inputs.

Tolerances: ICP transforms within 1e-6 with equal fitness and iteration
count (measured: equal bit for bit, the float32 search picks the float64
nearest on these clouds); information matrices rtol 1e-9; se3_exp /
se3_log within 1e-12 (the θ≈π branch included); pose-graph node poses
within 1e-8; multiway transforms within 1e-6; the voxel dedup's rows and
order exactly.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from apr_tpu.data import multiway as ref_multiway
from apr_tpu.geometry import icp as ref_icp
from apr_tpu.geometry import pose_graph as ref_pg

from apr_torch.data import multiway
from apr_torch.geometry import icp, pose_graph
from apr_torch.utils.pointcloud import NearestSearch

from test_icp_posegraph import _cloud, _rigid


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _icp_case(seed, n, dtype):
    rng = np.random.default_rng(seed)
    cloud = _cloud(rng, n=n)
    t_gt = _rigid(rng)
    target = cloud @ t_gt[:3, :3].T + t_gt[:3, 3]
    init = _rigid(rng, rot=0.02, trans=0.1) @ t_gt
    return cloud.astype(dtype), target.astype(dtype), init


@pytest.mark.parametrize("seed,n,dtype,max_corr", [
    (0, 2000, np.float64, 0.3), (1, 1500, np.float32, 0.3),
    (2, 800, np.float32, 0.05)])
def test_registration_icp_matches(seed, n, dtype, max_corr):
    src, tgt, init = _icp_case(seed, n, dtype)
    want = ref_icp.registration_icp(src, tgt, max_corr, init,
                                    max_iteration=100)
    got = icp.registration_icp(src, tgt, max_corr, init, max_iteration=100,
                               device="cpu")
    np.testing.assert_allclose(got.transformation, want.transformation,
                               rtol=0, atol=1e-6)
    assert got.fitness == want.fitness
    assert got.num_iterations == want.num_iterations
    assert abs(got.inlier_rmse - want.inlier_rmse) <= 1e-9


def test_registration_icp_identity_and_no_matches():
    rng = np.random.default_rng(3)
    cloud = _cloud(rng, n=500)
    got = icp.registration_icp(cloud, cloud, 0.2, device="cpu")
    np.testing.assert_allclose(got.transformation, np.eye(4), atol=1e-9)
    assert got.inlier_rmse < 1e-9
    # a target out of reach: no match, one search, the init returned
    far = cloud + 100.0
    want = ref_icp.registration_icp(cloud, far, 0.2)
    got = icp.registration_icp(cloud, far, 0.2, device="cpu")
    assert (got.num_iterations, got.fitness) == (want.num_iterations,
                                                 want.fitness) == (1, 0.0)
    np.testing.assert_array_equal(got.transformation, want.transformation)


def test_nearest_search_bound_is_strict():
    """cKDTree's distance_upper_bound is strict: a point at exactly the
    bound is no match and gets (inf, len(target))."""
    target = np.array([[0.5, 0.0, 0.0], [3.0, 0.0, 0.0]], np.float32)
    queries = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.1],
                        [2.6, 0.0, 0.0], [9.0, 9.0, 9.0]])
    for bound in (0.5, 0.4, 0.51, np.inf):
        want = cKDTree(target).query(queries, k=1,
                                     distance_upper_bound=bound)
        got = NearestSearch(target, "cpu").query(queries, bound)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_nearest_search_matches_ckdtree():
    rng = np.random.default_rng(4)
    target = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    queries = rng.uniform(-21, 21, (2000, 3))
    want = cKDTree(target).query(queries, k=1, distance_upper_bound=0.8)
    got = NearestSearch(target, "cpu").query(queries, 0.8)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_information_matrix_matches(dtype):
    src, tgt, init = _icp_case(5, 1200, dtype)
    for t in (init, np.eye(4)):
        want = ref_icp.information_matrix(src, tgt, 0.3, t)
        got = icp.information_matrix(src, tgt, 0.3, t, device="cpu")
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


def _near_pi_transforms():
    from scipy.spatial.transform import Rotation

    out = []
    for axis in ([1, 0, 0], [0, 1, 0], [0.6, -0.8, 0.0], [0.5, 0.5, 0.7]):
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        for ang in (np.pi, np.pi - 1e-8, np.pi - 1e-5):
            t = np.eye(4)
            t[:3, :3] = Rotation.from_rotvec(a * ang).as_matrix()
            t[:3, 3] = [1.0, -2.0, 0.5]
            out.append(t)
    return out


def test_se3_exp_log_match():
    rng = np.random.default_rng(6)
    xis = [rng.uniform(-1, 1, 6) for _ in range(20)]
    xis += [np.r_[rng.uniform(-1e-11, 1e-11, 3), rng.uniform(-1, 1, 3)]]
    for xi in xis:
        np.testing.assert_allclose(pose_graph.se3_exp(xi),
                                   ref_pg.se3_exp(xi), rtol=0, atol=1e-12)
        t = ref_pg.se3_exp(xi)
        np.testing.assert_allclose(pose_graph.se3_log(t), ref_pg.se3_log(t),
                                   rtol=0, atol=1e-12)
    for t in _near_pi_transforms() + [np.eye(4)]:
        got, want = pose_graph.se3_log(t), ref_pg.se3_log(t)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _graph(module, rng_seed):
    """A 4-node graph of noisy odometry edges and loop closures with
    random information matrices, built from the same draws for either
    module."""
    rng = np.random.default_rng(rng_seed)
    true = [np.eye(4)] + [_rigid(rng, rot=0.3, trans=3.0) for _ in range(3)]
    nodes = [module.PoseGraphNode(p @ _rigid(rng, rot=0.02, trans=0.1)
                                  if i else p.copy())
             for i, p in enumerate(true)]
    edges = []
    for s in range(4):
        for t in range(s + 1, 4):
            z = _rigid(rng, rot=0.01, trans=0.05) @ np.linalg.inv(true[t]) \
                @ true[s]
            a = rng.normal(size=(6, 6))
            edges.append(module.PoseGraphEdge(s, t, z, 50 * a @ a.T + np.eye(6),
                                              uncertain=t != s + 1))
    return module.PoseGraph(nodes=nodes, edges=edges)


@pytest.mark.parametrize("seed", [0, 1])
def test_global_optimization_matches(seed):
    want = ref_pg.global_optimization(_graph(ref_pg, seed))
    got = pose_graph.global_optimization(_graph(pose_graph, seed))
    for g, w in zip(got.nodes, want.nodes):
        np.testing.assert_allclose(g.pose, w.pose, rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxel_dedup_rows_and_order(dtype):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3, 3, (4000, 3)).astype(dtype)
    # points on voxel faces and duplicated voxels
    pts[:200] = np.round(pts[:200] / 0.05) * 0.05
    pts[200:400] = pts[:200] + 0.001
    for voxel in (0.05, 0.3):
        got = multiway._voxel_dedup(pts, voxel, "cpu")
        want = ref_multiway._voxel_dedup(pts, voxel)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert multiway._voxel_dedup(pts[:0], 0.05, "cpu").shape == (0, 3)


def test_multiway_complement_transforms_match():
    rng = np.random.default_rng(8)
    world = _cloud(rng, n=1500, extent=15.0)
    gts = [_rigid(rng, rot=0.05, trans=2.0) for _ in range(4)]
    inv = np.linalg.inv
    cmpls = [(world @ inv(t)[:3, :3].T + inv(t)[:3, 3]).astype(np.float32)
             for t in gts]
    inits = [_rigid(rng, rot=0.01, trans=0.1) @ t for t in gts]
    kw = dict(num_one_side=2, icp_voxel_size=0.2, max_corr_fine=0.4)
    want = ref_multiway.multiway_complement_transforms(
        world.astype(np.float32), cmpls, inits, **kw)
    got = multiway.multiway_complement_transforms(
        world.astype(np.float32), cmpls, inits, device="cpu", **kw)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
