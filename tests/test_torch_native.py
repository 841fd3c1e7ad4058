"""apr_torch.native (the port's host C++ library, built with g++ from
apr_torch/csrc/geometry.cpp into build/apr_torch_kernels/) and its numpy
fallbacks against apr_tpu.native.

Integers (voxel counts, dedup selections, neighbour tables) must be equal;
floats (barycenters, feature means) within 1e-6 (measured: equal, both
libraries run the same source with the same flags, and the fallbacks sum
in float64 in the same order).
"""

import numpy as np
import pytest

from apr_torch import native
from apr_tpu import native as ref_native


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (5000, 3)).astype(np.float32)
    feats = rng.normal(size=(5000, 4)).astype(np.float32)
    queries = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    return pts, feats, queries


@pytest.fixture
def ref_fallbacks(monkeypatch):
    """apr_tpu.native with its library unavailable: its numpy paths."""
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)


def test_the_library_builds_under_build_from_the_ports_source():
    assert native.get_lib() is not None
    path = native.lib_path()
    assert path.is_file()
    assert path.parent.parent == native.BUILD_ROOT
    assert path.parent.parent.parts[-2:] == ("build", "apr_torch_kernels")
    assert native.SOURCE.parts[-3:] == ("apr_torch", "csrc", "geometry.cpp")


@pytest.mark.parametrize("capacity", [None, 300])
def test_library_matches_the_reference_library(clouds, capacity):
    pts, feats, queries = clouds
    assert ref_native.get_lib() is not None
    for voxel in (0.5, 1.3):
        got = native.grid_subsample(pts, voxel, capacity, feats)
        want = ref_native.grid_subsample(pts, voxel, capacity, feats)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        got, _ = native.grid_subsample(pts, voxel, capacity)
        np.testing.assert_allclose(got, want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            native.voxel_dedup(pts, voxel, capacity),
            ref_native.voxel_dedup(pts, voxel, capacity))
    for cap in (1, 16):
        np.testing.assert_array_equal(
            native.radius_neighbors(queries, pts, 0.8, cap),
            ref_native.radius_neighbors(queries, pts, 0.8, cap))


def test_fallbacks_match_the_reference_fallbacks(clouds, ref_fallbacks):
    pts, feats, queries = clouds
    for voxel, cap in ((0.5, 5000), (1.3, 200)):
        got = native.grid_subsample_numpy(pts, voxel, cap, feats)
        want = ref_native.grid_subsample(pts, voxel, cap, feats)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            native.voxel_dedup_numpy(pts, voxel, cap),
            ref_native.voxel_dedup(pts, voxel, cap))
    for cap in (1, 16):
        np.testing.assert_array_equal(
            native.radius_neighbors_numpy(queries, pts, 0.8, cap),
            ref_native.radius_neighbors(queries, pts, 0.8, cap))


def test_without_a_compiler_the_fallbacks_run_and_say_so(
        clouds, monkeypatch, tmp_path, capsys):
    pts, feats, queries = clouds
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))       # no g++ on it
    assert native.get_lib() is None
    assert "numpy fallbacks" in capsys.readouterr().err
    got = native.grid_subsample(pts, 0.5, None, feats)
    want = native.grid_subsample_numpy(pts, 0.5, len(pts), feats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(native.voxel_dedup(pts, 0.5),
                                  native.voxel_dedup_numpy(pts, 0.5,
                                                           len(pts)))
    np.testing.assert_array_equal(
        native.radius_neighbors(queries, pts, 0.8, 8),
        native.radius_neighbors_numpy(queries, pts, 0.8, 8))
