"""The port's package surface and the last two ops of ``apr_tpu/ops``.

- Each of the eight reference subpackages' ``__all__`` (ops,
  registration, training, losses, geometry, models, data, utils) is the
  port's matching ``__all__``, name for name, and every name imports,
  less the names the port leaves out on purpose (``LEFT_OUT``), which it
  does not export;
  ``training.TrainState`` is the port's trainer state.
- ``voxel_down_sample`` and ``grid_subsample`` against the reference's
  under ``jax.jit`` (its voxel coordinates use the float32 reciprocal of
  the voxel size, as compiled), on tests/test_ops_voxelize.py's cases plus
  a mask and an overflowing capacity: masks and counts exact, barycenters
  bit for bit, feature means within 1e-6 relative (measured: equal; both
  add each voxel's features in index order).
- The verify recipe ``from apr_torch.ops import voxelize,
  radius_neighbors, chamfer_distance`` on a small synthetic pair.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ref_vox = importlib.import_module("apr_tpu.ops.voxelize")

SUBPACKAGES = ("ops", "registration", "training", "losses", "geometry",
               "models", "data", "utils")
# reference exports the port leaves out on purpose, by subpackage:
# MinTimer, read by no module, test, tool or smoke phase of the port
LEFT_OUT = {"utils": ("MinTimer",)}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_every_reference_export_imports_from_the_port(name):
    ref = importlib.import_module(f"apr_tpu.{name}")
    port = importlib.import_module(f"apr_torch.{name}")
    left_out = LEFT_OUT.get(name, ())
    assert set(left_out) <= set(ref.__all__)
    assert list(port.__all__) == [a for a in ref.__all__
                                  if a not in left_out]
    for attr in ref.__all__:
        assert hasattr(port, attr) != (attr in left_out), \
            f"apr_torch.{name}.{attr}"


def test_train_state_is_the_ports_trainer_state():
    from apr_torch.training import FCGFTrainer, TrainState
    from apr_torch.training.train_state import TrainerState

    assert TrainState is TrainerState
    assert issubclass(FCGFTrainer, TrainState)


def _cases():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    pts2 = rng.uniform(-3, 3, size=(400, 3)).astype(np.float32)
    feats = rng.normal(size=(400, 8)).astype(np.float32)
    mask = rng.random(400) > 0.3
    return [("down_sample 0.75", pts, 0.75, 1024, None, None),
            ("grid 1.0", pts2, 1.0, 256, feats, None),
            ("grid 1.0 masked", pts2, 1.0, 256, feats, mask),
            ("grid 0.5 overflow", pts2, 0.5, 64, feats, mask)]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_down_samplers_match_the_jitted_reference(case):
    from apr_torch.ops import grid_subsample, voxel_down_sample

    _, pts, voxel, cap, feats, mask = case
    m_t = None if mask is None else torch.from_numpy(mask)[None]
    m_j = None if mask is None else jnp.asarray(mask)
    bary, vmask = voxel_down_sample(torch.from_numpy(pts)[None], voxel, cap,
                                    m_t)
    want_b, want_m = jax.jit(lambda p, m: ref_vox.voxel_down_sample(
        p, voxel, cap, m))(jnp.asarray(pts), m_j)
    np.testing.assert_array_equal(vmask[0].numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(bary[0].numpy(), np.asarray(want_b))

    f_t = None if feats is None else torch.from_numpy(feats)[None]
    gb, gf, gm = grid_subsample(torch.from_numpy(pts)[None], voxel, cap,
                                f_t, m_t)
    wb, wf, wm = jax.jit(lambda p, f, m: ref_vox.grid_subsample(
        p, voxel, cap, f, m))(jnp.asarray(pts),
                              None if feats is None else jnp.asarray(feats),
                              m_j)
    np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gb[0].numpy(), np.asarray(wb))
    if feats is None:
        assert gf is None and wf is None
    else:
        np.testing.assert_allclose(gf[0].numpy(), np.asarray(wf), rtol=1e-6,
                                   atol=0)
        counts = jax.jit(lambda p, m: ref_vox.voxelize(p, voxel, cap, m)
                         .counts)(jnp.asarray(pts), m_j)
        assert int(gm.sum()) == int((np.asarray(counts) > 0).sum())


def test_the_verify_recipe_runs():
    from apr_torch.data import synthetic_pair
    from apr_torch.ops import chamfer_distance, radius_neighbors, voxelize

    d = synthetic_pair(0, n_points=3000, apc_points=4, distance=5.0,
                       extent=20.0)
    p0 = torch.from_numpy(d["points0"])[None]
    p1 = torch.from_numpy(d["points1"])[None]
    g0, g1 = voxelize(p0, 0.5, 2048), voxelize(p1, 0.5, 2048)
    assert int(g0.mask.sum()) > 100 and int(g1.mask.sum()) > 100
    nb = radius_neighbors(g0.barycenter, g0.barycenter, 1.0, 16, g0.mask,
                          g0.mask)
    assert nb.shape == (1, 2048, 16)
    assert bool((nb[g0.mask][:, 0] < 2048).all())
    c = chamfer_distance(g0.barycenter, g1.barycenter, g0.mask, g1.mask)
    assert c.shape == (1,) and bool(torch.isfinite(c).all())
