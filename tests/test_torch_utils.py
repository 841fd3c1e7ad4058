"""The port's host utilities (apr_torch/utils/{misc,ply,transforms,files,
logging_utils,visualization}.py) and ``models/sparse.py::build_pyramid``
against apr_tpu's on the CPU, from the same seeded numpy inputs.

Tolerances: none but one.  ``hash_pairs``, the PLY files (each side reads
what the other writes), the transforms (the same ``np.random.Generator``
gives the same bits), the file lists, the log and the PCA colours are
equal exactly; ``extract_features`` gives the reference's voxels exactly
and its features within 1e-5 from the same (bridged) weights.
"""

import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apr_tpu.utils import files as ref_files
from apr_tpu.utils import logging_utils as ref_logging
from apr_tpu.utils import misc as ref_misc
from apr_tpu.utils import ply as ref_ply
from apr_tpu.utils import transforms as ref_transforms
from apr_tpu.utils import visualization as ref_vis

from apr_torch.utils import files, logging_utils, misc, ply, transforms, \
    visualization
from test_torch_resunet import random_variables


def test_hash_pairs_matches():
    rng = np.random.default_rng(0)
    for arr in (rng.integers(0, 5000, (300, 2)),
                rng.integers(0, 5000, 300).astype(np.int32),
                rng.integers(0, 50, (40, 3)).astype(np.int32)):
        for seed in (5000, 123457):
            np.testing.assert_array_equal(misc.hash_pairs(arr, seed),
                                          ref_misc.hash_pairs(arr, seed))


FEATURE_FIELDS = dict(trainer="HardestContrastiveLossTrainer",
                      model="ResUNetBN2", model_n_out=16,
                      conv1_kernel_size=3, compute_dtype="float32")
CAPS = (1024, 512, 256, 128)


def test_extract_features_matches():
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.models.sparse import build_pyramid as ref_build_pyramid
    from apr_tpu.ops.voxelize import voxelize as ref_voxelize
    from apr_tpu.training import get_trainer as ref_get_trainer

    from apr_torch.bridge import load_flax_resunet_
    from apr_torch.config import APRConfig
    from apr_torch.training.trainer import FCGFTrainer

    rng = np.random.default_rng(1)
    points = rng.uniform(-12, 12, (3000, 3)).astype(np.float32)
    points[:, 2] *= 0.2
    ref_trainer = ref_get_trainer(RefConfig(**FEATURE_FIELDS))
    grid = ref_voxelize(jnp.asarray(points), 0.5, CAPS[0])
    pyr = jax.vmap(lambda g: ref_build_pyramid(g, CAPS, 3))(
        jax.tree.map(lambda x: x[None], grid))
    feats = jnp.where(pyr.levels[0].mask[..., None], 1.0, 0.0)
    params, stats = random_variables(ref_trainer.encoder, feats, pyr)
    state = types.SimpleNamespace(params={"encoder": params},
                                  batch_stats={"encoder": stats})
    want_xyz, want_f = ref_misc.extract_features(
        ref_trainer, state, points, 0.5, CAPS, 3)

    trainer = FCGFTrainer(APRConfig(**FEATURE_FIELDS), device="cpu")
    load_flax_resunet_(trainer.encoder, params, stats)
    got_xyz, got_f = misc.extract_features(trainer, points, 0.5, CAPS, 3)
    assert 200 < len(got_xyz) <= CAPS[0]
    np.testing.assert_array_equal(got_xyz, want_xyz)
    np.testing.assert_allclose(got_f, np.asarray(want_f), rtol=0, atol=1e-5)


def test_build_pyramid_is_the_level0_build():
    from apr_torch.models.sparse import SparseLevel, build_pyramid, \
        build_pyramid_from_level
    from apr_torch.ops.voxelize import voxelize

    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(-8, 8, (2, 2000, 3)).astype(
        np.float32))
    grid = voxelize(pts, 0.5, CAPS[0])
    got = build_pyramid(grid, CAPS, 3)
    want = build_pyramid_from_level(
        SparseLevel(grid.coords, grid.keys, grid.mask), CAPS, 3)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(g, w)
    with pytest.raises(AssertionError):
        build_pyramid(grid, (512,) + CAPS[1:], 3)


def test_ply_round_trips_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    cols = [xyz, rng.integers(0, 255, (50, 3)).astype(np.uint8),
            rng.normal(size=50), rng.integers(-9, 9, 50).astype(np.int32)]
    names = ["x", "y", "z", "red", "green", "blue", "scalar", "label"]
    for writer, reader in ((ref_ply, ply), (ply, ref_ply)):
        path = str(tmp_path / f"{writer.__name__}.ply")
        writer.write_ply(path, cols, names)
        got = reader.read_ply(path)
        assert list(got) == names
        for i, name in enumerate("xyz"):
            np.testing.assert_array_equal(got[name], xyz[:, i])
        np.testing.assert_array_equal(got["scalar"], cols[2])
        assert got["label"].dtype == np.int32
    assert (tmp_path / "apr_tpu.utils.ply.ply").read_bytes() == \
        (tmp_path / "apr_torch.utils.ply.ply").read_bytes()
    with pytest.raises(ValueError):
        ply.write_ply(str(tmp_path / "bad.ply"), cols, names[:3])


def test_transforms_draw_the_same_bits():
    feats = np.random.default_rng(4).normal(size=(100, 3)).astype(np.float32)
    for make in (lambda m: m.Compose([m.Jitter(), m.ChromaticShift()]),
                 lambda m: m.Jitter(sigma=0.5, p=0.5),
                 lambda m: m.ChromaticShift(p=1.0)):
        port, ref = make(transforms), make(ref_transforms)
        g_port, g_ref = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(6):
            out = port(g_port, feats)
            np.testing.assert_array_equal(out, ref(g_ref, feats))
            assert out.dtype == np.float32
        assert g_port.random() == g_ref.random()


def test_files_logging_and_visualization(tmp_path):
    for name in ("b10", "b9", "a", "c2"):
        (tmp_path / name).mkdir()
        (tmp_path / f"f{name}.txt").write_text("x")
    (tmp_path / "g.npy").write_text("x")
    root = str(tmp_path)
    assert files.get_folder_list(root) == ref_files.get_folder_list(root)
    assert files.get_file_list(root, ".txt") == ref_files.get_file_list(
        root, ".txt")
    names = files.get_folder_list(root)
    assert files.sorted_alphanum(names) == ref_files.sorted_alphanum(names)
    assert [os.path.basename(n) for n in files.sorted_alphanum(names)] == [
        "a", "b9", "b10", "c2"]
    files.ensure_dir(str(tmp_path / "new" / "deep"))
    assert (tmp_path / "new" / "deep").is_dir()

    for module, sub in ((logging_utils, "port"), (ref_logging, "ref")):
        logger = module.Logger(str(tmp_path / sub))
        logger.write("epoch 1\n")
        logger.write("epoch 2\n")
        logger.close()
    assert (tmp_path / "port" / "log").read_bytes() == \
        (tmp_path / "ref" / "log").read_bytes()
    # the root logger as the tests found it, before and after
    root_log = logging.getLogger()
    handlers, level = root_log.handlers[:], root_log.level
    root_log.handlers[:] = []
    try:
        logging_utils.setup_logging(logging.WARNING)
        assert root_log.level == logging.WARNING
        assert len(root_log.handlers) == 1
    finally:
        root_log.handlers[:] = handlers
        root_log.setLevel(level)

    rng = np.random.default_rng(6)
    feats = rng.normal(size=(300, 8)).astype(np.float32)
    for max_points in (1000, 120):
        got = visualization.embed_features_rgb(feats, "pca", max_points, 3)
        want = ref_vis.embed_features_rgb(feats, "pca", max_points, 3)
        np.testing.assert_array_equal(got, want)
    visualization.save_colored_ply(str(tmp_path / "c.ply"), feats[:, :3],
                                   got)
    read = ref_ply.read_ply(str(tmp_path / "c.ply"))
    np.testing.assert_array_equal(
        read["red"], (np.clip(got[:, 0], 0, 1) * 255).astype(np.uint8))
