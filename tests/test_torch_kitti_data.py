"""The port's KITTI loaders (apr_torch/data/kitti.py) against apr_tpu's on
KITTI-format trees written here (no dataset ships with the repository).

Tolerance: none.  Pair lists, complement frames and ``meta`` are equal
exactly; clouds, APCs and ``t_gt`` bit for bit (the port's numpy
rotations give scipy's float32 transforms, tests/test_torch_rotation.py).
"""

import os

import numpy as np
import pytest

from apr_torch.data.synthetic import write_kitti_tree

FRAMES = {0: 72, 6: 40, 8: 40}     # train / val / test drives of the splits
FIELDS = dict(pair_min_dist=5.0, pair_max_dist=10.0, complement_pair_dist=4.0,
              num_complement_one_side=2, seed=0)
PHASES = ("train", "val", "test")
N_ITEMS = 3


def _icp_keys(files, with_complement):
    keys = set()
    for entry in files:
        drive, t0, t1 = entry[:3]
        keys.add((drive, t0, t1))
        if with_complement:
            for key, cmpl in ((t0, entry[3]), (t1, entry[4])):
                keys.update((drive, int(c), key) for c in cmpl)
    return keys


def write_icp_cache(root, keys, poses):
    """``{root}/icp/{drive}_{a}_{b}.npy``: frame a -> frame b from the
    LiDAR poses, nudged so that a cache read is told apart from the pose
    chain."""
    os.makedirs(os.path.join(root, "icp"), exist_ok=True)
    for drive, a, b in keys:
        m = np.linalg.inv(poses[drive][b]) @ poses[drive][a]
        m[:3, 3] += 0.01
        np.save(os.path.join(root, "icp", "%d_%d_%d.npy" % (drive, a, b)), m)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A SLAM tree (sequences/NN with a non-identity Tr) with the odometry
    layout (poses/NN.txt) and an ICP cache for every pair and complement
    the odometry-pose walks read; 3000-point frames, 2 m apart."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.kitti import KittiBaselinePairDataset, \
        KittiComplementDataset

    root = str(tmp_path_factory.mktemp("kitti"))
    poses = write_kitti_tree(root, FRAMES, n_points=3000, step=2.0,
                             radius=30.0)
    cfg = RefConfig(kitti_root=root, use_old_pose=True, **FIELDS)
    keys = set()
    for phase in PHASES:
        keys |= _icp_keys(KittiComplementDataset(cfg, phase).files,
                          phase != "test")
    # every other baseline pair gets a cache file; the rest use the
    # unrefined odometry chain
    base = KittiBaselinePairDataset(cfg, "train", "nm").files
    keys |= set(base[::2])
    write_icp_cache(root, keys, poses)
    return root


@pytest.mark.parametrize("seed,sensor", [(0, (0.0, 0.0, 1.8)),
                                         (6, (30.0, -12.0, 1.85))])
def test_synthetic_lidar_frame(seed, sensor):
    """The trees' scans: bit for bit apr_tpu's for the same arguments."""
    from apr_tpu.data.synthetic import synthetic_lidar_frame as ref_frame

    from apr_torch.data.synthetic import synthetic_lidar_frame

    kw = dict(seed=seed, n_points=6000, extent=70.0, sensor_xyz=sensor,
              max_range=80.0)
    ours = synthetic_lidar_frame(**kw)
    assert ours.dtype == np.float32 and ours.shape[1] == 3
    np.testing.assert_array_equal(ours, ref_frame(**kw))


def datasets(root, phase, **over):
    """(apr_tpu's, the port's) KittiComplementDataset for ``phase``."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.kitti import KittiComplementDataset as Ref

    from apr_torch.config import APRConfig
    from apr_torch.data.kitti import KittiComplementDataset

    kw = dict(FIELDS, kitti_root=root, **over)
    return Ref(RefConfig(**kw), phase), KittiComplementDataset(
        APRConfig(**kw), phase)


def assert_items_equal(ref, ours, indices):
    for i in indices:
        a, b = ref.get_pair(i), ours.get_pair(i)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")


def test_pose_helpers(tree):
    import apr_tpu.data.kitti as ref

    import apr_torch.data.kitti as port

    seq = os.path.join(tree, "sequences", "00")
    np.testing.assert_array_equal(port.velo2cam_matrix(),
                                  ref.velo2cam_matrix())
    a = port.parse_calibration(os.path.join(seq, "calib.txt"))
    b = ref.parse_calibration(os.path.join(seq, "calib.txt"))
    assert a.keys() == b.keys()
    np.testing.assert_array_equal(a["Tr"], b["Tr"])
    np.testing.assert_array_equal(port.load_slam_poses(seq),
                                  ref.load_slam_poses(seq))
    np.testing.assert_array_equal(port.load_odometry_poses(tree, 0),
                                  ref.load_odometry_poses(tree, 0))
    assert port.DISCARD_PAIRS == ref.DISCARD_PAIRS


def _trajectory(seed, n=120):
    rng = np.random.default_rng(seed)
    steps = rng.uniform(0.5, 3.0, (n, 1)) * np.stack(
        [np.cos(np.cumsum(rng.normal(0, 0.1, n))),
         np.sin(np.cumsum(rng.normal(0, 0.1, n))), np.zeros(n)], 1)
    return np.cumsum(steps, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_complement_frames(seed):
    import apr_tpu.data.kitti as ref

    import apr_torch.data.kitti as port

    ts = _trajectory(seed)
    for frame in range(0, len(ts), 7):
        for args in ((4.0, 2, 8.0), (10.0, 3, 30.0), (6.0, 5, 30.0)):
            a = port.find_complement_frames(ts, frame, *args)
            b = ref.find_complement_frames(ts, frame, *args)
            assert (a[0], [int(x) for x in a[1]]) == (
                b[0], [int(x) for x in b[1]])


@pytest.mark.parametrize("discard", [False, True])
def test_generate_pairs_and_the_global_stream(discard):
    """The same pair list, and the global np.random stream left in the same
    state (the walk reseeds it with 0 and draws one distance a step)."""
    import apr_tpu.data.kitti as ref

    import apr_torch.data.kitti as port

    ts = _trajectory(3, n=400)
    inames = list(range(400))
    args = (ts, inames, 5.0, 20.0, 4.0, 2, 8.0)
    kw = dict(discard=frozenset({(0, 40, 47), (0, 60, 66)}) if discard
              else None, drive=0)
    for with_complement in (True, False):
        a = port.generate_pairs(*args, with_complement=with_complement, **kw)
        next_a = np.random.rand(4)
        b = ref.generate_pairs(*args, with_complement=with_complement, **kw)
        next_b = np.random.rand(4)
        assert len(a) > 10 and a == b
        np.testing.assert_array_equal(next_a, next_b)


@pytest.mark.parametrize("use_old_pose", [False, True])
@pytest.mark.parametrize("phase", PHASES)
def test_pair_lists(tree, phase, use_old_pose):
    ref, ours = datasets(tree, phase, use_old_pose=use_old_pose)
    assert len(ours) > 0 and ours.files == ref.files
    assert ours.icp_path == ref.icp_path


@pytest.mark.parametrize("use_old_pose", [False, True])
@pytest.mark.parametrize("phase", PHASES)
def test_items(tree, phase, use_old_pose):
    """Each phase on both pose paths: the complement branch's 2*pi-fed-as-
    degrees rotation and crop, the test branch's pi/4 gate, the ICP cache
    reads of the odometry path."""
    ref, ours = datasets(tree, phase, use_old_pose=use_old_pose,
                         random_scale=False)
    assert_items_equal(ref, ours, range(min(N_ITEMS, len(ref))))


@pytest.mark.parametrize("use_old_pose", [False, True])
def test_items_with_scale_and_mutation(tree, use_old_pose):
    """random_scale and mutate_neighbour_percentage draw from the dataset's
    stream in the reference's order (the mutation changes the SLAM path's
    APC and, with the ICP cache, nothing but the draws)."""
    ref, ours = datasets(tree, "train", use_old_pose=use_old_pose,
                         random_scale=True, mutate_neighbour_percentage=0.5)
    assert_items_equal(ref, ours, range(N_ITEMS))


def test_test_phase_downsample_single(tree):
    ref, ours = datasets(tree, "test", downsample_single=0.5,
                         random_rotation=False)
    assert_items_equal(ref, ours, range(N_ITEMS))
    assert len(ours.get_pair(0)["points0"]) == 1500


def test_missing_icp_cache_raises(tree):
    ref, ours = datasets(tree, "train", use_old_pose=True)
    moved = os.path.join(tree, "icp_moved")
    os.rename(os.path.join(tree, "icp"), moved)
    try:
        for ds in (ref, ours):
            with pytest.raises(FileNotFoundError, match="ICP cache"):
                ds.get_pair(0)
    finally:
        os.rename(moved, os.path.join(tree, "icp"))


def test_d3feat_augment():
    import apr_tpu.data.kitti as ref

    import apr_torch.data.kitti as port

    rng = np.random.default_rng(5)
    t = np.eye(4)
    t[:3, 3] = [3.0, -1.0, 0.2]
    pair = dict(points0=rng.normal(size=(500, 3)).astype(np.float32),
                points1=rng.normal(size=(400, 3)).astype(np.float32),
                apc0=rng.normal(size=(900, 3)).astype(np.float32),
                apc1=rng.normal(size=(800, 3)).astype(np.float32),
                t_gt=t.astype(np.float32), meta=np.asarray([0, 1, 2]))
    for seed in range(6):      # both sides of the coin flip
        a = port.d3feat_augment(pair, np.random.RandomState(seed),
                                noise=0.02, shift_range=1.5)
        b = ref.d3feat_augment(pair, np.random.RandomState(seed),
                               noise=0.02, shift_range=1.5)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_d3feat_dataset_items(tree):
    """The Predator flavour that configs/train/kitti.yaml turns on."""
    ref, ours = datasets(tree, "train", d3feat_augmentation=True)
    assert_items_equal(ref, ours, range(N_ITEMS))


@pytest.mark.parametrize("mode", ["time_diff", "nm", "rand_dist"])
def test_baselines(tree, mode):
    """The three baseline walks (rand_dist reseeds the global stream), no
    rotation at any phase, the ICP-cached and the unrefined odometry GT."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.kitti import KittiBaselinePairDataset as Ref

    from apr_torch.config import APRConfig
    from apr_torch.data.kitti import KittiBaselinePairDataset

    kw = dict(FIELDS, kitti_root=tree)
    for phase in ("test", "train"):
        ref = Ref(RefConfig(**kw), phase, mode)
        next_ref = np.random.rand()
        ours = KittiBaselinePairDataset(APRConfig(**kw), phase, mode)
        assert np.random.rand() == next_ref
        assert len(ours) > 0 and ours.files == ref.files
        assert ours.random_rotation is False
        assert_items_equal(ref, ours, range(min(N_ITEMS, len(ref))))
    # the train walk's pairs with an ICP cache file and without
    cached = [i for i, (d, a, b) in enumerate(ours.files) if os.path.exists(
        os.path.join(tree, "icp", "%d_%d_%d.npy" % (d, a, b)))]
    if mode == "nm":
        assert cached and len(cached) < len(ours.files)
    assert_items_equal(ref, ours, cached[:2])


@pytest.mark.parametrize("where", ["root", "packaged"])
def test_lokitti(tree, tmp_path, where):
    """LoKITTI from the root's own file (items compared) or, without one,
    from the packaged copy of the reference's 545 pairs."""
    if where == "root":
        root = tree
        fixed = np.array([[8, 10, 19], [8, 12, 21], [8, 20, 30]])
        np.save(os.path.join(root, "file_LoKITTI_50.npy"), fixed)
    else:
        root = str(tmp_path)
        os.symlink(os.path.join(tree, "sequences"),
                   os.path.join(root, "sequences"))
    try:
        ref, ours = datasets(root, "test", LoKITTI=True)
        assert ours.files == ref.files
        if where == "root":
            assert ours.files == [tuple(int(x) for x in p) for p in fixed]
            assert_items_equal(ref, ours, range(len(fixed)))
        else:
            assert len(ours.files) == 545
    finally:
        if where == "root":
            os.remove(os.path.join(root, "file_LoKITTI_50.npy"))


def test_frames_above_capacity_collate_as_the_reference(tree):
    """Clouds and APCs larger than point_capacity / apc_capacity keep their
    first rows in both collates (the APC of 2 x 2 complement frames of 3000
    points fills 12000 rows of a 5000-row buffer)."""
    from apr_tpu.config import APRConfig as RefConfig
    from apr_tpu.data.pipeline import collate_raw as ref_collate

    from apr_torch.config import APRConfig
    from apr_torch.data.pipeline import collate_raw

    ref, ours = datasets(tree, "train")
    caps = dict(point_capacity=2048, apc_capacity=5000)
    pairs = [ours.get_pair(i) for i in range(2)]
    assert all(len(p["points0"]) > 2048 and len(p["apc0"]) > 5000
               for p in pairs)
    want = ref_collate([ref.get_pair(i) for i in range(2)],
                       RefConfig(**caps))
    got = collate_raw(pairs, APRConfig(**caps), device="cpu")
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
