"""The port's datasets and input pipeline against apr_tpu's: synthetic pairs
bit for bit, the loader's epoch order and collated arrays exactly (plain
and capacity-bucketed), and the prefetch thread's error and shutdown
behaviour."""

import threading
import time

import numpy as np
import pytest

import apr_tpu.data.pipeline as ref_pipeline
from apr_torch.config import APRConfig
from apr_torch.data import pipeline
from apr_torch.data.datasets import SyntheticPairDataset, make_dataset
from apr_torch.data.synthetic import synthetic_pair
from apr_tpu.config import APRConfig as RefConfig
from apr_tpu.data.datasets import SyntheticPairDataset as RefSynthetic
from test_torch_loop import one_torch_thread  # noqa: F401  (autouse)

KEYS = ("points0", "points1", "apc0", "apc1", "t_gt")


@pytest.mark.parametrize("phase", ["train", "val", "test"])
def test_synthetic_pairs_equal_the_reference(phase):
    kw = dict(num_pairs=3, n_points=800, apc_points=900, min_dist=4.0,
              max_dist=9.0, extent=20.0, seed=7, phase=phase)
    got, want = SyntheticPairDataset(**kw), RefSynthetic(**kw)
    assert len(got) == len(want) == 3
    for i in (0, 2):
        a, b = got.get_pair(i), want.get_pair(i)
        for k in KEYS:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_make_dataset_names(tmp_path):
    """Every dataset name of the reference builds its loader (on trees
    written here, as apr_tpu's make_dataset builds its own); an unknown
    name raises."""
    import importlib.util

    from test_torch_legacy_datasets import FIELDS, write_indoor, \
        write_nuscenes

    from apr_torch.data.kitti import KittiBaselinePairDataset, \
        KittiComplementDataset
    from apr_torch.data.synthetic import write_kitti_tree
    from apr_tpu.data.datasets import make_dataset as ref_make_dataset

    cfg = APRConfig(dataset="synthetic", seed=3, pair_min_dist=2.0,
                    pair_max_dist=3.0)
    ds = make_dataset(cfg, "val")
    assert (len(ds), ds.base_seed, ds.min_dist, ds.max_dist) == (
        16, 10_003, 2.0, 3.0)
    assert len(make_dataset(cfg.replace(dataset="SyntheticPairDataset"),
                            "train")) == 64

    kitti = str(tmp_path / "kitti")
    write_kitti_tree(kitti, {0: 40}, n_points=500, step=2.0, radius=30.0)
    nusc = str(tmp_path / "nuscenes")
    write_nuscenes(nusc, frames=40, n_points=500)
    indoor = write_indoor(str(tmp_path / "indoor"))
    roots = {"PairComplementKittiDataset": (kitti, KittiComplementDataset),
             "KITTIPairDataset": (kitti, KittiBaselinePairDataset),
             "KITTINMPairDataset": (kitti, KittiBaselinePairDataset),
             "KITTIRandDistPairDataset": (kitti, KittiBaselinePairDataset),
             "PairComplementNuscenesDataset": (nusc, None),
             "IndoorDataset": (indoor, None),
             "ThreeDMatchPairDataset": (indoor, None)}
    if importlib.util.find_spec("h5py") is not None:
        import h5py

        with h5py.File(tmp_path / "ply_data_train0.h5", "w") as f:
            f["data"] = np.zeros((2, 64, 3), np.float32)
            f["label"] = np.zeros((2, 1), np.int64)
        roots["ModelNetHdf"] = (str(tmp_path), None)
    for name, (root, cls) in roots.items():
        c = cfg.replace(dataset=name, kitti_root=root, **FIELDS)
        ours = make_dataset(c, "train")
        ref = ref_make_dataset(RefConfig(**{
            k: v for k, v in c.to_dict().items()
            if k in RefConfig.__dataclass_fields__}), "train")
        assert type(ours).__name__ == type(ref).__name__, name
        assert cls is None or isinstance(ours, cls)
        assert len(ours) == len(ref) > 0, name
        if isinstance(ours, KittiBaselinePairDataset):
            assert ours.mode == ref.mode
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset(cfg.replace(dataset="nope"), "train")


class _Varied:
    """Pairs of three sizes, so that the capacity tiers differ."""

    sizes = (150, 700, 2600, 300, 1800, 90, 2400)

    def __len__(self):
        return len(self.sizes)

    def get_pair(self, i):
        return synthetic_pair(seed=i, n_points=self.sizes[i], apc_points=300,
                              distance=3.0, extent=14.0)


FIELDS = dict(batch_size=2, voxel_size=1.0, point_capacity=3072,
              apc_capacity=512, capacities=(1024, 512, 256, 128))


def _as_numpy(raw):
    return [np.asarray(x) for x in raw]


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_and_raw_arrays_equal_the_reference(drop_last):
    ds = _Varied()
    cfg, ref_cfg = APRConfig(**FIELDS), RefConfig(**FIELDS)
    got = pipeline.PairLoader(ds, cfg, seed=4, raw=True, device="cpu",
                              drop_last=drop_last)
    want = ref_pipeline.PairLoader(ds, ref_cfg, seed=4, raw=True,
                                   drop_last=drop_last)
    assert len(got) == len(want) == (3 if drop_last else 4)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        np.testing.assert_array_equal(got._index_order(),
                                      want._index_order())
        batches = list(zip(got, want))
        assert len(batches) == len(got)
        for g, w in batches:
            for a, b in zip(_as_numpy([x.numpy() for x in g]),
                            _as_numpy(w)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _recording(module, out):
    """A stand-in for ``module.collate_pairs`` that records the tier and
    returns the tier's raw arrays instead of building the batch."""
    def collate(pairs, config, point_capacity=None, capacities=None,
                device=None):
        out.append((point_capacity, tuple(capacities)))
        return module.collate_raw(
            pairs, config.replace(point_capacity=point_capacity),
            **({} if device is None else {"device": device}))
    return collate


def test_bucketed_loader_equals_the_reference(monkeypatch):
    ds = _Varied()
    fields = dict(FIELDS, train_capacity_buckets=2)
    tiers_got, tiers_want = [], []
    monkeypatch.setattr(pipeline, "collate_pairs",
                        _recording(pipeline, tiers_got))
    monkeypatch.setattr(ref_pipeline, "collate_pairs",
                        _recording(ref_pipeline, tiers_want))
    got = pipeline.PairLoader(ds, APRConfig(**fields), seed=1,
                              device="cpu", drop_last=False)
    want = ref_pipeline.PairLoader(ds, RefConfig(**fields), seed=1,
                                   drop_last=False)
    assert got.bucket_tiers == want.bucket_tiers == 2
    pairs = list(zip(got, want))
    assert tiers_got == tiers_want and len(set(tiers_got)) > 1
    assert len(pairs) == len(tiers_got) == 4
    for g, w in pairs:
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == pipeline.THREAD_NAME]


def _wait_gone(timeout=5.0):
    end = time.time() + timeout
    while _prefetch_threads() and time.time() < end:
        time.sleep(0.02)
    return not _prefetch_threads()


def test_prefetched_raises_the_producers_error():
    def produce(i):
        if i == 3:
            raise KeyError("broken pair 3")
        return i * 10

    seen = []
    with pytest.raises(KeyError, match="broken pair 3"):
        for x in pipeline.prefetched(range(6), produce, prefetch=2):
            seen.append(x)
    assert seen == [0, 10, 20]
    assert _wait_gone()


def test_prefetched_stops_when_the_consumer_walks_away():
    produced = []

    def produce(i):
        produced.append(i)
        return i

    gen = pipeline.prefetched(range(1000), produce, prefetch=2)
    assert next(gen) == 0
    assert len(_prefetch_threads()) == 1
    gen.close()
    assert _wait_gone()
    assert len(produced) < 10          # it stopped, it did not run on


def test_kernel_launch_counts_are_exact_across_threads():
    """The loader's producer thread and the loop both launch kernels; the
    launch counters the chip checks read must lose no update."""
    import sys

    from apr_torch.ops import distance, searchsorted

    n_threads, n_each = 16, 2000
    counters = [(searchsorted._count_launch, searchsorted.searchsorted_left),
                (distance._count_launch, distance.nn_min)]
    before = [fn.launches for _, fn in counters]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                for count, _ in counters:
                    count()
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    for (_, fn), b in zip(counters, before):
        assert fn.launches - b == n_threads * n_each
        fn.launches = b


def test_loader_builds_batches_on_the_cpu():
    ds = _Varied()
    cfg = APRConfig(**FIELDS)
    batches = list(pipeline.PairLoader(ds, cfg, shuffle=False, device="cpu"))
    assert len(batches) == 3
    assert batches[0].pyramid0.levels[0].mask.shape == (2, 1024)
    assert int(batches[0].pos_mask.sum()) > 0
