"""The port's data pipeline against the reference's, byte for byte.

`data/` in the port is a copy of the reference's, with the sampler's
defaults read from the port's `distributed`. For every (seed, epoch, rank,
world) of a grid the port's `DistributedSampler` yields the reference's
index stream, and its `DataLoader` the reference's batches — the same
bytes, dtypes and shapes — with and without `drop_last`, and with two
workers in both worker modes (threads; processes seeded per (epoch,
worker)). `SyntheticMNIST`, the IDX reader and the dataset combinators give
the same arrays. No tolerance anywhere: every comparison is exact.
"""

import gzip
import struct

import numpy as np
import pytest

from pytorch_distributed_example_tpu import data as jdata
from pytorch_distributed_example_tpu_torch import data as tdata
import pytorch_distributed_example_tpu_torch as tdx
from tests._data_cases import RngDataset

GRID = [
    # (n, world, seed, shuffle, drop_last)
    (100, 1, 0, True, False),
    (100, 3, 0, True, False),
    (101, 4, 7, True, True),
    (4096, 8, 0, True, False),
    (37, 8, 3, False, False),
    (5, 8, 1, True, False),  # fewer samples than ranks: padded by repetition
    (37, 8, 3, True, True),
]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,world,seed,shuffle,drop_last", GRID)
@pytest.mark.parametrize("epoch", [0, 1, 5])
def test_sampler_streams_match_reference(n, world, seed, shuffle, drop_last, epoch):
    ds = list(range(n))
    for rank in range(world):
        kw = dict(num_replicas=world, rank=rank, shuffle=shuffle, seed=seed, drop_last=drop_last)
        port, ref = tdata.DistributedSampler(ds, **kw), jdata.DistributedSampler(ds, **kw)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(port) == list(ref), (rank, world)
        assert len(port) == len(ref) and port.total_size == ref.total_size


def test_sampler_defaults_read_the_ports_group():
    with pytest.raises(RuntimeError, match="initialized"):
        tdata.DistributedSampler(list(range(10)))
    tdx.init_process_group(world_size=4, device="cpu")
    try:
        s = tdata.DistributedSampler(list(range(10)))
        assert (s.num_replicas, s.rank) == (4, 0)
    finally:
        tdx.destroy_process_group()
    with pytest.raises(ValueError, match="Invalid rank"):
        tdata.DistributedSampler(list(range(10)), num_replicas=2, rank=2)


def test_synthetic_mnist_matches_reference():
    for n, seed in ((4096, 0), (512, 1)):
        port, ref = tdata.SyntheticMNIST(n, seed=seed), jdata.SyntheticMNIST(n, seed=seed)
        for a, b in ((port.images, ref.images), (port.labels, ref.labels)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert port.images.shape == (512, 28, 28, 1)  # NHWC, as the reference's


def _write_idx(path, arr):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(header + arr.tobytes())


def test_idx_reader_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (20, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 20, dtype=np.uint8)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    _write_idx(raw / "train-images-idx3-ubyte.gz", imgs)
    _write_idx(raw / "train-labels-idx1-ubyte", labels)
    port, ref = tdata.load_mnist(str(tmp_path)), jdata.load_mnist(str(tmp_path))
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert len(port) == 20
    # no test files there: both fall back to the synthetic test set
    np.testing.assert_array_equal(tdata.load_mnist(str(tmp_path), train=False).labels,
                                  jdata.load_mnist(str(tmp_path), train=False).labels)


@pytest.mark.parametrize("world,drop_last", [(2, False), (3, True), (8, False)])
def test_loader_batches_match_reference(world, drop_last):
    port_ds, ref_ds = tdata.SyntheticMNIST(300, seed=2), jdata.SyntheticMNIST(300, seed=2)
    for rank in range(world):
        got, want = [], []
        for mod, ds, out in ((tdata, port_ds, got), (jdata, ref_ds, want)):
            s = mod.DistributedSampler(ds, num_replicas=world, rank=rank)
            s.set_epoch(3)
            out.extend(mod.DataLoader(ds, 16, sampler=s, drop_last=drop_last))
        _same_batches(got, want)


def test_loader_shuffle_without_sampler_matches_reference():
    port = tdata.DataLoader(tdata.TensorDataset(np.arange(50)), 8, shuffle=True, seed=4)
    ref = jdata.DataLoader(jdata.TensorDataset(np.arange(50)), 8, shuffle=True, seed=4)
    for _ in range(2):  # each pass reshuffles
        _same_batches(list(port), list(ref))
    assert len(port) == len(ref) == 7


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_workers_match_reference(worker_mode):
    """Two workers in each mode: the sampler's order, and in process mode
    the per-(epoch, worker) seeded draws, are the reference's."""
    loaders = []
    try:
        for epoch in (0, 1):
            batches = []
            for mod in (tdata, jdata):
                ds = RngDataset()
                s = mod.DistributedSampler(ds, num_replicas=2, rank=1, seed=5)
                s.set_epoch(epoch)
                ld = mod.DataLoader(ds, 8, sampler=s, num_workers=2, worker_mode=worker_mode,
                                    seed=11)
                loaders.append(ld)
                batches.append(list(ld))
            if worker_mode == "process":
                _same_batches(*batches)
            else:  # threads share numpy's global RNG: compare the indices only
                _same_batches([b[1:] for b in batches[0]], [b[1:] for b in batches[1]])
    finally:
        for ld in loaders:
            ld.shutdown()


def test_dataset_combinators_match_reference():
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    b = np.arange(10, dtype=np.int32)
    idx = np.array([9, 0, 4, 4])
    pt, rt = tdata.TensorDataset(a, b), jdata.TensorDataset(a, b)
    _same_batches([pt[idx]], [rt[idx]])
    pc = tdata.ConcatDataset([pt, tdata.TensorDataset(a[:4] + 100, b[:4])])
    rc = jdata.ConcatDataset([rt, jdata.TensorDataset(a[:4] + 100, b[:4])])
    sel = np.array([13, 2, -1, 10])
    _same_batches([pc[sel]], [rc[sel]])
    for p, r in zip(tdata.random_split(pc, [5, 9], seed=3), jdata.random_split(rc, [5, 9], seed=3)):
        np.testing.assert_array_equal(p.indices, r.indices)
        _same_batches([p[np.arange(len(p))]], [r[np.arange(len(r))]])
    assert tdata.get_worker_info() is None
