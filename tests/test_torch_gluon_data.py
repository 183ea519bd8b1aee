"""The port's ``gluon.data`` against the JAX package's, on the CPU.

With numpy's global RNG seeded the same, the samplers give the
reference's order and the batchify functions and the ``DataLoader``
(inline, thread workers, the ``last_batch`` modes, ``skip_batches``,
the bucketing pad) give the reference's batches, exactly. The port's
process workers (spawned, two of them, one loader for the module) give
the batches of its thread workers. MNIST, FashionMNIST, CIFAR10 and
CIFAR100 read tiny synthetic files written to ``tmp_path`` as the
reference reads them, and raise its ``FileNotFoundError`` without
them; the image-file datasets wait for item 17b.
"""
import gzip
import os
import pickle
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.base import NotPortedError
from mxnet_tpu_torch.gluon import data as tdata

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

X = onp.arange(23 * 3, dtype="f4").reshape(23, 3)
Y = onp.arange(23, dtype="i4") % 5


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _np(tree):
    if hasattr(tree, "asnumpy"):
        return tree.asnumpy()
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    return tree


def _eq(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
        return
    a, b = onp.asarray(a), onp.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    onp.testing.assert_array_equal(a, b)


def _both(make, seed=4):
    out = []
    for data in (jdata, tdata):
        onp.random.seed(seed)
        out.append(make(data))
    return out


def test_public_names():
    for mod in ("", ".vision"):
        ref = __import__("mxnet_tpu.gluon.data" + mod, fromlist=["x"])
        got = __import__("mxnet_tpu_torch.gluon.data" + mod, fromlist=["x"])
        names = {n for n in dir(ref) if not n.startswith("_")}
        assert names <= set(dir(got)), names - set(dir(got))
    assert set(dir(jdata.batchify)) & {"Stack", "Pad", "Group", "AsList"} \
        <= set(dir(tdata.batchify))


def test_samplers_match_reference():
    def run(d):
        return (list(d.RandomSampler(17)), list(d.SequentialSampler(5, 3)),
                list(d.IntervalSampler(10, 3)),
                list(d.IntervalSampler(10, 3, rollover=False)),
                list(d.FilterSampler(lambda v: v % 3 == 0, list(range(12)))),
                [list(d.BatchSampler(d.RandomSampler(11), 4, m))
                 for m in ("keep", "discard")],
                len(d.BatchSampler(d.SequentialSampler(11), 4, "discard")))
    ref, got = _both(run)
    assert got == ref
    bs = tdata.BatchSampler(tdata.SequentialSampler(10), 4, "rollover")
    assert [list(bs), list(bs)] == [[[0, 1, 2, 3], [4, 5, 6, 7]],
                                    [[8, 9, 0, 1], [2, 3, 4, 5],
                                     [6, 7, 8, 9]]]
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bad"))


def test_datasets_and_batchify_match_reference():
    def run(d):
        ds = d.ArrayDataset(X, Y)
        return ([ds[i] for i in (0, 7)], len(ds.shard(4, 1)),
                ds.shard(4, 3)[0], ds.take(5)[4], len(ds.take(99)),
                list(ds.filter(lambda s: s[1] == 2))[1],
                ds.sample(d.SequentialSampler(3, 4))[0],
                ds.transform(lambda x, y: (x * 2, y + 1))[3],
                ds.transform_first(lambda x: x - 1, lazy=False)[5],
                d.SimpleDataset([4, 5])[1],
                d.batchify.Stack()([X[0], X[1]]),
                d.batchify.Pad(val=-1)([X[0][:1], X[1]]),
                d.batchify.Pad(round_to=4, dtype="float16")([X[0]]),
                d.batchify.Group(d.batchify.Stack(), d.batchify.AsList())(
                    [(X[0], 1), (X[1], 2)]))
    ref, got = _both(run)
    for a, b in zip(got, ref):
        _eq(a, b)
    with pytest.raises(NotPortedError, match="17b"):
        tdata.RecordFileDataset("x.rec")


LOADERS = {
    "inline": dict(batch_size=5, shuffle=True),
    "threads": dict(batch_size=5, shuffle=True, num_workers=2),
    "discard": dict(batch_size=4, last_batch="discard", num_workers=2,
                    prefetch=0),
    "rollover": dict(batch_size=4, last_batch="rollover", shuffle=True),
    "bucketing": dict(batch_size=8, bucketing="pow2"),
}


@pytest.mark.parametrize("kind", list(LOADERS))
def test_dataloader_matches_reference(kind):
    def run(d):
        ld = d.DataLoader(d.ArrayDataset(X, Y), **LOADERS[kind])
        ld.skip_batches(1)
        epochs = [list(ld), list(ld)]
        return len(ld), epochs

    ref, got = _both(run)
    assert got[0] == ref[0]
    for ea, eb in zip(got[1], ref[1]):
        assert len(ea) == len(eb)
        for a, b in zip(ea, eb):
            _eq(a, b)
            if kind == "bucketing":
                assert tmx.bucketing.get_pad(a[0]) == \
                    jmx.bucketing.get_pad(b[0])


@pytest.fixture(scope="module")
def proc_loader():
    ld = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=4,
                          num_workers=2, thread_pool=False)
    yield ld
    ld.close()


def test_process_workers_equal_thread_workers(proc_loader):
    threads = tdata.DataLoader(tdata.ArrayDataset(X, Y), batch_size=4,
                               num_workers=2)
    with tmx.cpu():
        got = list(proc_loader)
        proc_loader.skip_batches(2)
        skipped = list(proc_loader)
        want = list(threads)
    assert len(got) == len(want) == 6 and len(skipped) == 4
    for a, b in zip(got, want):
        _eq(a, b)
    for a, b in zip(skipped, want[2:]):
        _eq(a, b)
    assert str(got[0][0].ctx) == "cpu(0)"


def _write_mnist(root, base, n=7):
    rs = onp.random.RandomState(1)
    img = rs.randint(0, 256, (n, 28, 28)).astype("u1")
    lbl = rs.randint(0, 10, n).astype("u1")
    with gzip.open(os.path.join(root, f"{base}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with gzip.open(os.path.join(root, f"{base}-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbl.tobytes())


def _write_cifar(root, n=6):
    rs = onp.random.RandomState(2)
    base = os.path.join(root, "cifar10", "cifar-10-batches-py")
    os.makedirs(base)
    for i in range(1, 6):
        with open(os.path.join(base, f"data_batch_{i}"), "wb") as f:
            pickle.dump({"data": rs.randint(0, 256, (n, 3072)).astype("u1"),
                         "labels": list(rs.randint(0, 10, n))}, f)
    base = os.path.join(root, "cifar100", "cifar-100-python")
    os.makedirs(base)
    with open(os.path.join(base, "test"), "wb") as f:
        pickle.dump({"data": rs.randint(0, 256, (n, 3072)).astype("u1"),
                     "fine_labels": list(rs.randint(0, 100, n)),
                     "coarse_labels": list(rs.randint(0, 20, n))}, f)


def test_vision_datasets_read_local_files(tmp_path):
    root = str(tmp_path)
    _write_mnist(root, "t10k")
    _write_cifar(root)

    def run(d):
        v = d.vision
        return [v.MNIST(root, train=False), v.FashionMNIST(root, train=False),
                v.CIFAR10(os.path.join(root, "cifar10")),
                v.CIFAR100(os.path.join(root, "cifar100"), train=False),
                v.CIFAR100(os.path.join(root, "cifar100"), train=False,
                           fine_label=False,
                           transform=lambda x, y: (x.astype("float32"), y))]

    ref, got = _both(run)
    for a, b in zip(got, ref):
        assert len(a) == len(b)
        for i in (0, len(b) - 1):
            _eq(list(a[i]), list(b[i]))
    with pytest.raises(FileNotFoundError, match="no network"):
        tdata.vision.CIFAR10(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="not found"):
        tdata.vision.MNIST(str(tmp_path / "none"))
    for cls in ("ImageRecordDataset", "ImageFolderDataset",
                "ImageListDataset"):
        with pytest.raises(NotPortedError, match="17b"):
            getattr(tdata.vision, cls)("x")


def test_pin_memory_on_the_host_is_a_no_op():
    ld = tdata.DataLoader(tdata.ArrayDataset(X), batch_size=6,
                          pin_memory=True)
    batch = next(iter(ld))
    assert isinstance(batch, tmx.NDArray) and not batch._data.is_pinned()
    assert torch.equal(batch._data, torch.from_numpy(X[:6]))


@pytest.mark.parametrize("dtype", ["int64", "float64", "uint8", "float16",
                                   "bool", "int32-strided"])
def test_worker_batch_copy_narrows_like_array(dtype):
    """A process worker's batch leaf becomes a host tensor in one copy:
    the dtype and values ``mx.np.array`` gives, and memory of its own."""
    from mxnet_tpu_torch.gluon.data.dataloader import _host_nd
    arr = (onp.arange(24).reshape(4, 6) % 5).astype(dtype.split("-")[0])
    if dtype.endswith("strided"):
        arr = arr[:, ::2]
    got = _host_nd(arr, False)
    with tmx.cpu():
        want = tmx.np.array(arr, dtype=arr.dtype)
    assert got._data.dtype == want._data.dtype
    assert torch.equal(got._data, want._data)
    arr[...] = 0
    assert torch.equal(got._data, want._data)
