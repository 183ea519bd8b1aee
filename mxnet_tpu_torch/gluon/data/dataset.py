"""Datasets (the port of ``mxnet_tpu/gluon/data/dataset.py``):
``Dataset`` with ``filter``, ``shard``, ``take``, ``sample``,
``transform`` and ``transform_first``, ``SimpleDataset`` and
``ArrayDataset``. ``RecordFileDataset`` reads RecordIO, which is
ROADMAP.md queue 1, item 17b."""
from __future__ import annotations

from ...base import not_ported

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return _FilteredDataset(self, fn)

    def shard(self, num_shards, index):
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _ShardedDataset(self, start, end)

    def take(self, count):
        if count is None or count > len(self):
            count = len(self)
        return _TakenDataset(self, count)

    def sample(self, sampler):
        return _SampledDataset(self, sampler)

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _FilteredDataset(SimpleDataset):
    def __init__(self, dataset, fn):
        super().__init__([i for i in range(len(dataset)) if fn(dataset[i])])
        self._dataset = dataset

    def __getitem__(self, idx):
        return self._dataset[self._data[idx]]


class _ShardedDataset(Dataset):
    def __init__(self, dataset, start, end):
        self._dataset = dataset
        self._start, self._end = start, end

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        return self._dataset[self._start + idx]


class _TakenDataset(Dataset):
    def __init__(self, dataset, count):
        self._dataset = dataset
        self._count = count

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError
        return self._dataset[idx]


class _SampledDataset(Dataset):
    def __init__(self, dataset, sampler):
        self._dataset = dataset
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class _LazyTransformDataset(Dataset):
    def __init__(self, dataset, fn):
        self._dataset = dataset
        self._fn = fn

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        item = self._dataset[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """The zip of arrays or lists of one length (parity:
    gluon.data.ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; {len(data)} != " \
                f"{self._length} at position {i}"
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """A dataset over a RecordIO file: needs ``recordio``."""

    def __init__(self, filename):
        raise not_ported("gluon.data.RecordFileDataset (recordio)", "17b")
