"""Vision datasets (the port of
``mxnet_tpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST,
CIFAR10 and CIFAR100, read from the standard files under a local root
(``$MXNET_HOME/datasets/...`` by default) exactly as the reference
reads them. Nothing is downloaded: a missing file raises the
reference's ``FileNotFoundError``. ``ImageRecordDataset``,
``ImageFolderDataset`` and ``ImageListDataset`` read RecordIO or decode
image files, which is ROADMAP.md queue 1, item 17b."""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as onp

from ....base import not_ported
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "ImageListDataset"]


def _data_root():
    return os.environ.get("MXNET_HOME",
                          os.path.join(os.path.expanduser("~"), ".mxnet"))


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        if not os.path.isdir(self._root):
            os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        from ....numpy import array
        img = array(self._data[idx])
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST (``train-images-idx3-ubyte.gz`` etc. under ``root``)."""

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        root = root or os.path.join(_data_root(), "datasets", "mnist")
        self._base = "train" if train else "t10k"
        super().__init__(root, transform)

    def _get_data(self):
        img_file = os.path.join(self._root,
                                f"{self._base}-images-idx3-ubyte.gz")
        lbl_file = os.path.join(self._root,
                                f"{self._base}-labels-idx1-ubyte.gz")
        for f in (img_file, lbl_file):
            if not os.path.exists(f):
                raise FileNotFoundError(
                    f"{f} not found. This environment has no network "
                    "access; place the standard MNIST idx-ubyte.gz files "
                    f"under {self._root} manually.")
        with gzip.open(lbl_file, "rb") as fin:
            struct.unpack(">II", fin.read(8))
            label = onp.frombuffer(fin.read(), dtype=onp.uint8) \
                .astype(onp.int32)
        with gzip.open(img_file, "rb") as fin:
            _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = onp.frombuffer(fin.read(), dtype=onp.uint8)
            data = data.reshape(num, rows, cols, 1)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=None, train=True, transform=None):
        root = root or os.path.join(_data_root(), "datasets",
                                    "fashion-mnist")
        MNIST.__init__(self, root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the Python pickle batches."""

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        root = root or os.path.join(_data_root(), "datasets", "cifar10")
        super().__init__(root, transform)

    def _batches(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        base = os.path.join(self._root, "cifar-10-batches-py")
        if not os.path.isdir(base):
            tar = os.path.join(self._root, "cifar-10-python.tar.gz")
            if os.path.exists(tar):
                with tarfile.open(tar) as t:
                    t.extractall(self._root)
            else:
                raise FileNotFoundError(
                    f"{base} not found and no network access; place "
                    "cifar-10-python.tar.gz (or its extracted batches) "
                    f"under {self._root}.")
        data, labels = [], []
        for name in self._batches():
            with open(os.path.join(base, name), "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            data.append(batch["data"].reshape(-1, 3, 32, 32))
            labels.extend(batch["labels"])
        self._data = onp.concatenate(data).transpose(0, 2, 3, 1)
        self._label = onp.asarray(labels, dtype=onp.int32)


class CIFAR100(_DownloadedDataset):
    def __init__(self, root=None, fine_label=True, train=True,
                 transform=None):
        self._train = train
        self._fine = fine_label
        root = root or os.path.join(_data_root(), "datasets", "cifar100")
        super().__init__(root, transform)

    def _get_data(self):
        base = os.path.join(self._root, "cifar-100-python")
        if not os.path.isdir(base):
            tar = os.path.join(self._root, "cifar-100-python.tar.gz")
            if os.path.exists(tar):
                with tarfile.open(tar) as t:
                    t.extractall(self._root)
            else:
                raise FileNotFoundError(
                    f"{base} not found and no network access; place "
                    f"cifar-100-python.tar.gz under {self._root}.")
        name = "train" if self._train else "test"
        with open(os.path.join(base, name), "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        self._data = batch["data"].reshape(-1, 3, 32, 32) \
            .transpose(0, 2, 3, 1)
        key = "fine_labels" if self._fine else "coarse_labels"
        self._label = onp.asarray(batch[key], dtype=onp.int32)


class ImageRecordDataset(Dataset):
    """Images and labels in a RecordIO file: needs ``recordio``."""

    def __init__(self, filename, flag=1, transform=None):
        raise not_ported("gluon.data.vision.ImageRecordDataset", "17b")


class ImageFolderDataset(Dataset):
    """A folder of class folders of image files: needs ``image.imread``."""

    def __init__(self, root, flag=1, transform=None):
        raise not_ported("gluon.data.vision.ImageFolderDataset", "17b")


class ImageListDataset(Dataset):
    """Images listed in a ``.lst`` file: needs ``image.imread``."""

    def __init__(self, root=".", imglist=None, flag=1, transform=None):
        raise not_ported("gluon.data.vision.ImageListDataset", "17b")
