"""``gluon.data.vision``: the datasets and the transforms."""
from .datasets import (  # noqa: F401
    MNIST, FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset,
    ImageListDataset, ImageFolderDataset,
)
from . import transforms  # noqa: F401
