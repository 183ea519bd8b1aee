"""``gluon.data`` of the port: datasets, samplers, batchify functions,
the DataLoader (inline, thread and spawned process workers) and
``vision``."""
from .dataset import (  # noqa: F401
    Dataset, SimpleDataset, ArrayDataset, RecordFileDataset,
)
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler, FilterSampler,
    IntervalSampler,
)
from .dataloader import (  # noqa: F401
    DataLoader, default_batchify_fn, default_mp_batchify_fn,
)
from . import batchify  # noqa: F401
from . import vision  # noqa: F401
