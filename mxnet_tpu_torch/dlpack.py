"""DLPack interchange (the port of ``mxnet_tpu/dlpack.py``):
``to_dlpack_for_read``/``to_dlpack_for_write`` and ``from_dlpack``, over
``torch.utils.dlpack``.

The reference's capsule carries no device and its import assumes host
memory. The port's capsule names the array's device (the card or the
CPU), and ``from_dlpack`` keeps that device and copies nothing: the
imported array's tensor shares the exporter's memory (the same
``data_ptr()``). A write through the consumer's view of a
``to_dlpack_for_write`` capsule is seen in the exported array's
current tensor; the port's own writes to an NDArray install a new
tensor, as everywhere in the port, and do not reach an earlier capsule.
"""
from __future__ import annotations

import torch
from torch.utils import dlpack as _tdl

from .ndarray.ndarray import NDArray

__all__ = ["to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack"]


def _tensor(data):
    if isinstance(data, NDArray):
        data.wait_to_read()
        return data._data.detach()
    if torch.is_tensor(data):
        return data.detach()
    raise TypeError(f"expected an NDArray or a tensor, got {type(data)}")


def to_dlpack_for_read(data):
    """A DLPack capsule of ``data``'s memory on its device."""
    return _tdl.to_dlpack(_tensor(data))


def to_dlpack_for_write(data):
    """A DLPack capsule of ``data``'s memory, for a consumer that writes
    into it (the same capsule as ``to_dlpack_for_read``)."""
    return _tdl.to_dlpack(_tensor(data))


def from_dlpack(dlpack):
    """An NDArray over a DLPack capsule (or any object speaking
    ``__dlpack__``), on the device it names, without a copy."""
    return NDArray(_tdl.from_dlpack(dlpack))
