"""``mx.save`` / ``mx.load`` (the port of ``mxnet_tpu/utils_io.py``).

The container is ``.npz`` (a zip of ``.npy`` members), the JAX
package's format, so a file written by either package loads in the
other. A dict saves its keys as they are; a list saves under the keys
``__list_N``, in order. A sparse array is stored as
``<key>\\x01sparse\\x01<field>`` members (``stype``, ``shape``,
``data``, ``indices`` and, for csr, ``indptr``). A bfloat16 array is
written as float32 (numpy has no bfloat16), as the JAX package's
writer does. ``load`` also reads the reference's legacy binary NDArray
list (``legacy_serialization``, told apart by its magic) and makes its
arrays on the current context: the card unless the caller asks for the
CPU.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["save", "load"]

_SP = "\x01sparse\x01"  # member-name separator unlikely in user keys


def _host(value):
    """An array's values as numpy (an NDArray, a tensor or array-like;
    bfloat16 as float32)."""
    import torch
    if torch.is_tensor(value):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if hasattr(value, "asnumpy"):
        return value.asnumpy()
    return onp.asarray(value)


def _encode(key, value, payload):
    from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray
    if isinstance(value, BaseSparseNDArray):
        payload[f"{key}{_SP}stype"] = onp.array(value.stype)
        payload[f"{key}{_SP}shape"] = onp.array(value.shape, onp.int64)
        payload[f"{key}{_SP}data"] = value.data.asnumpy()
        payload[f"{key}{_SP}indices"] = value.indices.asnumpy()
        if not isinstance(value, RowSparseNDArray):
            payload[f"{key}{_SP}indptr"] = value.indptr.asnumpy()
    else:
        payload[key] = _host(value)


def _decode_groups(npz):
    from .numpy import array
    from .ndarray import sparse as sp

    done = {}
    grouped = {}
    for k in npz.files:
        if _SP in k:
            base, field = k.split(_SP, 1)
            grouped.setdefault(base, {})[field] = npz[k]
        else:
            done[k] = array(npz[k])
    for base, fields in grouped.items():
        stype = str(fields["stype"])
        shape = tuple(int(s) for s in fields["shape"])
        if stype == "row_sparse":
            done[base] = sp.row_sparse_array(
                (fields["data"], fields["indices"]), shape=shape)
        else:
            done[base] = sp.csr_matrix(
                (fields["data"], fields["indices"], fields["indptr"]),
                shape=shape)
    return done


def save(fname, data):
    """Write an array, a list of arrays or a ``{name: array}`` dict
    (NDArrays, sparse arrays, tensors or numpy arrays) to ``fname``."""
    from .ndarray.ndarray import NDArray
    import torch

    if isinstance(data, NDArray) or torch.is_tensor(data):
        data = [data]
    payload = {}
    if isinstance(data, (list, tuple)):
        for i, d in enumerate(data):
            _encode(f"__list_{i}", d, payload)
    elif isinstance(data, dict):
        for k, v in data.items():
            _encode(k, v, payload)
    else:
        raise TypeError(f"cannot save {type(data)}")
    with open(fname, "wb") as f:
        onp.savez(f, **payload)


def load(fname):
    """Read a file of :func:`save` (or the reference's legacy format):
    a list when it was saved from one, else a dict, of NDArrays on the
    current context."""
    from . import legacy_serialization as _legacy
    with open(fname, "rb") as f:
        head = f.read(8)
    if _legacy.is_legacy_file(head):
        return _legacy.load_legacy(fname)
    with onp.load(fname, allow_pickle=False) as npz:
        done = _decode_groups(npz)
        keys = list(done.keys())
        if keys and all(k.startswith("__list_") for k in keys):
            keys.sort(key=lambda k: int(k[len("__list_"):]))
            return [done[k] for k in keys]
        return done
