"""Batchify functions (the port of
``mxnet_tpu/gluon/data/batchify.py``): ``Stack``, ``Pad`` (with
``round_to``, padding to a bucketed length), ``Group`` (alias
``Tuple``) and ``AsList``. The batch is an array on the current
context (the host, in the DataLoader's workers)."""
from __future__ import annotations

import numpy as onp

__all__ = ["Stack", "Pad", "Group", "AsList"]


def _to_host(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return onp.asarray(x)


class Stack:
    """Stack same-shape samples into a batch array."""

    def __call__(self, data):
        from ...numpy import array
        return array(onp.stack([_to_host(d) for d in data]))


class Pad:
    """Pad samples to the largest extent per axis, then stack. ``val``
    fills, ``dtype`` is the output's (the input's if None), ``round_to``
    rounds every padded extent up to a multiple."""

    def __init__(self, val=0, dtype=None, round_to=None, axis=None):
        self._val = val
        self._dtype = dtype
        self._round_to = round_to

    def __call__(self, data):
        from ...numpy import array
        arrs = [_to_host(d) for d in data]
        ndim = arrs[0].ndim
        if any(a.ndim != ndim for a in arrs):
            raise ValueError("Pad requires samples of equal rank")
        maxes = [max(a.shape[i] for a in arrs) for i in range(ndim)]
        if self._round_to:
            r = self._round_to
            maxes = [((m + r - 1) // r) * r for m in maxes]
        dtype = self._dtype or arrs[0].dtype
        out = onp.full([len(arrs)] + maxes, self._val, dtype=dtype)
        for i, a in enumerate(arrs):
            out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        return array(out)


class Group:
    """One batchify function per element of tuple samples."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        if len(data[0]) != len(self._fns):
            raise ValueError(
                f"sample has {len(data[0])} elements but Group got "
                f"{len(self._fns)} batchify functions")
        return tuple(fn([sample[i] for sample in data])
                     for i, fn in enumerate(self._fns))


Tuple = Group


class AsList:
    """Keep the field as a plain Python list."""

    def __call__(self, data):
        return list(data)
