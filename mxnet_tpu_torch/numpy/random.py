"""mx.np.random — the imperative samplers this slice ports (``seed``,
``uniform``, ``normal``, ``randint``), drawing
from the port's per-device generators (``random_state.py``). The
formulas are the reference's: ``low + u * (high - low)`` with ``u`` in
[0, 1), ``loc + scale * z``; ``randint``'s ``high`` is exclusive and its
int64 default narrows to int32 with a bounds check.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import engine
from ..base import default_float, not_ported, resolve_dtype
from ..context import current_context
from ..random_state import generator, seed as _seed

__all__ = ["seed", "uniform", "normal", "randint"]


def seed(seed_value):
    _seed(int(seed_value))


def _val(x, dev):
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data.detach().to(dev)
    return torch.as_tensor(x, device=dev)


def _size(size, *params):
    if size is None:
        return tuple(torch.broadcast_shapes(*(p.shape for p in params)))
    return (int(size),) if isinstance(size, (int, onp.integer)) \
        else tuple(int(s) for s in size)


def _finish(t, ctx, out):
    from ..ndarray.ndarray import NDArray
    r = NDArray(engine.track(t), ctx=ctx)
    return r if out is None else out._inplace(r)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, out=None,
            device=None):
    ctx = ctx or device or current_context()
    dev = ctx.torch_device
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    lo, hi = _val(low, dev), _val(high, dev)
    u = torch.rand(_size(size, lo, hi), generator=generator(dev),
                   dtype=dt, device=dev)
    return _finish((u * (hi - lo) + lo).to(dt), ctx, out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, out=None,
           device=None):
    ctx = ctx or device or current_context()
    dev = ctx.torch_device
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    mu, sd = _val(loc, dev), _val(scale, dev)
    z = torch.randn(_size(size, mu, sd), generator=generator(dev),
                    dtype=dt, device=dev)
    return _finish((mu + sd * z).to(dt), ctx, out)


def randint(low, high=None, size=None, dtype=None, ctx=None, out=None):
    if high is None:
        low, high = 0, low
    # high is EXCLUSIVE: bounds-check the largest value it can give
    dt = resolve_dtype(dtype if dtype is not None else onp.int64,
                       values=(low, high - 1))
    lo, hi = int(low), int(high)
    info = torch.iinfo(dt)
    if hi > info.max + 1 or lo < info.min:
        raise OverflowError(f"randint bounds [{lo}, {hi}) exceed the "
                            f"{dt} range")
    ctx = ctx or current_context()
    dev = ctx.torch_device
    shape = () if size is None else _size(size)
    t = torch.randint(lo, hi, shape, generator=generator(dev), dtype=dt,
                      device=dev)
    return _finish(t, ctx, out)


def __getattr__(name):
    if name.startswith("_") or not callable(
            getattr(onp.random, name, None)):
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy.random' has no attribute "
            f"{name!r}")
    raise not_ported(f"mx.np.random.{name}", 13)
