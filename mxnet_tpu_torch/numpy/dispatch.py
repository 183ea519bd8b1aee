"""NumPy interoperability protocols for NDArray (the port of
``mxnet_tpu/numpy/dispatch.py``).

- ``__array_function__``: ``numpy.foo(mx_arr)`` runs the port's
  ``mx.np.foo`` on the array's device when the port defines it;
- ``__array_ufunc__``: ``numpy.sqrt(mx_arr)``, ``onp_arr < mx_arr``
  likewise through the ufunc's namesake;
- otherwise, and for a ufunc's ``reduce``/``accumulate``/``outer``/
  ``at``, the NumPy function runs on the HOST on copies of the arrays
  and the result is lifted back to NDArray; every such call counts in
  ``mx.np.FALLBACK_CALLS``.

Resolution is by module path: numpy -> mx.np, numpy.linalg ->
mx.np.linalg, numpy.fft -> mx.np.fft, numpy.random -> mx.np.random.
"""
from __future__ import annotations

import importlib

import numpy as onp

_MODULE_MAP = {
    "numpy": "mxnet_tpu_torch.numpy",
    "numpy.linalg": "mxnet_tpu_torch.numpy.linalg",
    "numpy.fft": "mxnet_tpu_torch.numpy.fft",
    "numpy.random": "mxnet_tpu_torch.numpy.random",
}

# numpy functions whose mx.np namesakes differ in signature or meaning
# enough that the host is safer
_NEVER_DISPATCH = frozenset({"array", "asarray", "asanyarray", "copyto",
                             "save", "savez", "load", "frombuffer"})


def _resolve_native(func):
    """The port's implementation of a numpy function, or None."""
    mod = getattr(func, "__module__", None) or "numpy"
    name = getattr(func, "__name__", None)
    if name is None or name in _NEVER_DISPATCH:
        return None
    target = _MODULE_MAP.get(mod)
    if target is None and mod.startswith("numpy"):
        target = _MODULE_MAP["numpy"]     # numpy._core.* wrappers
    if target is None:
        return None
    m = importlib.import_module(target)
    native = m.__dict__.get(name)         # not the module's fallback
    return native if callable(native) else None


def _to_host(x):
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _from_host(x):
    from . import array
    if isinstance(x, onp.ndarray):
        return array(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_from_host(v) for v in x)
    return x


def _fallback_call(func, args, kwargs):
    """Run a numpy function on host copies; lift the results."""
    from . import FALLBACK_CALLS
    FALLBACK_CALLS[getattr(func, "__name__", repr(func))] += 1
    return _from_host(func(*_to_host(args), **_to_host(kwargs or {})))


def array_function(self, func, types, args, kwargs):
    native = _resolve_native(func)
    if native is not None:
        try:
            return native(*args, **(kwargs or {}))
        except TypeError:
            pass    # a numpy-only argument: the host
    return _fallback_call(func, args, kwargs)


def array_ufunc(self, ufunc, method, *inputs, **kwargs):
    if method != "__call__":
        return _fallback_call(getattr(ufunc, method), inputs, kwargs)
    out = kwargs.pop("out", None)
    if isinstance(out, tuple):
        out = out[0] if len(out) == 1 else out
    native = _resolve_native(ufunc)
    if native is not None:
        try:
            if out is not None:
                return native(*inputs, out=out, **kwargs)
            return native(*inputs, **kwargs)
        except TypeError:
            pass
    res = _fallback_call(ufunc, inputs, kwargs)
    if out is not None:
        from ..ndarray.ndarray import NDArray
        if isinstance(out, NDArray):
            out._inplace(res if isinstance(res, NDArray)
                         else _from_host(onp.asarray(res)))
            return out
    return res
