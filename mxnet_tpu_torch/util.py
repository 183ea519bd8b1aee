"""``mx.util`` (the port of ``mxnet_tpu/util.py``).

NumPy shape and array semantics are always on in both packages, so the
``np_shape``/``np_array`` scopes and the ``use_np*`` decorators pass
through, as the reference's do; ``use_np_default_dtype`` and
``np_default_dtype`` switch the float64 default (``base.set_np(dtype=)``)
for their extent. The device queries read the card through torch:
``get_gpu_count`` is ``torch.cuda.device_count()``, ``get_gpu_memory``
``torch.cuda.mem_get_info`` and ``get_cuda_compute_capability``
``torch.cuda.get_device_capability`` (90 on the H100).
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import os

import torch

from .base import is_np_default_dtype, reset_np, set_np  # noqa: F401
from .base import _np_default_dtype

__all__ = ["np_shape", "np_array", "use_np_shape", "use_np_array", "use_np",
           "use_np_default_dtype", "is_np_shape", "is_np_array",
           "is_np_default_dtype", "reset_np", "set_np", "get_gpu_count",
           "get_gpu_memory", "getenv", "setenv", "default_array",
           "set_np_shape", "np_default_dtype", "set_np_default_dtype",
           "set_module", "wrap_np_unary_func", "wrap_np_binary_func",
           "np_ufunc_legal_option", "numpy_fallback",
           "get_cuda_compute_capability"]


def _set_default_dtype(active):
    _np_default_dtype[0] = bool(active)


class _NoopScope:
    """A scope and a decorator that change nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            return func(*args, **kwargs)
        return wrapper


def np_array(active=True):  # noqa: ARG001 - always-on semantics
    return _NoopScope()


def np_shape(active=True):  # noqa: ARG001 - always-on semantics
    return contextlib.nullcontext(True)


def use_np_shape(func):
    return func


def use_np_array(func):
    return func


def use_np(func):
    return func


def use_np_default_dtype(func):
    """Run ``func`` with the float64 default on, restoring the mode on
    exit. Decorating a class wraps each of its own public methods (and
    ``__init__``) in place; a non-callable raises TypeError."""
    if inspect.isclass(func):
        for name, attr in list(vars(func).items()):
            if name.startswith("__") and name != "__init__":
                continue
            if isinstance(attr, staticmethod):
                setattr(func, name, staticmethod(
                    use_np_default_dtype(attr.__func__)))
            elif isinstance(attr, classmethod):
                setattr(func, name, classmethod(
                    use_np_default_dtype(attr.__func__)))
            elif inspect.isfunction(attr):
                setattr(func, name, use_np_default_dtype(attr))
        return func
    if not callable(func):
        raise TypeError("use_np_default_dtype can only decorate classes "
                        f"and callable objects, got {type(func)}")

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        prev = is_np_default_dtype()
        _set_default_dtype(True)
        try:
            return func(*args, **kwargs)
        finally:
            _set_default_dtype(prev)
    return wrapper


def is_np_shape():
    return True


def is_np_array():
    return True


def set_np_shape(active=True):  # noqa: ARG001 - always-on semantics
    """NumPy shape semantics are always on."""
    return True


def np_default_dtype(active=True):
    """A scope with the float64 default on (or off) for its extent."""
    @contextlib.contextmanager
    def scope():
        prev = is_np_default_dtype()
        _set_default_dtype(active)
        try:
            yield bool(active)
        finally:
            _set_default_dtype(prev)
    return scope()


def set_np_default_dtype(is_np_default_dtype=True):  # noqa: A002
    _set_default_dtype(is_np_default_dtype)


def get_gpu_count():
    """The number of CUDA cards visible."""
    return torch.cuda.device_count()


def get_gpu_memory(gpu_dev_id=0):
    """``(free, total)`` bytes of card ``gpu_dev_id``
    (``torch.cuda.mem_get_info``)."""
    from .context import gpu_memory_info
    return gpu_memory_info(int(gpu_dev_id))


def get_cuda_compute_capability(ctx):
    """The compute capability of a gpu context's card as one number,
    ``10 * major + minor`` (90 on the H100)."""
    if getattr(ctx, "device_type", None) != "gpu":
        raise ValueError(f"Expecting a gpu context to get cuda compute "
                         f"capability, while received ctx {ctx}")
    major, minor = torch.cuda.get_device_capability(ctx.device_id)
    return major * 10 + minor


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value


def default_array(source_array, ctx=None, dtype=None):
    from .numpy import array
    return array(source_array, ctx=ctx, dtype=dtype)


def set_module(module):
    """Decorator overriding ``__module__`` for documentation."""
    def decorator(func):
        if module is not None:
            func.__module__ = module
        return func
    return decorator


def wrap_np_unary_func(func):
    """The port's ops take ``out=``/``where=`` themselves."""
    return func


def wrap_np_binary_func(func):
    return func


def np_ufunc_legal_option(key, value):
    if key == "out":
        return value is None
    if key == "where":
        return value is True
    if key == "casting":
        return value == "same_kind"
    if key == "order":
        return value in ("K", "C")
    if key == "dtype":
        return value is None
    if key == "subok":
        return value is True
    return False


def numpy_fallback(func):
    """Names the port lacks fall back through ``mx.np.__getattr__`` and
    the NumPy dispatch protocol already."""
    return func
