"""Gluon ``Parameter`` — the subset the GPT path needs.

Counterpart of ``mxnet_tpu/gluon/parameter.py``'s ``Parameter``: a
named, shaped, typed tensor with ``data()`` and ``set_data``. The
tensor itself is a ``torch.nn.Parameter`` registered on the owning
``HybridBlock`` (an ``nn.Module``) under the same attribute name, so
``Module.to(device)`` moves it and ``state_dict`` sees it; ``data()``
always reads the owner's current tensor — or, inside
``bind_shadows``, on the binding thread, the tensor bound in its place
(the GPT model's bf16 or float16 compute copies).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as onp
import torch

__all__ = ["Parameter", "bind_shadows"]


def torch_dtype(dtype) -> torch.dtype:
    """A parameter is float32 (the default), bfloat16 or float16, in the
    numpy, torch or string spelling."""
    if dtype in ("float32", onp.float32, torch.float32):
        return torch.float32
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if dtype in ("float16", onp.float16, torch.float16):
        return torch.float16
    raise TypeError(f"unsupported parameter dtype {dtype!r} (float32, "
                    f"bfloat16 or float16)")


#: this thread's ``{Parameter: tensor}`` binding, or None
_BOUND = threading.local()


@contextlib.contextmanager
def bind_shadows(mapping):
    """Within the block, on this thread only, ``data()`` of every
    parameter in ``mapping`` returns its tensor there instead of the
    parameter's own; ``None`` binds nothing. Other threads keep reading
    the parameters themselves."""
    prev = getattr(_BOUND, "map", None)
    _BOUND.map = mapping
    try:
        yield
    finally:
        _BOUND.map = prev


class Parameter:
    """A named parameter. Allocated (uninitialized) on the current
    default device at construction; ``initialize`` on the model or
    ``set_data`` fills it, and ``data()`` before either raises."""

    def __init__(self, name, shape, dtype="float32"):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self._tensor = torch.nn.Parameter(
            torch.empty(self.shape, dtype=self.dtype), requires_grad=False)
        self._owner = None
        self._key = None
        self._initialized = False

    def _bind(self, owner, key):
        self._owner = owner
        self._key = key

    def _var(self):
        if self._owner is not None:
            return self._owner._parameters[self._key]
        return self._tensor

    def data(self) -> torch.Tensor:
        if not self._initialized:
            raise RuntimeError(
                f"Parameter '{self.name}' has not been initialized: call "
                f"initialize() on the model or set_data() first")
        bound = getattr(_BOUND, "map", None)
        if bound:
            shadow = bound.get(self)
            if shadow is not None:
                return shadow
        return self._var()

    def set_data(self, value):
        """Copy ``value`` (a tensor or array of this parameter's shape)
        into the parameter, on the parameter's device."""
        var = self._var()
        src = torch.as_tensor(value)
        if tuple(src.shape) != self.shape:
            raise ValueError(f"Parameter '{self.name}': shape "
                             f"{tuple(src.shape)} does not match "
                             f"{self.shape}")
        with torch.no_grad():
            var.copy_(src.to(device=var.device, dtype=var.dtype))
        self._initialized = True

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")
