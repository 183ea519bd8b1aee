"""Gluon ``Parameter`` — the subset the GPT path needs.

Counterpart of ``mxnet_tpu/gluon/parameter.py``'s ``Parameter``: a
named, shaped, typed tensor with ``data()`` and ``set_data``. The
tensor itself is a ``torch.nn.Parameter`` registered on the owning
``HybridBlock`` (an ``nn.Module``) under the same attribute name, so
``Module.to(device)`` moves it and ``state_dict`` sees it; ``data()``
always reads the owner's current tensor — or, inside
``bind_shadows``, on the binding thread, the tensor bound in its place
(the GPT model's bf16 or float16 compute copies, or the leaves that
``parallel.TrainStep`` differentiates).

The gradient API of the reference: ``grad_req`` (``"write"``, ``"add"``
or ``"null"``), ``grad()``, ``zero_grad()``, ``lr_mult`` and
``wd_mult``. The tensor itself never requires grad, so no serving call
builds an autograd graph and ``data()`` converts to numpy as it is: a
gradient is taken only where a training step binds a differentiable leaf
in the parameter's place, and only for a parameter whose ``grad_req``
is not ``"null"``.
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


def _check_grad_req(req):
    if req not in ("write", "add", "null"):
        raise ValueError(f"grad_req must be 'write', 'add' or 'null', "
                         f"got {req!r}")
    return req


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

    def __init__(self, name, shape, dtype="float32", grad_req="write",
                 lr_mult=1.0, wd_mult=1.0):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = torch_dtype(dtype)
        self._tensor = torch.nn.Parameter(
            torch.empty(self.shape, dtype=self.dtype), requires_grad=False)
        self._owner = None
        self._key = None
        self._initialized = False
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._grad_req = _check_grad_req(grad_req)
        self._grad = None

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        self._grad_req = _check_grad_req(req)
        if req == "null":
            self._grad = None

    def grad(self) -> torch.Tensor:
        """The gradient buffer (zeros until a step writes it): overwritten
        by a ``"write"`` parameter, summed into by an ``"add"`` one. A
        ``"null"`` parameter has none and raises."""
        if not self._initialized:
            raise RuntimeError(
                f"Parameter '{self.name}' has not been initialized")
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter {self.name} "
                f"because grad_req='null'")
        var = self._var()
        if self._grad is None or self._grad.device != var.device \
                or self._grad.dtype != var.dtype:
            self._grad = torch.zeros_like(var)
        return self._grad

    def zero_grad(self):
        if self._grad is not None:
            self._grad.zero_()

    def _write_grad(self, g):
        """Store ``g`` by ``grad_req``: overwrite or accumulate."""
        buf = self.grad()
        if self._grad_req == "add":
            buf.add_(g.to(buf.dtype))
        else:
            buf.copy_(g)

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
