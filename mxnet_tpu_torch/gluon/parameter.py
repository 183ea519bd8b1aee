"""Gluon ``Parameter`` — the subset the GPT path needs.

Counterpart of ``mxnet_tpu/gluon/parameter.py``'s ``Parameter``: a
named, shaped, typed tensor with ``data()`` and ``set_data``. The
tensor itself is a ``torch.nn.Parameter`` registered on the owning
``HybridBlock`` (an ``nn.Module``) under the same attribute name, so
``Module.to(device)`` moves it and ``state_dict`` sees it; ``data()``
always reads the owner's current tensor.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["Parameter"]


def torch_dtype(dtype) -> torch.dtype:
    """The slice is fp32 throughout: "float32" (or its numpy / torch
    spelling) is the one dtype a parameter takes."""
    if dtype in ("float32", onp.float32, torch.float32):
        return torch.float32
    raise TypeError(f"unsupported parameter dtype {dtype!r} (the port "
                    f"is fp32; bf16 is ROADMAP.md queue 1, item 10)")


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
