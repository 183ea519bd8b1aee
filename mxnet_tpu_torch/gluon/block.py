"""``HybridBlock`` as an ``nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py``'s block tree. Assigning a
:class:`~.parameter.Parameter` to a block attribute registers it (its
tensor becomes the module's ``nn.Parameter`` of the same name);
assigning a block registers a child, as ``nn.Module`` does.
``collect_params()`` returns the reference's dotted MXNet names in the
reference's order — a block's own parameters first, then each child's
in registration order — so a checkpoint of the JAX model loads by name.

There is no hybridization: PyTorch runs eagerly.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .parameter import Parameter

__all__ = ["HybridBlock"]


class HybridBlock(torch.nn.Module):

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_reg_params", OrderedDict())

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            if name in self._parameters or name in self.__dict__:
                raise AttributeError(f"parameter {name!r} already set")
            self.register_parameter(name, value._tensor)
            value._bind(self, name)
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def collect_params(self) -> "OrderedDict[str, Parameter]":
        """All Parameters of this block and its children, keyed by
        dotted attribute path."""
        out = OrderedDict()

        def walk(block, prefix):
            for name, p in block._reg_params.items():
                out[f"{prefix}{name}"] = p
            for cname, child in block._modules.items():
                if isinstance(child, HybridBlock):
                    walk(child, f"{prefix}{cname}.")

        walk(self, "")
        return out
