"""Basic Gluon layers the GPT path uses.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``'s ``Dense``,
``LayerNorm``, ``Embedding``, ``Dropout`` and ``HybridSequential``,
with the reference's parameter names (``weight``/``bias``,
``gamma``/``beta``) and layouts (Dense weight ``(units, in_units)``,
Embedding weight ``(input_dim, output_dim)``). The reference infers
``in_units``/``in_channels`` at the first forward; the port takes them
at construction (no deferred initialization).
"""
from __future__ import annotations

from ...ops import nn as _nn
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Dense", "LayerNorm", "Embedding", "Dropout",
           "HybridSequential"]


class Dense(HybridBlock):
    """y = act(x @ W^T + b). ``flatten=False`` applies to the last axis
    only (the GPT case); ``activation="gelu"`` is the exact erf GELU."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", in_units=0):
        super().__init__()
        if int(in_units) < 1:
            raise ValueError("Dense needs in_units: the port has no "
                             "deferred shape inference")
        self._units = int(units)
        self._in_units = int(in_units)
        self._flatten = flatten
        self._act_type = activation
        self.weight = Parameter("weight", (units, in_units), dtype=dtype)
        self.bias = Parameter("bias", (units,), dtype=dtype) \
            if use_bias else None

    def forward(self, x):
        out = _nn.fully_connected(
            x, self.weight.data(),
            self.bias.data() if self.bias is not None else None,
            flatten=self._flatten)
        if self._act_type is not None:
            out = _nn.activation(out, self._act_type)
        return out


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (eps 1e-5, biased variance)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 in_channels=0, dtype="float32"):
        super().__init__()
        if int(in_channels) < 1:
            raise ValueError("LayerNorm needs in_channels: the port has no "
                             "deferred shape inference")
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", (in_channels,), dtype=dtype)
        self.beta = Parameter("beta", (in_channels,), dtype=dtype)

    def forward(self, x):
        return _nn.layer_norm(x, self.gamma.data(), self.beta.data(),
                              axis=self._axis, eps=self._epsilon)


class Embedding(HybridBlock):
    """Token lookup into a ``(input_dim, output_dim)`` table."""

    def __init__(self, input_dim, output_dim, dtype="float32"):
        super().__init__()
        self.weight = Parameter("weight", (input_dim, output_dim),
                                dtype=dtype)

    def forward(self, x):
        return _nn.embedding(x, self.weight.data())


class Dropout(HybridBlock):
    """Dropout; the port serves inference only, so it is the identity
    (training comes with ROADMAP.md queue 1, item 12)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        return x


class HybridSequential(HybridBlock):
    """Children named ``"0"``, ``"1"``, … in the order they are added."""

    def add(self, *blocks):
        for blk in blocks:
            self.add_module(str(len(self._modules)), blk)

    def forward(self, x):
        for blk in self._modules.values():
            x = blk(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)
