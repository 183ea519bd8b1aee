"""Activation layers (the port of ``mxnet_tpu/gluon/nn/activations.py``),
over ``ops.nn``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...base import float_input
from ...ops import nn as _nn
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "SiLU", "Swish",
           "Mish"]


class _Act(HybridBlock):
    _tensor_forward = True


class LeakyReLU(_Act):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return f"LeakyReLU({self._alpha})"


class PReLU(_Act):
    """A learned slope per channel (axis 1), ``alpha`` (0.25 by
    default)."""

    def __init__(self, alpha_initializer=None, in_channels=1):
        super().__init__()
        from ...initializer import Constant
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer or Constant(0.25))

    def forward(self, x):
        return _nn.leaky_relu(x, self.alpha._read(), act_type="prelu")


class ELU(_Act):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return _nn.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(_Act):
    def forward(self, x):
        return _nn.leaky_relu(x, act_type="selu")


class GELU(_Act):
    """GELU, exact (``"erf"``) or its tanh approximation."""

    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation != "erf"

    def forward(self, x):
        return F.gelu(float_input(x),
                      approximate="tanh" if self._approx else "none")


class SiLU(_Act):
    def forward(self, x):
        return _nn.activation(x, "silu")


class Swish(_Act):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class Mish(_Act):
    def forward(self, x):
        return _nn.activation(x, "mish")
