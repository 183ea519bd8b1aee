"""Gluon of the port: ``Parameter``, ``HybridBlock`` (an
``nn.Module``), the layers GPT uses and the GPT model family."""
from .parameter import Parameter
from .block import HybridBlock
from . import nn, model_zoo

__all__ = ["Parameter", "HybridBlock", "nn", "model_zoo"]
