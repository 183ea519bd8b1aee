"""Gluon of the port: ``Parameter``, ``HybridBlock`` (an
``nn.Module``), the layers GPT uses, the losses the training step uses
and the GPT model family."""
from .parameter import Parameter
from .block import HybridBlock
from . import nn, loss, model_zoo

__all__ = ["Parameter", "HybridBlock", "nn", "loss", "model_zoo"]
