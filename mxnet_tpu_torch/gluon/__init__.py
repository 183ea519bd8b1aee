"""Gluon of the port: ``Block``/``HybridBlock`` (``nn.Module``s, with
``hybridize``), the whole ``Parameter``, ``Trainer``, every layer of
``gluon.nn``, ``utils``, the losses the training step uses and the GPT
model family. ``rnn``, ``metric``, ``symbol_block``, the other losses
and ``HybridBlock.export`` wait for ROADMAP.md queue 1, item 15b;
``data`` for item 17; ``contrib`` and ``probability`` for item 25."""
from .parameter import (  # noqa: F401
    Parameter, Constant, ParameterDict, DeferredInitializationError,
)
from .block import Block, HybridBlock, CachedOp  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, model_zoo, utils  # noqa: F401
from .utils import split_and_load, split_data, clip_global_norm  # noqa

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "CachedOp", "Trainer", "nn", "loss", "model_zoo", "utils",
           "split_and_load", "split_data", "clip_global_norm"]

_LATER = {"rnn": "15b", "metric": "15b", "SymbolBlock": "15b",
          "symbol_block": "15b", "data": 17, "contrib": 25,
          "probability": 25}


def __getattr__(name):
    if name in _LATER:
        from ..base import not_ported
        raise not_ported(f"gluon.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
