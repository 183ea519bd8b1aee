"""Gluon of the port: ``Block``/``HybridBlock`` (``nn.Module``s, with
``hybridize``, and save/load of their parameters), the whole
``Parameter``, ``Trainer`` (with ``save_states``/``load_states`` and
AMP's loss scaling), every layer of ``gluon.nn``, ``gluon.rnn``, every
loss, ``metric``, ``utils``, ``data`` (with ``data.vision``) and the GPT
model family. ``SymbolBlock`` and ``HybridBlock.export``
wait for ROADMAP.md queue 1, item 15c (after ``mx.sym``, item 26);
``contrib`` and ``probability`` for item 25."""
from .parameter import (  # noqa: F401
    Parameter, Constant, ParameterDict, DeferredInitializationError,
)
from .block import Block, HybridBlock, CachedOp  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn, loss, model_zoo, utils, rnn, metric, data  # noqa: F401
from .utils import split_and_load, split_data, clip_global_norm  # noqa

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "CachedOp", "Trainer", "nn", "loss", "model_zoo", "utils", "rnn",
           "metric", "data",
           "split_and_load", "split_data", "clip_global_norm"]

_LATER = {"SymbolBlock": "15c", "symbol_block": "15c",
          "contrib": 25, "probability": 25}


def __getattr__(name):
    if name in _LATER:
        from ..base import not_ported
        raise not_ported(f"gluon.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
