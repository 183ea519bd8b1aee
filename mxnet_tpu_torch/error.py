"""Structured error types (the port of ``mxnet_tpu/error.py``).

A typed hierarchy over ``MXNetError`` with a ``register_error`` hook,
so an error kind named in a message (``"ValueError: ..."``) can be
raised as the right Python type. ``IndexError``, ``ValueError``,
``TypeError`` and ``AttributeError`` derive from both ``MXNetError``
and the builtin of their name, so ``except ValueError:`` in user code
catches them.
"""
from __future__ import annotations

import builtins as _b

from .base import MXNetError

__all__ = ["MXNetError", "InternalError", "IndexError", "ValueError",
           "TypeError", "AttributeError", "NotImplementedForSymbol",
           "register_error", "get_error_type"]

_ERROR_TYPES = {}


def register_error(func_name=None, cls=None):
    """Register an error class under its name. Usable as a bare
    decorator, a named decorator, or a direct call."""
    if callable(func_name):  # bare decorator form
        cls, func_name = func_name, None

    def do_register(klass):
        name = func_name if func_name is not None else klass.__name__
        _ERROR_TYPES[name] = klass
        return klass

    return do_register(cls) if cls is not None else do_register


def get_error_type(name):
    """The registered error class of ``name`` (None if unknown)."""
    return _ERROR_TYPES.get(name)


@register_error
class InternalError(MXNetError):
    """Framework-internal invariant violation."""


IndexError = register_error("IndexError")(
    type("IndexError", (MXNetError, _b.IndexError), {}))
ValueError = register_error("ValueError")(
    type("ValueError", (MXNetError, _b.ValueError), {}))
TypeError = register_error("TypeError")(
    type("TypeError", (MXNetError, _b.TypeError), {}))
AttributeError = register_error("AttributeError")(
    type("AttributeError", (MXNetError, _b.AttributeError), {}))


@register_error
class NotImplementedForSymbol(MXNetError):
    """Raised when an NDArray-only operation is called on a Symbol."""

    def __init__(self, function, alias=None, *args):
        super().__init__()
        self.function = function.__name__ if callable(function) else function
        self.alias = alias
        self.args_val = [str(a) for a in args]

    def __str__(self):
        msg = f"Function {self.function}"
        if self.alias:
            msg += f" (alias {self.alias})"
        if self.args_val:
            msg += " with arguments (" + ", ".join(self.args_val) + ")"
        msg += " is not supported for Symbol and only available in NDArray."
        return msg
