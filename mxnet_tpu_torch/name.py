"""Automatic naming of symbols/blocks.

Counterpart of ``mxnet_tpu/name.py`` (``NameManager``, ``Prefix``):
a thread-local scope stack, so nested ``with`` blocks compose, as the
reference's context-manager ``NameManager`` does.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [NameManager()]
    return _tls.stack


class NameManager:
    """Assigns unique ``<hint>N`` names to anonymously-created symbols."""

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """Return ``name`` if given, else the next auto name for ``hint``."""
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = f"{hint}{self._counter[hint]}"
        self._counter[hint] += 1
        return name

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        st = _stack()
        if len(st) > 1 and st[-1] is self:
            st.pop()


class Prefix(NameManager):
    """NameManager that prepends a fixed prefix to every auto name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def current():
    """The innermost active NameManager."""
    return _stack()[-1]
