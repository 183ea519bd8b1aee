"""Attribute scoping for symbol construction.

Counterpart of ``mxnet_tpu/attribute.py`` (``AttrScope``). Symbols
created inside a ``with AttrScope(...)`` block inherit the scope's
attributes; nested scopes merge with inner values winning, as in the
reference. (Symbols themselves wait for ROADMAP.md queue 1, item 26.)
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [AttrScope()]
    return _tls.stack


class AttrScope:
    """Holds a dict of string attributes applied to symbols created
    within the scope."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError(
                    "attributes need to be strings; got "
                    f"{type(v).__name__}")
        self._attr = dict(kwargs)

    def get(self, attr=None):
        """Merge scope attributes into ``attr`` (user values win)."""
        if not self._attr:
            return attr if attr else {}
        merged = dict(self._attr)
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        parent = _stack()[-1]
        merged = dict(parent._attr)
        merged.update(self._attr)
        self._attr = merged
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        st = _stack()
        if len(st) > 1 and st[-1] is self:
            st.pop()


def current():
    """The innermost active AttrScope."""
    return _stack()[-1]
