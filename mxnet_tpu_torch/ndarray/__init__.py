"""mx.nd — the NDArray type and ``waitall`` (``nd.save``/``nd.load``
come with ROADMAP.md queue-1 item 18)."""
from __future__ import annotations

from ..base import not_ported
from .ndarray import NDArray, waitall

__all__ = ["NDArray", "waitall", "save", "load"]


def save(fname, data):
    raise not_ported("nd.save", 18)


def load(fname):
    raise not_ported("nd.load", 18)
