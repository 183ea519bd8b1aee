"""Serving errors and engine bookkeeping shared by the port's engines.

The part of ``mxnet_tpu/serving/engine.py`` that ``generate.py``
imports: the rejection types, the live-engine registry closed at
interpreter exit, and the ``MXTPU_SERVING`` switch (``0`` degrades the
engines to synchronous inline execution). The micro-batching
``InferenceEngine`` itself is ROADMAP.md queue 1, item 21.
"""
from __future__ import annotations

import atexit
import os
import weakref

__all__ = ["ServingError", "EngineClosedError", "QueueFullError",
           "RequestTimeoutError", "ReplicaFailedError"]


class ServingError(RuntimeError):
    """Base class for serving-layer rejections."""


class EngineClosedError(ServingError):
    """The engine was closed before (or while) the request was queued."""


class ReplicaFailedError(EngineClosedError):
    """The engine's worker thread DIED from an unexpected error — the
    replica is broken, which is categorically different from a
    deliberate ``close()``: a router (or caller) may safely retry the
    request on another replica. ``cause`` carries the original
    exception."""

    def __init__(self, msg, cause=None):
        super().__init__(msg)
        self.cause = cause


class QueueFullError(ServingError):
    """Admission control: the bounded request queue is at
    ``queue_limit`` — shed load at the caller instead of queueing
    unboundedly."""


class RequestTimeoutError(ServingError):
    """The request spent longer than its ``timeout_ms`` in the queue
    and was rejected instead of dispatched."""


_live_engines: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _close_all_engines():
    for eng in list(_live_engines):
        try:
            eng.close(timeout=2.0)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _serving_enabled() -> bool:
    return os.environ.get("MXTPU_SERVING", "1").lower() \
        not in ("0", "false", "off")
