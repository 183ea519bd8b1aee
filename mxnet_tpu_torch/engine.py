"""Execution engine shim (the port's ``mxnet_tpu/engine.py``).

PyTorch already gives the reference engine's contract on the card: an
op is enqueued on the current CUDA stream and returns at once, data
dependencies are ordered by the stream, and a device-side error
surfaces at the next synchronization. What remains is the control
surface:

- ``waitall()`` synchronizes every device the port has computed on, so
  a deferred device error surfaces there, as the reference's
  ``WaitForAll`` re-throws;
- ``wait_to_read(t)`` synchronizes the device of one tensor;
- ``MXTPU_ENGINE_TYPE=NaiveEngine`` (or ``set_engine_type``) makes
  every op synchronize, so an error surfaces at the op that caused it;
- ``bulk`` is a compatibility no-op scope.

``track`` is on every op's path: it notes the op's device and, only
while telemetry is on, keeps a weak reference to the tensor for the
``engine.live_*`` gauges.
"""
from __future__ import annotations

import os
import threading
import weakref

import torch

from . import telemetry

__all__ = ["track", "waitall", "wait_to_read", "set_engine_type",
           "engine_type", "is_naive", "sample_memory", "bulk"]

_live_arrays: dict = {}
_live_lock = threading.Lock()
_live_peak = [0]
#: indices of the CUDA devices an op has run on (waitall syncs these)
_cuda_devices: set = set()

_engine_type = os.environ.get(
    "MXTPU_ENGINE_TYPE",
    os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice"))


def set_engine_type(name: str):
    """'NaiveEngine' -> synchronous execution; anything else -> async."""
    global _engine_type
    _engine_type = name


def engine_type() -> str:
    return _engine_type


def is_naive() -> bool:
    return _engine_type == "NaiveEngine"


def track(data: torch.Tensor) -> torch.Tensor:
    """Note an op's output tensor; returns it. In naive mode, waits for
    its device so errors surface at the faulting op."""
    if data.is_cuda:
        _cuda_devices.add(data.device.index)
        if _engine_type == "NaiveEngine":
            torch.cuda.synchronize(data.device)
    if telemetry.enabled():
        key = id(data)

        def _drop(_ref, _key=key):
            _live_arrays.pop(_key, None)

        with _live_lock:
            _live_arrays[key] = weakref.ref(data, _drop)
            n = len(_live_arrays)
            if n > _live_peak[0]:
                _live_peak[0] = n
    return data


def sample_memory():
    """Record device-memory and live-array watermarks into telemetry:
    the caching allocator's allocated bytes on each card in use, and
    the tensors the engine is tracking."""
    if not telemetry.enabled():
        return
    dev_bytes = sum(torch.cuda.memory_allocated(i)
                    for i in sorted(_cuda_devices))
    with _live_lock:
        live = [r() for r in _live_arrays.values()]
    live = [t for t in live if t is not None]
    telemetry.gauge("engine.live_arrays", len(live), peak=_live_peak[0])
    telemetry.gauge("engine.live_bytes",
                    sum(t.numel() * t.element_size() for t in live))
    if dev_bytes:
        telemetry.gauge("engine.device_mem_bytes", dev_bytes)


def waitall():
    """Block until all enqueued work has finished (parity:
    mx.nd.waitall); a deferred device error is raised here."""
    sample_memory()
    with _live_lock:
        _live_arrays.clear()
    telemetry.gauge("engine.live_arrays", 0)
    telemetry.gauge("engine.live_bytes", 0)
    for i in sorted(_cuda_devices):
        torch.cuda.synchronize(i)


def wait_to_read(data: torch.Tensor) -> torch.Tensor:
    """Block until one tensor is computed; re-raise a deferred error."""
    if data.is_cuda:
        torch.cuda.synchronize(data.device)
    return data


class bulk:
    """Hint scope for op bulking (parity: Engine bulk API). PyTorch's
    eager dispatch is already asynchronous; the scope does nothing and
    says so once. A CUDA graph is the port's tool for bulking
    (ROADMAP.md, queue 2)."""

    _warned = False

    def __init__(self, size: int = 0):
        self.size = size

    def __enter__(self):
        if not bulk._warned:
            bulk._warned = True
            import warnings
            warnings.warn("mx.engine.bulk is a compatibility no-op: eager "
                          "dispatch is already asynchronous",
                          stacklevel=2)
        return self

    def __exit__(self, *exc):
        return False
