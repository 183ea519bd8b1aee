"""The knobs of the port's kernel caches (the port of
``mxnet_tpu/compile_cache.py``, which points JAX's persistent XLA cache
at a directory).

The port has two caches on disk: the ``nvcc`` libraries of its CUDA
kernels (``_build.py``: one library per source, named by a hash of the
source, the header and the flags) and Triton's cache of compiled
``rtc.PallasModule`` kernels (``TRITON_CACHE_DIR``, by default a
``triton/`` folder in the same directory). NVRTC's modules
(``rtc.CudaModule``) are cached in memory only. Both disk caches are
always on, in ``mxnet_tpu_torch/_build/`` unless configured:

- ``configure(path)`` (or ``MXTPU_COMPILE_CACHE_DIR``) moves them to
  ``path`` (created if missing; Triton's to ``path/triton`` unless
  ``TRITON_CACHE_DIR`` is set). ``configure()`` with neither changes
  nothing and returns None, so kernels keep building into ``_build/``.
- ``cache_dir()`` is the directory in use; ``entry_count()`` counts the
  kernel libraries in it and the entries of its ``triton/`` folder.
- ``measure()`` wraps a build: with telemetry on, it classifies it as a
  cache ``hit`` (no new entry appeared) or ``miss`` and records the wall
  time (``compile_cache.hit``/``.miss``, ``compile_cache.compile`` ms,
  the ``compile_cache.entries`` gauge).
"""
from __future__ import annotations

import contextlib
import os
from pathlib import Path

from . import telemetry

__all__ = ["configure", "enabled", "cache_dir", "entry_count", "measure"]

_configured: list = [None]


def configure(path: str | None = None) -> str | None:
    """Point both kernel caches at ``path`` (default:
    ``MXTPU_COMPILE_CACHE_DIR``). Changes nothing and returns None when
    neither is set; else returns the directory now in use."""
    from . import _build
    path = path or os.environ.get("MXTPU_COMPILE_CACHE_DIR")
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(path, "triton"))
    _configured[0] = str(path)
    telemetry.gauge("compile_cache.entries", entry_count())
    return _configured[0]


def enabled() -> bool:
    """True: the kernel libraries are always cached on disk."""
    return True


def cache_dir() -> str:
    from . import _build
    return str(_build.BUILD_DIR)


def entry_count() -> int:
    """Kernel libraries and Triton cache entries in ``cache_dir()``."""
    root = cache_dir()
    try:
        n = sum(1 for e in os.scandir(root)
                if e.is_file() and e.name.endswith(".so"))
    except OSError:
        return 0
    try:
        n += sum(1 for _ in os.scandir(os.path.join(root, "triton")))
    except OSError:
        pass
    return n


@contextlib.contextmanager
def measure(site: str = "compile"):  # noqa: ARG001 - the reference's API
    """Wrap one build: classify it as a cache hit or miss by whether the
    cache grew, and record its wall time. Free when telemetry is off."""
    if not telemetry.enabled():
        yield
        return
    before = entry_count()
    t0 = telemetry.clock()
    try:
        yield
    finally:
        telemetry.duration_since("compile_cache.compile", t0)
        after = entry_count()
        telemetry.gauge("compile_cache.entries", after)
        telemetry.counter("compile_cache.miss" if after > before
                          else "compile_cache.hit")
