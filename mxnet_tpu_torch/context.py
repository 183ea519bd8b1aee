"""Devices and contexts — the port's counterpart of ``Context``/``gpu()``.

Every entry point of the port (``GPTModel(...)``,
``GenerationEngine(...)``, ``mx.np.array(...)``) resolves its device
here. The default is the CUDA card; without one, resolution RAISES and
tells the caller to ask for the CPU explicitly. Nothing falls back to
the CPU on its own: a number taken on the CPU must never pass for one
taken on the card.

``Context`` keeps the reference's surface (``context.py:89-218``):
``cpu()``, ``gpu(i)``, ``with ctx:`` scopes, ``empty_cache`` and
``memory_info``. Unlike the reference's ``default_context()`` (the
accelerator if there is one, else the CPU), the port's default is
``gpu(0)`` whether or not a card is present, so array creation without
a context raises on a machine without one.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["resolve_device", "Context", "cpu", "cpu_pinned", "gpu", "tpu",
           "num_gpus", "default_context", "current_context",
           "gpu_memory_info"]


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``torch.device`` → a
    ``torch.device``. CUDA devices must exist; ``"cpu"`` is only ever
    used when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "by default — pass device='cpu' to run on the CPU "
                "(plain PyTorch versions of the kernels)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} requested but only {torch.cuda.device_count()} "
                f"CUDA device(s) are present")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


class Context:
    """A device context. devtype: 'cpu', 'gpu', 'cpu_pinned',
    'cpu_shared' ('tpu' is refused: the port runs on CUDA cards)."""

    _default_ctx = threading.local()

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "tpu":
            raise ValueError("the port has no TPU context; use gpu(i) "
                             "for the CUDA card or cpu()")
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_typeid = self.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names; a gpu context
        raises when the card is missing."""
        if self.device_typeid == 2:
            return resolve_device(f"cuda:{self.device_id}")
        return torch.device("cpu")

    # thread-local default context (parity with the reference)
    @classmethod
    def _current(cls) -> "Context":
        ctx = getattr(cls._default_ctx, "value", None)
        if ctx is None:
            ctx = default_context()
            cls._default_ctx.value = ctx
        return ctx

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, *exc):
        Context._default_ctx.value = self._old_ctx
        return False

    def empty_cache(self):
        """Release the caching allocator's unused blocks (the
        reference's pooled-storage ReleaseAll)."""
        if self.device_typeid == 2:
            with torch.cuda.device(self.torch_device):
                torch.cuda.empty_cache()

    def memory_info(self):
        """``(free_bytes, total_bytes)`` of this context's device: the
        card's from ``cudaMemGetInfo``, the host's from
        ``/proc/meminfo``."""
        if self.device_typeid == 2:
            return torch.cuda.mem_get_info(self.torch_device)
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = int(rest.split()[0]) * 1024
        total = info.get("MemTotal", 0)
        return (info.get("MemAvailable", total), total)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory's context (its tensors are CPU tensors
    to torch)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The reference's accelerator context; the port has none."""
    raise ValueError("the port runs on CUDA cards: use mx.gpu(i) (or "
                     "mx.cpu() for the plain versions on the host)")


def num_gpus() -> int:
    """Number of CUDA devices visible (parity: mx.context.num_gpus)."""
    return torch.cuda.device_count()


def default_context() -> Context:
    """``gpu(0)``: the port's entry points run on the card unless the
    caller asks for the CPU."""
    return gpu(0)


def current_context() -> Context:
    return Context._current()


def gpu_memory_info(device_id: int = 0):
    """``(free, total)`` bytes of card ``device_id``
    (``torch.cuda.mem_get_info``)."""
    return gpu(device_id).memory_info()
