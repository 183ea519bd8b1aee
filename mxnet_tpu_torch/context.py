"""Device resolution — the port's counterpart of ``Context``/``gpu()``.

Every entry point of the port (``GPTModel(...)``,
``GenerationEngine(...)``) takes a ``device`` argument and resolves it
here. The default is the CUDA card; without one, resolution RAISES and
tells the caller to ask for the CPU explicitly. Nothing falls back to
the CPU on its own: a number taken on the CPU must never pass for one
taken on the card.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
