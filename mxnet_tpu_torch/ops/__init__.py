"""Operators of the port: plain PyTorch, plus hand-written CUDA kernels
where the JAX package had a Pallas kernel (``attention``)."""
from . import attention, nn

__all__ = ["attention", "nn"]
