"""Operators of the port: plain PyTorch, plus hand-written CUDA kernels
where the JAX package had a Pallas kernel (``attention``,
``quantized``); ``sampling`` is plain PyTorch, as it is plain jnp in
the reference."""
from . import attention, nn, quantized, sampling

__all__ = ["attention", "nn", "quantized", "sampling", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> dict:
    """Launches of every CUDA kernel of the port since the last reset,
    by kernel name."""
    return {**attention.launch_counts(), **quantized.launch_counts()}


def reset_launch_counts():
    attention.reset_launch_counts()
    quantized.reset_launch_counts()
