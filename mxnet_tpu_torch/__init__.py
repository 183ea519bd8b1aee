"""mxnet_tpu_torch — the PyTorch / CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, mirroring its layout and names
(each module sits at the same relative path as its counterpart). It
serves greedy generation: the GPT decoder (``gluon.model_zoo.gpt``)
behind the continuously batched ``serving.GenerationEngine``, on a
dense or a paged KV cache (prefix sharing, copy-on-write, chunked
prefill), with fp32 or weight-only int8 projections. Prefill attention,
dense and paged decode attention and the int8 projection run as CUDA
kernels written by hand for Hopper (``csrc/``, built with ``nvcc`` at
the first CUDA call, see ``_build.py``); everything else is plain
PyTorch.

Device rule: entry points default to ``device="cuda"`` and raise when no
card is present — pass ``device="cpu"`` to run the plain versions on the
CPU. Nothing falls back on its own.

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
never ``mxnet_tpu``. The standard-library modules it needs from the JAX
package (``telemetry``, ``tracing``, ``_bounded_worker``,
``bucketing``) are its own copies.
"""
from . import telemetry, tracing, bucketing, context, ops
from .context import resolve_device
from . import gluon, serving

__all__ = ["telemetry", "tracing", "bucketing", "context", "ops", "gluon",
           "serving", "resolve_device"]
