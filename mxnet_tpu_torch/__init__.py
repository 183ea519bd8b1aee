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

It trains the same model on one card: ``parallel.TrainStep`` (forward,
backward and update of a batch) with ``optimizer`` (SGD, NAG, Adam,
AdamW), ``lr_scheduler`` and ``gluon.loss``, in fp32 or bf16 compute;
the attention's backward is a hand-written kernel too.

The imperative front end is ported too: ``mx.np`` arrays
(``NDArray`` over a ``torch.Tensor``), ``mx.npx``, ``autograd``
(record/pause, backward, ``Function``), ``operator`` (CustomOp) and
``rtc`` (user kernels compiled at runtime: ``CudaModule``, CUDA C
through NVRTC, and ``PallasModule``, Python source in Triton), the
contrib operators of ``mx.npx`` (detection, ROI, warping, the
deformable convolutions, ...), the sparse arrays of ``mx.nd.sparse``
and ``test_utils``.

Device rule: entry points default to the CUDA card (``device="cuda"``,
``mx.gpu(0)``) and raise when no card is present — pass
``device="cpu"`` or use ``with mx.cpu():`` to run the plain versions on
the CPU. Nothing falls back on its own.

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
never ``mxnet_tpu``. The standard-library modules it needs from the JAX
package (``telemetry``, ``tracing``, ``_bounded_worker``,
``bucketing``) are its own copies. Importing it compiles nothing, loads
no NVRTC and touches no device.
"""
from . import telemetry, tracing, bucketing, base, context, engine
from . import autograd, ops, random_state
from .base import (MXNetError, set_np, reset_np, is_np_array, is_np_shape,
                   is_np_default_dtype)
from .context import (Context, cpu, gpu, num_gpus, current_context,
                      resolve_device)
from .ndarray.ndarray import NDArray, waitall
from . import ndarray, numpy, numpy_extension, operator, rtc
from . import gluon, serving, optimizer, lr_scheduler, parallel
from . import test_utils

nd = ndarray
np = numpy
npx = numpy_extension

__all__ = ["telemetry", "tracing", "bucketing", "base", "context", "engine",
           "autograd", "ops", "random_state", "ndarray", "numpy",
           "numpy_extension", "operator", "rtc", "gluon", "serving",
           "optimizer", "lr_scheduler", "parallel", "test_utils", "nd",
           "np", "npx", "NDArray", "Context", "cpu", "gpu", "num_gpus",
           "current_context", "waitall", "resolve_device", "MXNetError",
           "set_np", "reset_np", "is_np_array", "is_np_shape",
           "is_np_default_dtype"]
