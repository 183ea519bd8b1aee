"""Operators of the port: plain PyTorch, plus hand-written CUDA kernels
where the JAX package had a Pallas kernel (``attention``,
``quantized``, and the runtime-compiled user kernels of ``rtc``);
``sampling`` is plain PyTorch, as it is plain jnp in the reference.

``apply_op`` is the imperative front end's single funnel (the port of
``mxnet_tpu/ops/__init__.py:44-145``): every ``mx.np``/``npx`` op and
every NDArray method goes through it. It unwraps NDArrays, runs the op
with torch's grad mode on only while ``autograd.record()`` is active
and some input is on the tape (torch would otherwise build a graph
wherever a tensor that requires grad is used; MXNet records only inside
``record()`` and never inside ``pause()``), narrows 64-bit results to
32 bits (the reference's x64-off policy, ``base.narrowing()``) and wraps
the outputs on the inputs' context. Under ``amp.init()`` it applies
the AMP lists' casts to an op by its ``name`` (``amp.autocast_plan``)
inside the function it runs, so the backward casts the cotangents
back; the names whose ``ops.nn`` entry points cast their own inputs
(``nn.AMP_CAST_AT_ENTRY``) are left to them.
"""
from __future__ import annotations

import torch

from . import attention, nn, quantized, sampling
from .. import amp, autograd, engine
from ..base import narrowing

__all__ = ["attention", "nn", "quantized", "sampling", "apply_op",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict:
    """Launches of every CUDA kernel of the port since the last reset,
    by kernel name."""
    from .. import rtc
    return {**attention.launch_counts(), **quantized.launch_counts(),
            **rtc.launch_counts()}


def reset_launch_counts():
    from .. import rtc
    attention.reset_launch_counts()
    quantized.reset_launch_counts()
    rtc.reset_launch_counts()


_NDArray = []


def _ndarray_cls():
    if not _NDArray:
        from ..ndarray.ndarray import NDArray
        _NDArray.append(NDArray)
    return _NDArray[0]


def _finish(t: torch.Tensor) -> torch.Tensor:
    narrow = narrowing().get(t.dtype)
    if narrow is not None:
        t = t.to(narrow)
    return engine.track(t)


def _cast_first(fn, plan):
    def cast(*xs):
        return fn(*[x.to(plan[i]) if i in plan else x
                    for i, x in enumerate(xs)])
    return cast


def apply_op(fn, *args, nout: int = 1, ctx=None, name: str = None):
    """Invoke ``fn`` over mixed NDArray / raw arguments.

    Positional NDArray arguments are the differentiable inputs; all
    static attributes must already be closed over in ``fn``. Returns
    one NDArray (``nout == 1``) or a tuple of NDArrays.
    """
    NDArray = _ndarray_cls()
    datas = []
    on_tape = False
    octx = ctx
    for a in args:
        if isinstance(a, NDArray):
            t = a._data
            datas.append(t)
            on_tape = on_tape or t.requires_grad
            if octx is None:
                octx = a._ctx
        else:
            datas.append(a)
    if name is not None and amp.is_active() \
            and name not in nn.AMP_CAST_AT_ENTRY:
        pos = [i for i, a in enumerate(args) if isinstance(a, NDArray)]
        plan = amp.autocast_plan(name, datas, pos)
        if plan:
            fn = _cast_first(fn, plan)
    with torch.set_grad_enabled(on_tape and autograd.is_recording()):
        out = fn(*datas)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    wrapped = [NDArray(_finish(o), ctx=octx) for o in outs]
    if nout == 1 and len(wrapped) == 1:
        return wrapped[0]
    return tuple(wrapped)
