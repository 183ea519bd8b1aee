"""Python custom-operator bridge (the port of ``mxnet_tpu/operator.py``).

Parity target: the reference's ``python/mxnet/operator.py`` (CustomOp,
CustomOpProp, ``register``). A registered CustomOp executes inline on
the host thread: ``forward`` receives NDArrays (on the card, or the
CPU when asked for), writes its outputs through the reference's
``req`` assignment discipline (``assign``: ``dst[()] = src`` installs a
new tensor, so nothing autograd saved is written in place), and — when
autograd is recording — the op becomes one ``torch.autograd.Function``
whose backward calls the op's ``backward`` with zero ``in_grad``
arrays and ``req="write"``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as onp
import torch

__all__ = [
    "CustomOp", "CustomOpProp", "register", "custom",
    "get_all_registered_operators", "get_all_registered_operators_grouped",
    "get_operator_arguments",
    "PythonOp", "NumpyOp", "NDArrayOp",
]


class CustomOp:
    """Base class for operators implemented in Python.

    Subclass and override ``forward`` / ``backward``; both receive
    lists of NDArrays and a ``req`` list ('null'|'write'|'add'|
    'inplace') consumed through :meth:`assign`.
    """

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        # default: zero gradients (parity with a no-op backward)
        for i, g in enumerate(in_grad):
            self.assign(g, req[i], g * 0)

    @staticmethod
    def assign(dst, req, src):
        """Write ``src`` into ``dst`` honoring the grad-req discipline."""
        if req == "null":
            return
        if req == "add":
            dst[()] = dst + src
        else:  # write / inplace
            dst[()] = src


class CustomOpProp:
    """Operator property: names, shapes, dtypes, and the factory.

    Override ``list_arguments`` / ``list_outputs`` /
    ``list_auxiliary_states``, ``infer_shape`` / ``infer_type``,
    ``declare_backward_dependency`` and ``create_operator``.
    """

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, (in_shape[0],) * len(self.list_outputs()), ()

    def infer_type(self, in_type):
        return (in_type,
                [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


class PythonOp:
    """Deprecated pre-CustomOp interface (already deprecated in the
    reference). Kept for import compatibility; raises on use."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is the deprecated pre-1.0 custom-op "
            "interface; subclass mxnet_tpu_torch.operator.CustomOp / "
            "CustomOpProp and register() it instead")


class NumpyOp(PythonOp):
    """Deprecated (reference ``operator.py:155``)."""


class NDArrayOp(PythonOp):
    """Deprecated (reference ``operator.py:260``)."""


_registry: "OrderedDict[str, type]" = OrderedDict()


def register(reg_name):
    """Class decorator registering a :class:`CustomOpProp` under a name
    (parity: ``mx.operator.register``)."""

    def do_register(prop_cls):
        if not (isinstance(prop_cls, type)
                and issubclass(prop_cls, CustomOpProp)):
            raise TypeError("register() expects a CustomOpProp subclass")
        _registry[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered_operators():
    """Names of all registered custom operators."""
    return list(_registry)


def get_all_registered_operators_grouped():
    """Custom ops have no backward-node aliases here; one group each."""
    return {name: [name] for name in _registry}


def get_operator_arguments(op_name):
    """Introspect a registered prop's declared argument names."""
    prop = _registry[op_name]()
    return {"names": prop.list_arguments(),
            "types": ["NDArray"] * len(prop.list_arguments()),
            "narg": len(prop.list_arguments())}


def _as_ndarray(x):
    from .ndarray.ndarray import NDArray
    from . import numpy as _np
    if isinstance(x, NDArray):
        return x
    return _np.array(x)


def _run_forward(op, in_data, aux, out_shapes, out_types, ctx):
    """The op's forward under ``pause()`` into fresh zero outputs."""
    from . import autograd
    from . import numpy as _np
    is_train = autograd.is_training() or autograd.is_recording()
    with autograd.pause():
        out_data = [_np.zeros(s, dtype=t, ctx=ctx)
                    for s, t in zip(out_shapes, out_types)]
        op.forward(is_train=is_train, req=["write"] * len(out_data),
                   in_data=in_data, out_data=out_data, aux=aux)
    return out_data


class _CustomBridge(torch.autograd.Function):
    """One recorded custom op: forward and backward call the CustomOp
    instance carried on ``ctx``."""

    @staticmethod
    def forward(ctx, op, in_data, aux, meta, *tensors):
        from .ndarray.ndarray import NDArray
        out_shapes, out_types, octx = meta
        ins = [NDArray(t.detach(), ctx=d.ctx)
               for t, d in zip(tensors, in_data)]
        outs = _run_forward(op, ins, aux, out_shapes, out_types, octx)
        ctx.op, ctx.aux, ctx.octx = op, aux, octx
        ctx.ins, ctx.outs = ins, [o.detach() for o in outs]
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        from . import autograd
        from . import numpy as _np
        with autograd.pause():
            out_grad = [NDArray(c, ctx=ctx.octx) for c in cts]
            in_grad = [_np.zeros(d.shape, dtype=d.dtype, ctx=d.ctx)
                       for d in ctx.ins]
            ctx.op.backward(req=["write"] * len(in_grad),
                            out_grad=out_grad, in_data=ctx.ins,
                            out_data=ctx.outs, in_grad=in_grad,
                            aux=ctx.aux)
        return (None, None, None, None,
                *[g._data.to(d._data.dtype) for g, d in
                  zip(in_grad, ctx.ins)])


def custom(*data, op_type, **kwargs):
    """Invoke a registered custom op imperatively
    (parity: ``mx.nd.Custom(*data, op_type=...)``).

    ``data`` supplies the declared arguments followed by the declared
    auxiliary states. Extra keyword arguments are forwarded to the prop
    constructor.
    """
    from . import autograd, engine
    from .ndarray.ndarray import NDArray

    if op_type not in _registry:
        raise KeyError(
            f"custom op {op_type!r} is not registered; known: "
            f"{list(_registry)}")
    prop = _registry[op_type](**kwargs)

    n_args = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    if len(data) != n_args + n_aux:
        raise ValueError(
            f"custom op {op_type!r} declares {n_args} arguments + "
            f"{n_aux} aux states but got {len(data)} inputs")

    in_data = [_as_ndarray(d) for d in data[:n_args]]
    aux = [_as_ndarray(d) for d in data[n_args:]]

    in_shapes = [tuple(d.shape) for d in in_data]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [onp.dtype(d.dtype) for d in in_data]
    _, out_types, _ = prop.infer_type(in_types)

    ctx = in_data[0].ctx if in_data else None
    op = prop.create_operator(ctx, in_shapes, in_types)

    if autograd.is_recording() and any(
            autograd._on_tape(d) for d in in_data):
        with torch.enable_grad():
            res = _CustomBridge.apply(op, in_data, aux,
                                      (out_shapes, out_types, ctx),
                                      *[d._data for d in in_data])
        out_data = [NDArray(engine.track(t), ctx=ctx) for t in res]
    else:
        out_data = _run_forward(op, in_data, aux, out_shapes, out_types,
                                ctx)
    return out_data[0] if len(out_data) == 1 else tuple(out_data)
