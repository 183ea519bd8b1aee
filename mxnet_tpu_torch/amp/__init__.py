"""Automatic mixed precision (the port of ``mxnet_tpu/amp/``).

``amp.init("float16"|"bfloat16")`` turns on a process-wide switch that
the cast insertion reads. The casts follow the reference's lists
(``lists.py``), not ``torch.autocast``'s, whose op lists differ (the
reference pins ``sum``, ``mean`` and ``exp`` to fp32 and casts ``add``
and ``where`` to the widest type): ``autocast_plan(name, ...)`` says
which inputs of the op ``name`` to cast to what.

The plan is applied where an op's inputs are still its own:

- ``ops.apply_op`` (every ``mx.np``/``mx.npx`` op, by the name it
  passes), inside the recorded function, so autograd's backward casts
  the cotangents back;
- the named entry points of ``ops.nn`` that the Gluon layers call on
  tensors (``fully_connected``, ``convolution``, ``deconvolution``, the
  norms, ``masked_softmax``: ``cast_args``), since those layers do not
  go through ``apply_op``. ``apply_op`` leaves those names to them
  (``ops.nn.AMP_CAST_AT_ENTRY``), so no cast is applied twice.

The losses' named ops (``log_softmax``, the per-sample ``mean``) call
``cast_args`` where they compute. Elsewhere the Gluon layers need no
cast of their own: attention's padded products take the projections'
low type, as the reference's ``batch_dot`` casts give it, and torch's
promotion of two float types is the widest type.

``init_trainer`` gives a ``Trainer`` dynamic loss scaling
(``LossScaler``): ``scale_loss`` multiplies the loss by the scale, the
Trainer divides the gradients by it (once, also after ``unscale``),
skips a step whose gradients overflow and adapts the scale.
"""
from __future__ import annotations

import contextlib

import numpy as onp
import torch

from . import lists  # noqa: F401
from .loss_scaler import LossScaler, all_finite  # noqa: F401

__all__ = ["init", "is_active", "target_dtype", "amp_cast", "autocast_plan",
           "cast_args", "amp_multicast", "init_trainer", "unscale",
           "scale_loss", "convert_model", "convert_hybrid_block",
           "list_lp16_ops", "list_fp16_ops", "list_fp32_ops",
           "list_lp16_fp32_ops", "list_widest_type_cast",
           "list_conditional_fp32_ops", "list_lp16_use_fp32_params",
           "list_loss_output_functions", "convert_symbol", "LossScaler",
           "lists"]

_state = {"active": False, "target_dtype": None}
_LOW = (torch.float16, torch.bfloat16)


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP (parity: amp.init). target_dtype: 'bfloat16'|'float16'."""
    if isinstance(target_dtype, str):
        assert target_dtype in ("bfloat16", "float16")
    _state["active"] = True
    _state["target_dtype"] = str(target_dtype)


def is_active():
    return _state["active"]


def target_dtype():
    """The low-precision ``torch.dtype`` of the active AMP."""
    return torch.float16 if _state["target_dtype"] == "float16" \
        else torch.bfloat16


def amp_cast(x, dtype):
    """Cast an NDArray or a tensor (parity: the amp_cast op)."""
    if torch.is_tensor(x):
        from ..base import to_torch_dtype
        return x.to(to_torch_dtype(dtype))
    return x.astype(dtype)


def _dtype(x):
    return x.dtype if torch.is_tensor(x) else None


def autocast_plan(name, datas, nd_positions):
    """``{position: torch.dtype}``: the casts the lists give the op
    ``name`` on the tensors ``datas`` at ``nd_positions``."""
    plan = {}
    if name in lists.TARGET_DTYPE_SET:
        tgt = target_dtype()
        for i in nd_positions:
            if _dtype(datas[i]) == torch.float32:
                plan[i] = tgt
    elif name in lists.FP32_SET:
        for i in nd_positions:
            if _dtype(datas[i]) in _LOW:
                plan[i] = torch.float32
    elif name in lists.WIDEST_SET:
        fdts = [datas[i].dtype for i in nd_positions
                if torch.is_tensor(datas[i])
                and datas[i].is_floating_point()]
        if len(set(fdts)) > 1:
            widest = fdts[0]
            for d in fdts[1:]:
                widest = torch.promote_types(widest, d)
            for i in nd_positions:
                t = datas[i]
                if torch.is_tensor(t) and t.is_floating_point() \
                        and t.dtype != widest:
                    plan[i] = widest
    return plan


def cast_args(name, *args):
    """``args`` with the casts of :func:`autocast_plan` applied to its
    tensors (``args`` unchanged when AMP is off)."""
    if not _state["active"]:
        return args
    pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]
    plan = autocast_plan(name, args, pos)
    if not plan:
        return args
    return tuple(a.to(plan[i]) if i in plan else a
                 for i, a in enumerate(args))


def amp_multicast(*args, cast_narrow=False):
    """Cast ``args`` to their widest (or narrowest) common dtype
    (parity: amp_multicast)."""
    dts = [a.dtype for a in args]
    widths = [torch.empty((), dtype=d).element_size()
              if isinstance(d, torch.dtype) else onp.dtype(d).itemsize
              for d in dts]
    pick = dts[int(onp.argmin(widths))] if cast_narrow else \
        dts[int(onp.argmax(widths))]
    return [amp_cast(a, pick) for a in args]


def init_trainer(trainer):
    """Give ``trainer`` dynamic loss scaling (for float16)."""
    trainer._amp_loss_scaler = LossScaler()
    return trainer


def unscale(trainer):
    """Divide the gradients by the loss scale in place (e.g. to clip
    them before ``step``); the trainer then does not divide again."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    for p in trainer._params:
        g = p._nd._grad
        if p.grad_req != "null" and p._initialized and g is not None:
            g._install(g._data * inv)
    trainer._amp_manual_unscaled = True


def scale_loss(loss, trainer):
    """Context manager yielding the loss times the trainer's scale
    (parity: amp.scale_loss)."""

    @contextlib.contextmanager
    def _scope():
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if scaler is None:
            yield loss
            return
        if isinstance(loss, (list, tuple)):
            yield [l * scaler.loss_scale for l in loss]
        else:
            yield loss * scaler.loss_scale

    return _scope()


def convert_model(net, target_dtype="bfloat16", excluded_sym_names=None):
    return convert_hybrid_block(net, target_dtype)


def convert_hybrid_block(net, target_dtype="bfloat16",
                         excluded_layers=None):
    """Cast the float parameters of every layer but the norms (and
    ``excluded_layers``) to ``target_dtype``, in place; returns
    ``net``."""
    from ..gluon import nn as gnn
    keep_fp32 = (gnn.BatchNorm, gnn.LayerNorm, gnn.GroupNorm,
                 gnn.InstanceNorm)
    if excluded_layers:
        keep_fp32 = keep_fp32 + tuple(excluded_layers)

    def _cast(block):
        if isinstance(block, keep_fp32):
            return
        for p in block._reg_params.values():
            if p._initialized and p.dtype.is_floating_point:
                p.cast(target_dtype)

    net.apply(_cast)
    return net


# -- the lists (parity: amp/amp.py list_* helpers) ----------------------
def list_lp16_ops(target_dtype="bfloat16"):  # noqa: ARG001
    """Ops cast to the low-precision dtype."""
    return sorted(lists.TARGET_DTYPE_SET)


def list_fp16_ops(target_dtype="float16"):  # noqa: ARG001
    return list_lp16_ops(target_dtype)


def list_fp32_ops(target_dtype=None):  # noqa: ARG001
    """Ops pinned to float32."""
    return sorted(lists.FP32_SET)


def list_lp16_fp32_ops(target_dtype=None):  # noqa: ARG001
    """Ops that take the widest type of their inputs."""
    return sorted(lists.WIDEST_SET)


def list_widest_type_cast(target_dtype=None):  # noqa: ARG001
    return sorted(lists.WIDEST_SET)


def list_conditional_fp32_ops(target_dtype=None):  # noqa: ARG001
    """Empty: no pin depends on an op's attributes."""
    return []


def list_lp16_use_fp32_params(target_dtype=None):  # noqa: ARG001
    """Empty: fp32 master weights are the optimizers'
    ``multi_precision``."""
    return []


def list_loss_output_functions(target_dtype=None):  # noqa: ARG001
    return sorted(getattr(lists, "LOSS_OUTPUT_SET", set()))


def convert_symbol(sym, target_dtype="bfloat16", **kwargs):  # noqa: ARG001
    """The symbol unchanged: the casts happen when it runs under
    ``amp.init()``, as in the reference."""
    return sym
