"""mx.npx — the NumPy-extension operators this slice ports.

The port of ``mxnet_tpu/numpy_extension/__init__.py``'s activations
(``relu``, ``sigmoid``), the softmax family (``softmax``,
``log_softmax``, with ``length``/``use_length`` masking and
``temperature``), ``dropout`` (active only under
``autograd.is_training()``, drawing from the port's generator),
``one_hot``, ``pick``, ``topk``, ``custom`` and the framework helpers
``waitall``/``num_gpus``/``current_device``. Everything runs as plain
PyTorch through ``ops.apply_op``.

``flash_attention`` runs K1 forward and, under ``record()``, K1-bwd
backward (``ops.attention``). ``decode_attention`` and the other
functions of the reference raise ``base.not_ported(..., 13)``.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from ..base import not_ported, resolve_dtype
from ..ndarray.ndarray import _signed_view
from ..ops import apply_op
from ..ops import nn as _nn
from ..random_state import generator

__all__ = ["relu", "sigmoid", "softmax", "log_softmax", "dropout",
           "one_hot", "pick", "topk", "flash_attention", "custom",
           "waitall", "num_gpus", "current_device"]


def _c(x):
    from ..numpy import _coerce
    return _coerce(x)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def relu(data, **kwargs):
    from ..numpy import _bool_route, _int64_route
    # a bool input gives int32, as in the reference
    return apply_op(_bool_route(_int64_route(torch.relu)), _c(data),
                    name="relu")


def sigmoid(data, **kwargs):
    return apply_op(torch.sigmoid, _c(data), name="sigmoid")


# ---------------------------------------------------------------------------
# softmax family
# ---------------------------------------------------------------------------
def _mask_by_length(x, length, axis):
    ax = axis % x.dim()
    idx = torch.arange(x.shape[ax], device=x.device)
    idx = idx.reshape((1,) * ax + (-1,) + (1,) * (x.dim() - ax - 1))
    ln = length.reshape(tuple(length.shape)
                        + (1,) * (x.dim() - length.dim()))
    return torch.where(idx < ln, x, float("-inf"))


def _int_softmax(x, axis, log):
    """(log-)softmax of an integer tensor as the reference's
    ``jax.nn.softmax``/``log_softmax`` compute it: x less its max in x's
    own type (below the max an unsigned type wraps, and a signed one
    whose range overflows it), then exp, the sum and the division (or
    log) in float32, with no second shift. A wrapped difference
    overflows exp, and the reference's inf and NaN come out here too."""
    x64 = x.to(torch.int64)
    s = (x64 - x64.amax(dim=axis, keepdim=True)).to(x.dtype).float()
    tot = torch.exp(s).sum(dim=axis, keepdim=True)
    return s - torch.log(tot) if log else torch.exp(s) / tot


def _softmax_fn(tfn, axis, temperature, masked):
    def f(x, *length):
        if temperature is not None and temperature != 1.0:
            x = x / temperature
        if masked:
            x = _mask_by_length(x, length[0], axis)
        if x.dtype != torch.bool and not x.is_floating_point():
            return _int_softmax(x, axis, tfn is torch.log_softmax)
        return tfn(x, dim=axis)
    return f


def softmax(data, length=None, axis=-1, temperature=None, use_length=False,
            dtype=None, **kwargs):
    masked = use_length and length is not None
    args = (_c(data), _c(length)) if masked else (_c(data),)
    r = apply_op(_softmax_fn(torch.softmax, axis, temperature, masked),
                 *args, name="softmax")
    return r.astype(dtype) if dtype is not None else r


def log_softmax(data, axis=-1, length=None, temperature=None,
                use_length=False, dtype=None, **kwargs):
    masked = use_length and length is not None
    args = (_c(data), _c(length)) if masked else (_c(data),)
    r = apply_op(_softmax_fn(torch.log_softmax, axis, temperature, masked),
                 *args, name="log_softmax")
    return r.astype(dtype) if dtype is not None else r


# ---------------------------------------------------------------------------
# dropout / indexing
# ---------------------------------------------------------------------------
def dropout(data, p=0.5, axes=None, mode="training", cudnn_off=None,
            **kwargs):
    """Inverted dropout, active only under ``autograd.train_mode``
    (parity: src/operator/nn/dropout.cc 'training' mode); ``axes``
    broadcasts the mask (spatial dropout)."""
    data = _c(data)
    if p <= 0.0 or (mode == "training" and not _ag.is_training()):
        return data
    gen = generator(data._data.device)
    return apply_op(lambda x: _nn.dropout(x, p, axes, gen), data,
                    name="dropout")


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32",
            **kwargs):
    """Out-of-range indices give an all-``off_value`` row, as
    ``jax.nn.one_hot`` does."""
    dt = resolve_dtype(dtype)

    def f(i):
        hot = i.to(torch.int64).unsqueeze(-1) == torch.arange(
            depth, device=i.device)
        return hot.to(dt) * (on_value - off_value) + off_value
    return apply_op(f, _c(data), name="one_hot")


def topk(data, k=1, axis=-1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kwargs):
    from ..numpy import _UNSIGNED, _WIDE_UNSIGNED
    idt = resolve_dtype(dtype)

    def f(x):
        ax = axis % x.dim()
        src = x.dtype
        # torch ranks no uint16/32/64 and no bool: rank their int64
        # (int32) values
        xm = x.movedim(ax, -1)
        if src in _WIDE_UNSIGNED:
            xm = xm.to(torch.int64)
        elif src == torch.bool:
            xm = xm.to(torch.int32)
        # the reference's top_k keeps the lower index first among
        # ties, as a stable sort does (torch.topk orders ties as it
        # likes, and the CPU and the card differ); bottom-k by a stable
        # ascending sort, as the reference
        vals, idx = torch.sort(xm, dim=-1, descending=not is_ascend,
                               stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        if ret_typ == "mask":
            # the reference sums k one-hots in the data's dtype, so the
            # mask takes sum's dtype: uint32 for an unsigned input, int32
            # (narrowed from int64) for another integer one
            mask = torch.zeros_like(xm).scatter(-1, idx, 1)
            if src in _UNSIGNED:
                mask = mask.to(torch.uint32)
            elif not (src.is_floating_point or src.is_complex):
                mask = mask.to(torch.int64)
            return mask.movedim(-1, ax)
        vals, idx = vals.to(src).movedim(-1, ax), idx.movedim(-1, ax)
        if ret_typ == "indices":
            return idx.to(idt)
        if ret_typ == "value":
            return vals
        if ret_typ == "both":
            return vals, idx.to(idt)
        raise ValueError(f"unsupported ret_typ {ret_typ!r}")

    return apply_op(f, _c(data), nout=2 if ret_typ == "both" else 1,
                    name="topk")


def pick(data, index, axis=-1, mode="clip", keepdims=False, **kwargs):
    """``mode='clip'`` clamps an index into range, ``'wrap'`` wraps it."""
    @_signed_view
    def f(x, i):
        ax = axis % x.dim()
        i = i.to(torch.int64)
        n = x.shape[ax]
        i = i.remainder(n) if mode == "wrap" else i.clamp(0, n - 1)
        out = torch.take_along_dim(x, i.unsqueeze(ax), dim=ax)
        return out if keepdims else out.squeeze(ax)
    return apply_op(f, _c(data), _c(index), name="pick")


# ---------------------------------------------------------------------------
# framework helpers
# ---------------------------------------------------------------------------
def custom(*data, op_type, **kwargs):
    """Invoke a registered Python CustomOp (parity: mx.nd.Custom); a
    thin alias of ``mxnet_tpu_torch.operator.custom``."""
    from .. import operator as _operator
    return _operator.custom(*data, op_type=op_type, **kwargs)


def num_gpus():
    from ..context import num_gpus as _n
    return _n()


def current_device():
    from ..context import current_context
    return current_context()


def waitall():
    from .. import engine
    engine.waitall()


def flash_attention(query, key, value, causal=False, scale=None,
                    kv_len=None):
    """Blockwise (flash) attention over (B, H, S, D) NDArrays: K1's
    forward and K1-bwd's backward on the card, their plain versions on
    the CPU (``ops.attention.flash_attention``). Under ``record()`` the
    gradients of q, k and v reach ``.grad`` through ``backward``.
    ``kv_len`` (int) marks the valid key prefix of a longer cache buffer:
    the tail is masked out and the causal diagonal end-aligns against
    the valid prefix."""
    from ..ops import attention as _att

    def fn(q, k, v):
        return _att.flash_attention(q, k, v, causal, scale, kv_len)

    return apply_op(fn, _c(query), _c(key), _c(value),
                    name="flash_attention")


def decode_attention(*args, **kwargs):
    raise not_ported("npx.decode_attention", 13)


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy_extension' has no attribute "
            f"{name!r}")
    raise not_ported(f"npx.{name}", 13)
