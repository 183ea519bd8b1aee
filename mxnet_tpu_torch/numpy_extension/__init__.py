"""mx.npx — the NumPy-extension operators (the port of
``mxnet_tpu/numpy_extension/__init__.py``).

Everything the reference's module defines itself: the activations
(``activation``'s whole table, ``relu``, ``sigmoid``, ``gelu``,
``leaky_relu``, ...), the softmax family (``softmax``, ``log_softmax``,
``masked_softmax``, ``masked_log_softmax``, ``softmin``), the layers
(``fully_connected``, ``convolution``, ``deconvolution``, ``pooling``,
``batch_norm`` with its running statistics, ``layer_norm``,
``group_norm``, ``instance_norm``, ``rms_norm``, ``l2_normalization``,
``embedding``, ``dropout``, ``rnn``), the special functions, indexing
and sequence ops, the multi-tensor helpers, ``ctc_loss``,
``multibox_prior``, ``roi_pooling``, ``upsampling``, the legacy output
heads (``softmax_output``, ``make_loss``, the regression outputs: each
a ``torch.autograd.Function`` whose backward is the reference's
``custom_vjp`` rule), ``flash_attention`` (K1 forward and, under
``record()``, K1-bwd backward), ``decode_attention`` (K2),
``control_flow`` (``foreach``, ``while_loop``, ``cond``), ``npx.random``
and the np-mode switches (``set_np``, ``reset_np``, ``is_np_array``,
``is_np_shape``). Each runs through ``ops.apply_op`` over the layer in
``ops/nn.py``, on the device of its inputs.

The contrib operators the reference imports from ``contrib_ops.py``
(detection, ROI, warping, resize, sliding-window attention, the
deformable convolutions, ...) are this package's ``contrib_ops``.

Not ported: ``ring_attention`` (ROADMAP.md queue 1, item 20) and
``load``/``save`` (item 18); each raises ``base.NotPortedError``.
"""
from __future__ import annotations

import builtins
import math

import numpy as onp
import torch
import torch.nn.functional as F

from .. import autograd as _ag
from ..base import (UNSIGNED, WIDE_UNSIGNED, float_input,  # noqa: F401
                    not_ported, resolve_dtype, set_np, reset_np,
                    is_np_array, is_np_shape)
from ..ndarray.ndarray import _SIGNED_VIEW, _signed_view
from ..numpy import _float_in
from ..ops import apply_op
from ..ops import nn as _nn
from ..random_state import generator
from . import random  # noqa: E402,F401  (npx.random: bernoulli, ...)

__all__ = [
    # activations
    "activation", "relu", "sigmoid", "log_sigmoid", "softsign", "softplus",
    "mish", "gelu", "silu", "leaky_relu", "hard_sigmoid", "hard_swish",
    # softmax family
    "softmax", "log_softmax", "masked_softmax", "masked_log_softmax",
    "softmin",
    # layers
    "fully_connected", "convolution", "deconvolution", "pooling",
    "batch_norm", "layer_norm", "group_norm", "instance_norm", "rms_norm",
    "l2_normalization", "dropout", "embedding", "one_hot", "topk", "pick",
    # special functions
    "gamma", "gammaln", "erf", "erfinv", "digamma", "rsqrt", "rcbrt",
    # indexing and sequences
    "index_add", "index_update", "sequence_mask", "sequence_last",
    "sequence_reverse", "arange_like", "batch_dot", "broadcast_like",
    "shape_array", "reshape_like", "slice_axis", "gather_nd", "scatter_nd",
    "smooth_l1", "boolean_mask", "multi_sum_sq", "all_finite",
    "multi_all_finite", "index_array", "slice", "slice_like",
    # sequence models and heads
    "rnn", "ctc_loss", "multibox_prior", "roi_pooling", "softmax_output",
    "make_loss", "upsampling", "linear_regression_output",
    "mae_regression_output", "logistic_regression_output",
    # attention
    "flash_attention", "decode_attention",
    # control flow, random, framework helpers
    "foreach", "while_loop", "cond", "random", "custom", "waitall",
    "num_gpus", "current_device", "set_np", "reset_np", "is_np_array",
    "is_np_shape"]

# captured before npx.slice shadows the builtin below
_py_slice = builtins.slice


def _c(x):
    """An operand as an NDArray; a Python scalar lifts with jnp's weak
    rule (``numpy._lift``), as the reference's ``apply_op`` hands it to
    jnp."""
    from ..numpy import _lift
    return None if x is None else _lift(x)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def activation(data, act_type="relu", **kwargs):
    """``ops.nn.activation``'s table: ``relu``, ``sigmoid``,
    ``log_sigmoid``, ``tanh``, ``softrelu``, ``softsign``, ``mish``,
    ``relu6``, ``gelu``, ``silu``/``swish``."""
    return apply_op(lambda x: _nn.activation(x, act_type), _c(data),
                    name=f"activation_{act_type}")


def _mkact(act_type, name):
    def f(data, **kwargs):
        return activation(data, act_type)
    f.__name__ = name
    return f


relu = _mkact("relu", "relu")
sigmoid = _mkact("sigmoid", "sigmoid")
log_sigmoid = _mkact("log_sigmoid", "log_sigmoid")
softsign = _mkact("softsign", "softsign")
softplus = _mkact("softrelu", "softplus")
mish = _mkact("mish", "mish")
silu = _mkact("silu", "silu")


def gelu(data, approximate=False, **kwargs):
    """Exact (erf) GELU, or its tanh approximation."""
    return apply_op(lambda x: F.gelu(float_input(x), approximate="tanh"
                                     if approximate else "none"),
                    _c(data), name="gelu")


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kwargs):
    """``ops.nn.leaky_relu``: ``leaky``, ``prelu`` (``gamma`` per
    channel), ``elu``, ``selu``, ``gelu``, ``gelu_tanh``, ``silu``."""
    args = (_c(data),) if gamma is None else (_c(data), _c(gamma))
    return apply_op(lambda x, *g: _nn.leaky_relu(
        x, g[0] if g else None, act_type=act_type, slope=slope),
        *args, name="leaky_relu")


def hard_sigmoid(data, alpha=0.2, beta=0.5, **kwargs):
    return apply_op(lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0),
                    _c(data), name="hard_sigmoid")


def hard_swish(data, **kwargs):
    return apply_op(lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0),
                    _c(data), name="hard_swish")


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


def masked_softmax(data, mask=None, axis=-1, temperature=1.0, **kwargs):
    """Softmax with no mass where ``mask`` is false."""
    if mask is None:
        return softmax(data, axis=axis, temperature=temperature)
    return apply_op(lambda x, m: _nn.masked_softmax(
        x, m.to(torch.bool), axis=axis, temperature=temperature),
        _c(data), _c(mask), name="masked_softmax")


def masked_log_softmax(data, mask=None, axis=-1, temperature=1.0,
                       **kwargs):
    """Log-softmax over the unmasked positions, -inf (-1e30 for bf16) at
    the masked ones."""
    if mask is None:
        return log_softmax(data, axis=axis, temperature=temperature)

    def f(x, m):
        m = m.to(torch.bool)
        neg = -1e30 if x.dtype == torch.bfloat16 else float("-inf")
        x = torch.where(m, x, neg)
        if temperature != 1.0:
            x = x / temperature
        return torch.where(m, torch.log_softmax(float_input(x), dim=axis),
                           neg)
    return apply_op(f, _c(data), _c(mask), name="masked_log_softmax")


def softmin(data, axis=-1, **kwargs):
    return apply_op(lambda x: _nn.softmin(x, axis=axis), _c(data),
                    name="softmin")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kwargs):
    """``x @ weight.T + bias``, weight (num_hidden, in_units)."""
    if no_bias or bias is None:
        return apply_op(lambda a, w: _nn.fully_connected(a, w, None, flatten),
                        _c(x), _c(weight), name="fully_connected")
    return apply_op(lambda a, w, b: _nn.fully_connected(a, w, b, flatten),
                    _c(x), _c(weight), _c(bias), name="fully_connected")


def convolution(data=None, weight=None, bias=None, kernel=None, stride=1,
                dilate=1, pad=0, num_filter=1, num_group=1, no_bias=False,
                layout="NCHW", **kwargs):
    """``ops.nn.convolution``: 1-3 spatial dims, ``NC*`` or ``N*C``."""
    args = (_c(data), _c(weight))
    if not no_bias and bias is not None:
        args += (_c(bias),)
    return apply_op(lambda x, w, *b: _nn.convolution(
        x, w, b[0] if b else None, kernel, stride, dilate, pad, num_group,
        layout), *args, name="convolution")


def deconvolution(data=None, weight=None, bias=None, kernel=None, stride=1,
                  dilate=1, pad=0, adj=0, num_filter=1, num_group=1,
                  no_bias=True, target_shape=None, layout="NCHW", **kwargs):
    """``ops.nn.deconvolution`` (no bias unless ``no_bias=False``)."""
    args = (_c(data), _c(weight))
    if not no_bias and bias is not None:
        args += (_c(bias),)
    return apply_op(lambda x, w, *b: _nn.deconvolution(
        x, w, b[0] if b else None, stride, dilate, pad, adj, num_group,
        target_shape, layout), *args, name="deconvolution")


def pooling(data, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, p_value=2, layout="NCHW", **kwargs):
    return apply_op(
        lambda x: _nn.pooling(x, kernel, pool_type, stride, pad, global_pool,
                              pooling_convention, count_include_pad,
                              p_value, layout),
        _c(data), name="pooling")


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1, **kwargs):
    """Batch norm over every axis but ``axis``. Under
    ``autograd.is_training()`` (and without ``use_global_stats``) it
    normalizes by the batch's mean and biased variance and updates
    ``running_mean``/``running_var`` in place, off the tape and in their
    own dtype: ``momentum * old + (1 - momentum) * batch``. Otherwise it
    reads the running statistics. ``fix_gamma`` takes gamma as ones (no
    gradient reaches it); ``output_mean_var`` also returns the
    statistics used."""
    x, gamma, beta = _c(x), _c(gamma), _c(beta)
    if fix_gamma:
        gamma = type(gamma)(torch.ones_like(gamma._data.detach()),
                            ctx=gamma.ctx)
    if _ag.is_training() and not use_global_stats:
        out, mean, var = apply_op(
            lambda a, g, b: _nn.batch_norm_train(a, g, b, axis=axis,
                                                 eps=eps),
            x, gamma, beta, nout=3, name="batch_norm")
        with _ag.pause():
            for stat, new in ((running_mean, mean), (running_var, var)):
                old = stat._data.detach()
                stat._install((momentum * old + (1 - momentum)
                               * new._data.detach()).to(old.dtype))
        return (out, mean, var) if output_mean_var else out
    out = apply_op(
        lambda a, g, b, mm, mv: _nn.batch_norm_inference(
            a, g, b, mm, mv, axis=axis, eps=eps),
        x, gamma, beta, _c(running_mean), _c(running_var), name="batch_norm")
    return (out, running_mean, running_var) if output_mean_var else out


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, **kwargs):
    return apply_op(lambda x, g, b: _nn.layer_norm(x, g, b, axis=axis,
                                                   eps=eps),
                    _c(data), _c(gamma), _c(beta), name="layer_norm")


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5, **kwargs):
    return apply_op(lambda x, g, b: _nn.group_norm(
        x, g, b, num_groups=num_groups, eps=eps),
        _c(data), _c(gamma), _c(beta), name="group_norm")


def instance_norm(data, gamma, beta, eps=1e-5, **kwargs):
    return apply_op(lambda x, g, b: _nn.instance_norm(x, g, b, eps=eps),
                    _c(data), _c(gamma), _c(beta), name="instance_norm")


def rms_norm(data, gamma, axis=-1, eps=1e-6, **kwargs):
    return apply_op(lambda x, g: _nn.rms_norm(x, g, axis=axis, eps=eps),
                    _c(data), _c(gamma), name="rms_norm")


def l2_normalization(data, eps=1e-10, mode="instance", **kwargs):
    return apply_op(lambda x: _nn.l2_normalization(x, eps=eps, mode=mode),
                    _c(data), name="l2_normalization")


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


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False, **kwargs):
    """Rows of ``weight`` at the indices ``data``."""
    return apply_op(lambda i, w: _nn.embedding(i, w), _c(data), _c(weight),
                    name="embedding")


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32",
            **kwargs):
    """Out-of-range indices give an all-``off_value`` row, as
    ``jax.nn.one_hot`` does."""
    dt = resolve_dtype(dtype)
    return apply_op(lambda i: _one_hot(i, depth, -1, dt)
                    * (on_value - off_value) + off_value, _c(data),
                    name="one_hot")


def topk(data, k=1, axis=-1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kwargs):
    idt = resolve_dtype(dtype)

    def f(x):
        ax = axis % x.dim()
        src = x.dtype
        # torch ranks no uint16/32/64 and no bool: rank their int64
        # (int32) values
        xm = x.movedim(ax, -1)
        if src in WIDE_UNSIGNED:
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
            if src in UNSIGNED:
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
# special functions (an integer input computes in the default float)
# ---------------------------------------------------------------------------
def _gamma(x):
    """Gamma(x) with its sign, as MXNet's ``gamma`` gives it: |Gamma|
    is exp(lgamma), negative on (-1, 0), (-3, -2), ... The reference's
    ``exp(lgamma(x))`` is |Gamma(x)| there (ROADMAP.md, not queued)."""
    neg = (x < 0) & (torch.remainder(torch.ceil(-x), 2) == 1) \
        & (x != torch.floor(x))
    g = torch.exp(torch.lgamma(x))
    return torch.where(neg, -g, g)


def _mkspecial(tfn, name):
    tfn = _float_in(tfn)

    def f(data, **kwargs):
        return apply_op(tfn, _c(data), name=name)
    f.__name__ = name
    return f


gamma = _mkspecial(_gamma, "gamma")
gammaln = _mkspecial(torch.lgamma, "gammaln")
erf = _mkspecial(torch.erf, "erf")
erfinv = _mkspecial(torch.erfinv, "erfinv")
digamma = _mkspecial(torch.digamma, "digamma")
rsqrt = _mkspecial(torch.rsqrt, "rsqrt")
def _rcbrt(x):
    from ..numpy import _cbrt
    return 1.0 / _cbrt(x)


rcbrt = _mkspecial(_rcbrt, "rcbrt")


# ---------------------------------------------------------------------------
# indexing and sequences
# ---------------------------------------------------------------------------
def _coords(i):
    """A (K, ...) coordinate array as K int64 index tensors."""
    return tuple(i.to(torch.int64))


def index_add(data, indices, values, **kwargs):
    """``data`` with ``values`` added at the coordinates ``indices``
    (K, M) over its first K axes; repeated coordinates accumulate.
    uint16/32 data adds in int64 and wraps back."""
    def f(x, i, v):
        src = x.dtype
        wide = src in WIDE_UNSIGNED
        w = x.to(torch.int64) if wide else x
        r = w.index_put(_coords(i), v.to(w.dtype), accumulate=True)
        return r.to(src) if wide else r
    return apply_op(f, _c(data), _c(indices), _c(values), name="index_add")


def _put(x, idx, v):
    """``x`` with ``v`` (in x's type) written at ``idx``; uint16/32 data
    moves as the signed type of its width, which torch writes."""
    v = v.to(x.dtype)
    sv = _SIGNED_VIEW.get(x.dtype)
    if sv is None:
        return x.index_put(idx, v)
    return x.view(sv).index_put(idx, v.view(sv)).view(x.dtype)


def index_update(data, indices, values, **kwargs):
    """``data`` with ``values`` written at the coordinates ``indices``
    (K, M); float coordinates are truncated. Repeated coordinates leave
    an undefined winner, as in the reference."""
    return apply_op(lambda x, i, v: _put(x, _coords(i), v),
                    _c(data), _c(indices), _c(values), name="index_update")


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kwargs):
    if sequence_length is None:
        return apply_op(lambda x: x, _c(data), name="sequence_mask")
    return apply_op(lambda x, ln: _nn.sequence_mask(
        x, ln, use_sequence_length, value, axis),
        _c(data), _c(sequence_length), name="sequence_mask")


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kwargs):
    if sequence_length is None:
        return apply_op(lambda x: _nn.sequence_last(x, None, False, axis),
                        _c(data), name="sequence_last")
    return apply_op(lambda x, ln: _nn.sequence_last(
        x, ln, use_sequence_length, axis),
        _c(data), _c(sequence_length), name="sequence_last")


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **kwargs):
    if sequence_length is None:
        return apply_op(lambda x: _nn.sequence_reverse(x, None, False, axis),
                        _c(data), name="sequence_reverse")
    return apply_op(lambda x, ln: _nn.sequence_reverse(
        x, ln, use_sequence_length, axis),
        _c(data), _c(sequence_length), name="sequence_reverse")


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, **kwargs):
    """``start + step * arange(n)`` in the data's type (float32 for an
    integer one), shaped like the data, or along ``axis``."""
    def f(x):
        n = x.numel() if axis is None else x.shape[axis]
        r = start + step * torch.arange(n, device=x.device).to(x.dtype)
        return r.reshape(x.shape) if axis is None else r
    return apply_op(f, _c(data), name="arange_like")


def batch_dot(a, b, transpose_a=False, transpose_b=False,
              forward_stype="default", **kwargs):
    """Batched matrix product over the leading dims (an integer product
    exact, as ``np.matmul``'s)."""
    from ..numpy import _matmul

    def fn(x, y):
        if transpose_a:
            x = x.transpose(-1, -2)
        if transpose_b:
            y = y.transpose(-1, -2)
        return _matmul(x, y)
    return apply_op(fn, _c(a), _c(b), name="batch_dot")


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None, **kwargs):
    return apply_op(lambda a, b: torch.broadcast_to(a, b.shape), _c(lhs),
                    _c(rhs), name="broadcast_like")


def shape_array(data, **kwargs):
    from ..numpy import array
    return array(onp.asarray(_c(data).shape), dtype=onp.int64)


def reshape_like(lhs, rhs, **kwargs):
    return apply_op(lambda a, b: a.reshape(b.shape), _c(lhs), _c(rhs),
                    name="reshape_like")


def slice_axis(data, axis, begin, end, **kwargs):
    return _c(data).slice_axis(axis, begin, end)


def gather_nd(data, indices, **kwargs):
    """``data[indices[0], indices[1], ...]``: (K, ...) coordinates over
    the first K axes."""
    return apply_op(lambda x, i: _signed_view(lambda t: t[_coords(i)])(x),
                    _c(data), _c(indices), name="gather_nd")


def scatter_nd(data, indices, shape, **kwargs):
    """Zeros of ``shape`` with ``data`` written at the coordinates
    ``indices``."""
    shape = tuple(int(s) for s in shape)

    return apply_op(lambda d, i: _put(torch.zeros(shape, dtype=d.dtype,
                                                  device=d.device),
                                      _coords(i), d),
                    _c(data), _c(indices), name="scatter_nd")


def smooth_l1(data, scalar=1.0, **kwargs):
    """``0.5 (s x)^2`` where ``|x| < 1 / s^2``, else ``|x| - 0.5 / s^2``
    (float32 for an integer input)."""
    s2 = scalar * scalar

    def f(x):
        if x.dtype == torch.bool or x.dtype in WIDE_UNSIGNED:
            x = x.to(torch.int64)      # torch's abs takes neither
        return torch.where(torch.abs(x) < 1.0 / s2,
                           0.5 * s2 * torch.square(x),
                           torch.abs(x) - 0.5 / s2)
    return apply_op(f, _c(data), name="smooth_l1")


def boolean_mask(data, index, axis=0, **kwargs):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    The output's shape depends on the data: the mask's positions come
    to the host once (``nonzero``), as in the reference."""
    keep = torch.nonzero(_c(index)._data.detach().to(torch.bool)).reshape(-1)
    return apply_op(lambda x: _signed_view(
        lambda t: t.index_select(axis, keep.to(t.device)))(x),
        _c(data), name="boolean_mask")


def multi_sum_sq(*arrays, num_arrays=None, **kwargs):
    """Each array's sum of squares, in float32, as one (n,) array."""
    return apply_op(lambda *xs: torch.stack(
        [x.to(torch.float32).square().sum() for x in xs]),
        *[_c(a) for a in arrays], name="multi_sum_sq")


def all_finite(data, init_output=True, **kwargs):
    """1.0 where every element is finite, else 0.0 (float32)."""
    return apply_op(lambda x: torch.isfinite(x).all().to(torch.float32),
                    _c(data), name="all_finite")


def multi_all_finite(*arrays, num_arrays=None, init_output=True, **kwargs):
    return apply_op(lambda *xs: torch.stack(
        [torch.isfinite(x).all() for x in xs]).all().to(torch.float32),
        *[_c(a) for a in arrays], name="multi_all_finite")


def index_array(data, axes=None, **kwargs):
    """Each element's multi-index (int32), its last axis the
    coordinates (of ``axes`` only, where given)."""
    def f(x):
        grids = torch.meshgrid(*[torch.arange(n, device=x.device)
                                 for n in x.shape], indexing="ij")
        idx = torch.stack(grids, dim=-1)
        if axes is not None:
            idx = idx[..., list(axes)]
        return idx.to(torch.int32)
    return apply_op(f, _c(data), name="index_array")


def slice(data, begin, end, step=None, **kwargs):  # noqa: A001
    """Per-axis ``begin:end:step`` (None for the whole extent; a
    negative step reverses)."""
    d = _c(data)
    nd = d.ndim
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step or ()) + (None,) * (nd - len(step or ()))
    return d[tuple(_py_slice(b, e, s) for b, e, s in zip(begin, end, step))]


def slice_like(data, shape_like, axes=None, **kwargs):
    """``data`` cut to ``shape_like``'s extents on ``axes`` (all by
    default)."""
    d, ref = _c(data), _c(shape_like)
    axes = set(range(d.ndim) if axes is None
               else (a % d.ndim for a in axes))
    return d[tuple(_py_slice(0, ref.shape[a]) if a in axes
                   else _py_slice(None) for a in range(d.ndim))]


# ---------------------------------------------------------------------------
# sequence models, losses and legacy heads
# ---------------------------------------------------------------------------
def rnn(data, parameters, *args, use_sequence_length=False, state_size=None,
        projection_size=None, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=True, mode="lstm",
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False, **kwargs):
    """Fused multi-layer RNN/LSTM/GRU over the flat parameter vector
    (``ops.nn.rnn``). ``args`` = state[, state_cell][, sequence_length].
    Returns [output, h_n(, c_n)] with ``state_outputs``, else the
    output. Inter-layer dropout runs under ``autograd.is_training()``."""
    args = list(args)
    seq_len = _c(args.pop()) if use_sequence_length else None
    op_args = [_c(data), _c(parameters), _c(args[0])]
    if mode == "lstm":
        op_args.append(_c(args[1]))
    if seq_len is not None:
        op_args.append(seq_len)
    train = _ag.is_training()
    gen = generator(op_args[0]._data.device) if train and p > 0.0 else None

    def fn(d, prm, st, *rest):
        rest = list(rest)
        st_c = rest.pop(0) if mode == "lstm" else None
        return _nn.rnn(
            d, prm, st, state_cell=st_c,
            sequence_length=rest[0] if rest else None, mode=mode,
            state_size=state_size, num_layers=num_layers,
            bidirectional=bidirectional, p=p, generator=gen, train=train,
            projection_size=projection_size,
            lstm_state_clip_min=lstm_state_clip_min,
            lstm_state_clip_max=lstm_state_clip_max,
            lstm_state_clip_nan=lstm_state_clip_nan)

    outs = apply_op(fn, *op_args, nout=3 if mode == "lstm" else 2,
                    name=f"rnn_{mode}")
    return list(outs) if state_outputs else outs[0]


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **kwargs):
    """Per-sequence CTC loss (the negative log-likelihood). data: (T, N,
    C) unnormalized activations; label: (N, L) classes. ``blank_label``
    ``'first'``: class 0 is the blank and, without ``label_lengths``, a
    0 label is padding (at the end of a row); ``'last'``: the blank is
    C - 1, rotated to 0 with the labels shifted up, as in the
    reference, and ``label_lengths`` are required. The forward
    recursion is ATen's ``ctc_loss`` on the log-softmax."""
    if blank_label not in ("first", "last"):
        raise ValueError(f"blank_label must be 'first' or 'last', "
                         f"got {blank_label!r}")
    if blank_label == "last" and not use_label_lengths:
        raise ValueError("blank_label='last' requires "
                         "use_label_lengths=True with label_lengths")
    args = [_c(data), _c(label)]
    if use_data_lengths:
        args.append(_c(data_lengths))
    if use_label_lengths:
        args.append(_c(label_lengths))

    def fn(x, labels, *lens):
        lens = list(lens)
        t, n = x.shape[0], x.shape[1]
        labels = labels.to(torch.int64)
        dl = lens.pop(0).to(torch.int64) if use_data_lengths else \
            torch.full((n,), t, dtype=torch.int64, device=x.device)
        if blank_label == "last":
            x = torch.cat([x[..., -1:], x[..., :-1]], dim=-1)
            labels = labels + 1
        ll = lens.pop(0).to(torch.int64) if use_label_lengths else \
            (labels != 0).sum(1)
        logp = torch.log_softmax(float_input(x), dim=-1)
        return F.ctc_loss(logp, labels, dl, ll, blank=0, reduction="none")
    return apply_op(fn, *args, name="ctc_loss")


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kwargs):
    """SSD anchor boxes over a (N, C, H, W) feature map: (1, H*W*K, 4)
    normalized corners, one box per (size_i, ratio_0) and one per
    (size_0, ratio_j > 0) at each pixel."""
    d = _c(data)
    h, w = d.shape[2], d.shape[3]
    sizes = [float(s) for s in sizes]
    ratios = [float(r) for r in ratios]
    step_y = 1.0 / h if steps[0] <= 0 else float(steps[0])
    step_x = 1.0 / w if steps[1] <= 0 else float(steps[1])
    oy, ox = float(offsets[0]), float(offsets[1])
    wh = [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
          for s in sizes]
    wh += [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
           for r in ratios[1:]]

    def fn(x):
        f32 = dict(dtype=torch.float32, device=x.device)
        cy = (torch.arange(h, **f32) + oy) * step_y
        cx = (torch.arange(w, **f32) + ox) * step_x
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        out = torch.stack([torch.stack([cxg - bw / 2, cyg - bh / 2,
                                        cxg + bw / 2, cyg + bh / 2], -1)
                           for bw, bh in wh], 2).reshape(-1, 4)
        return (torch.clamp(out, 0.0, 1.0) if clip else out)[None]
    return apply_op(fn, d, name="multibox_prior")


def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
                **kwargs):
    """ROI max pooling: data (N, C, H, W), rois (R, 5) rows [batch, x1,
    y1, x2, y2] in image coordinates (times ``spatial_scale`` on the
    map); returns (R, C, ph, pw), an empty bin 0. Each bin is a masked
    max over the map, along W then H."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    ph, pw = int(ph), int(pw)

    def fn(x, rr):
        H, W = x.shape[2], x.shape[3]
        f32 = dict(dtype=torch.float32, device=x.device)
        r = rr.to(torch.float32)
        x1, y1, x2, y2 = (torch.round(r[:, k] * spatial_scale)
                          for k in (1, 2, 3, 4))
        bh = torch.clamp(y2 - y1 + 1.0, min=1.0) / ph
        bw = torch.clamp(x2 - x1 + 1.0, min=1.0) / pw

        def bins(lo, size, n, extent):
            i = torch.arange(n, **f32)
            start = torch.floor(lo[:, None] + i * size[:, None])
            stop = torch.ceil(lo[:, None] + (i + 1) * size[:, None])
            pos = torch.arange(extent, **f32)
            return (pos >= start[..., None]) & (pos < stop[..., None])
        rows = bins(y1, bh, ph, H)                   # (R, ph, H)
        cols = bins(x1, bw, pw, W)                   # (R, pw, W)
        feat = x[r[:, 0].to(torch.int64)].to(torch.float32)  # (R, C, H, W)
        neg = torch.tensor(float("-inf"), **f32)
        t = torch.where(cols[:, None, None], feat[:, :, :, None], neg) \
            .amax(-1)                                # (R, C, H, pw)
        t = torch.where(rows[:, None, :, :, None], t[:, :, None], neg) \
            .amax(3)                                 # (R, C, ph, pw)
        return torch.where(torch.isfinite(t), t, torch.zeros_like(t)) \
            .to(torch.promote_types(x.dtype, torch.float32))
    return apply_op(fn, _c(data), _c(rois), name="roi_pooling")


def _one_hot(lab, n, axis, dtype):
    """``lab``'s classes one-hot along a new ``axis`` of ``n``; a class
    out of range gives a row of zeros, as ``jax.nn.one_hot`` does."""
    ax = axis % (lab.dim() + 1)
    shape = [1] * (lab.dim() + 1)
    shape[ax] = n
    return (lab.to(torch.int64).unsqueeze(ax) == torch.arange(
        n, device=lab.device).reshape(shape)).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward ``(p - onehot(label)) * grad_scale``
    (smoothed, ignored labels zeroed, normalized), the head gradient
    ignored: the reference's ``custom_vjp`` rule."""

    @staticmethod
    def forward(ctx, x, lab, opts):
        ctx.save_for_backward(x, lab)
        ctx.opts = opts
        xv, axis = _SoftmaxOutput.view(x, opts)
        return torch.softmax(xv, dim=axis).reshape(x.shape)

    @staticmethod
    def view(x, opts):
        if opts["multi_output"]:
            return x, 1
        if opts["preserve_shape"] or x.dim() <= 2:
            return x, -1
        return x.reshape(x.shape[0], -1), -1

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        o = ctx.opts
        xv, axis = _SoftmaxOutput.view(x, o)
        p = torch.softmax(xv, dim=axis)
        n_class = p.shape[axis]
        oh = _one_hot(lab, n_class, axis, p.dtype)
        sa = o["smooth_alpha"]
        if sa > 0.0:
            oh = oh * (1.0 - sa) + (sa / max(n_class - 1, 1)) * (1.0 - oh)
        grad = (p - oh) * o["grad_scale"]
        valid = None
        if o["use_ignore"]:
            valid = lab.to(p.dtype) != o["ignore_label"]
            grad = torch.where(valid.unsqueeze(axis % p.dim()), grad,
                               torch.zeros_like(grad))
        if o["normalization"] == "batch":
            grad = grad / p.shape[0]
        elif o["normalization"] == "valid":
            denom = valid.sum() if valid is not None else \
                torch.tensor(lab.numel(), device=p.device)
            grad = grad / torch.clamp(denom, min=1).to(p.dtype)
        return grad.reshape(x.shape), None, None


def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0, **kwargs):
    """Legacy softmax + cross-entropy head: softmax over the class axis
    (1 with ``multi_output``, the last otherwise, the data flattened to
    (N, -1) unless ``preserve_shape``); its backward to the data is
    ``(p - onehot(label)) * grad_scale``, the head gradient ignored.
    ``use_ignore`` zeroes rows whose label is ``ignore_label``;
    ``normalization`` ``'batch'``/``'valid'`` divides by the batch size
    or the count of labels kept."""
    opts = dict(grad_scale=float(grad_scale),
                ignore_label=float(ignore_label),
                use_ignore=bool(use_ignore),
                normalization=str(normalization),
                smooth_alpha=float(smooth_alpha),
                multi_output=bool(multi_output),
                preserve_shape=bool(preserve_shape))
    return apply_op(lambda x, lab: _SoftmaxOutput.apply(x, lab, opts),
                    _c(data), _c(label), name="softmax_output")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; backward ``grad_scale`` per element (over the
    batch size or the count above ``valid_thresh``), the head gradient
    ignored."""

    @staticmethod
    def forward(ctx, x, gs, vt, norm):
        ctx.save_for_backward(x)
        ctx.opts = (gs, vt, norm)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gs, vt, norm = ctx.opts
        grad = torch.full_like(x, gs)
        if norm == "batch":
            grad = grad / x.shape[0]
        elif norm == "valid":
            grad = grad / torch.clamp((x > vt).sum(), min=1).to(x.dtype)
        return grad, None, None, None


def make_loss(data, grad_scale=1.0, valid_thresh=0.0,
              normalization="null", **kwargs):
    """Legacy loss-head marker: the identity, whose gradient is
    ``grad_scale`` per element (``'batch'``: over the batch size;
    ``'valid'``: over the count of elements above ``valid_thresh``)."""
    return apply_op(lambda x: _MakeLoss.apply(x, float(grad_scale),
                                              float(valid_thresh),
                                              str(normalization)),
                    _c(data), name="make_loss")


def upsampling(*data, scale=1, num_filter=0, sample_type="nearest",
               multi_input_mode="concat", num_args=None, workspace=None,
               **kwargs):
    """Spatial upsampling, NCHW. ``nearest`` repeats pixels, bringing
    every input to the first one's size times ``scale``, then
    concatenates them on the channel axis (or sums them, ``'sum'``).
    ``bilinear`` takes (data, weight) and is a grouped deconvolution,
    kernel 2 scale - scale % 2, stride scale, pad ceil((scale - 1) / 2),
    one group a channel."""
    s = int(scale)
    if sample_type == "bilinear":
        if len(data) != 2:
            raise ValueError("bilinear UpSampling takes (data, weight)")
        d, w = data
        k = 2 * s - s % 2
        p = int(math.ceil((s - 1) / 2))
        return deconvolution(d, w, kernel=(k, k), stride=(s, s),
                             pad=(p, p), num_filter=num_filter,
                             num_group=num_filter, no_bias=True)
    if sample_type != "nearest":
        raise ValueError(f"unsupported sample_type {sample_type!r}")
    first = _c(data[0])
    out_h, out_w = first.shape[-2] * s, first.shape[-1] * s

    def up_to(x):
        rh, rw = out_h // x.shape[-2], out_w // x.shape[-1]
        return x.repeat_interleave(rh, dim=-2).repeat_interleave(rw, dim=-1)

    outs = [apply_op(up_to, _c(d), name="upsampling") for d in data]
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    from ..numpy import concatenate
    return concatenate(outs, axis=1)


class _Regression(torch.autograd.Function):
    """The link function forward; backward ``grad_fn(link(x), label) *
    grad_scale / (elements per sample)``, the label shaped like the
    data, the head gradient ignored."""

    @staticmethod
    def forward(ctx, x, lab, link, grad_fn, gs):
        ctx.save_for_backward(x, lab)
        ctx.opts = (link, grad_fn, gs)
        return link(x)

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        link, grad_fn, gs = ctx.opts
        num_output = max(lab.numel() // lab.shape[0], 1) \
            if lab.dim() > 0 else 1
        lab = lab.to(x.dtype).reshape(x.shape)
        return grad_fn(link(x), lab) * (gs / num_output), None, None, None, \
            None


def _regression_output(name, link, grad_fn):
    def op(data, label, grad_scale=1.0, **kwargs):
        return apply_op(lambda x, lab: _Regression.apply(
            x, lab, link, grad_fn, float(grad_scale)),
            _c(data), _c(label), name=name)
    op.__name__ = name
    op.__doc__ = (f"Legacy {name} head: the forward applies the link "
                  "function, the backward injects the regression gradient "
                  "(scaled by grad_scale over the elements per sample), "
                  "ignoring the head gradient.")
    return op


linear_regression_output = _regression_output(
    "linear_regression_output", lambda x: x.clone(), lambda p, l: p - l)
mae_regression_output = _regression_output(
    "mae_regression_output", lambda x: x.clone(),
    lambda p, l: torch.sign(p - l))
logistic_regression_output = _regression_output(
    "logistic_regression_output", torch.sigmoid, lambda p, l: p - l)


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


def decode_attention(query, key, value, lengths, scale=None):
    """Single-query attention against a preallocated (B, H, S_max, D)
    KV cache with per-slot valid lengths (the decode hot path): K2 on
    the card, the instance of the cache's type (fp32, bf16, float16),
    its plain version on the CPU (``ops.attention.decode_attention``).
    ``lengths`` (B,) counts each slot's valid keys; it is taken as
    int32."""
    from ..ops import attention as _att

    def fn(q, k, v, ln):
        return _att.decode_attention(q, k, v,
                                     ln.to(torch.int32).contiguous(),
                                     scale=scale)

    return apply_op(fn, _c(query), _c(key), _c(value), _c(lengths),
                    name="decode_attention")


def ring_attention(query, key, value, causal=False, scale=None,
                   axis_name="sp", mesh=None):
    """Sequence-parallel ring attention: waits for the port's
    parallelism (ROADMAP.md queue 1, item 20)."""
    raise not_ported("npx.ring_attention", 20)


def load(fname):
    raise not_ported("npx.load", 18)


def save(fname, data):
    raise not_ported("npx.save", 18)


# control flow (npx.foreach / while_loop / cond) lives in its own module
from .control_flow import foreach, while_loop, cond  # noqa: E402,F401


# the contrib operators (detection, warping, ROI, resize, sliding-window
# attention, ...) live in their own module
from .contrib_ops import (  # noqa: E402,F401
    interleaved_matmul_selfatt_qk, interleaved_matmul_selfatt_valatt,
    interleaved_matmul_encdec_qk, interleaved_matmul_encdec_valatt,
    div_sqrt_dim, box_iou, box_nms, box_encode, box_decode,
    bipartite_matching, multibox_target, multibox_detection,
    lrn, adaptive_avg_pool2d, bilinear_resize2d,
    depth_to_space, space_to_depth, im2col, col2im,
    moments, khatri_rao, index_copy, quadratic, stop_gradient,
    constraint_check,
    sldwin_atten_score, sldwin_atten_mask_like, sldwin_atten_context,
    roi_align, hawkesll, rroi_align, identity_attach_kl_sparse_reg,
    grid_generator, bilinear_sampler, spatial_transformer,
    correlation, count_sketch, proposal, multi_proposal,
    deformable_convolution, deformable_psroi_pooling,
    modulated_deformable_convolution,
)
from . import contrib_ops as _contrib  # noqa: E402

__all__ += _contrib.__all__
