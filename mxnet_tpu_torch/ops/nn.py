"""Neural-network operators over plain tensors (the port of
``mxnet_tpu/ops/nn.py``).

The fully-connected layer, N-d convolution and transposed convolution
(``NC*`` and ``N*C`` layouts, groups, dilation), pooling (max, avg, sum,
lp; the ``valid``/``full``/``same`` conventions), batch, layer, group,
instance, L2 and RMS normalization, the activations and softmaxes of
``mx.npx``, dropout, the embedding lookup, the sequence ops and the
fused multi-layer RNN/LSTM/GRU over the reference's flat parameter
vector. The reference lowers all of them to XLA outside any Pallas
kernel, so here they are ATen calls and plain PyTorch: the convolutions
go to cuDNN on the card.

Functions are pure, as in the reference: the callers in ``npx`` and
``gluon`` thread state (BatchNorm running statistics, dropout's
generator). Normalization statistics accumulate in fp32 for 16-bit
inputs (``accum_dtype``) and the output returns in the input's type.
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as onp
import torch
import torch.nn.functional as F

from ..amp import cast_args as _amp
from ..base import WIDE_UNSIGNED, bool_route, float_input, int64_route

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "accum_dtype", "batch_norm_train", "batch_norm_inference",
           "layer_norm", "group_norm", "instance_norm", "l2_normalization",
           "rms_norm", "gelu", "activation", "leaky_relu", "masked_softmax",
           "softmin", "embedding", "dropout", "sequence_mask",
           "sequence_last", "sequence_reverse", "rnn_param_size", "rnn",
           "fp32_matmul", "AMP_CAST_AT_ENTRY"]

#: the AMP lists' op names whose casts the entry points of this module
#: apply themselves (``amp.cast_args``), for the Gluon layers that call
#: them on tensors; ``apply_op`` leaves these names alone
AMP_CAST_AT_ENTRY = frozenset({
    "fully_connected", "convolution", "deconvolution", "batch_norm",
    "layer_norm", "group_norm", "instance_norm", "l2_normalization",
    "masked_softmax"})


def _tuplize(v, n):
    if isinstance(v, (int, onp.integer)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    return t * n if len(t) == 1 else t


# ---------------------------------------------------------------------------
# dense / conv / pooling
# ---------------------------------------------------------------------------
def fully_connected(x, weight, bias=None, flatten=True):
    """y = x @ W^T + b, weight layout (out_units, in_units). Operands of
    two float types promote as jnp promotes them (an fp32 activation
    against a bf16 weight computes in fp32)."""
    x, weight, bias = _amp("fully_connected", x, weight, bias)
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    return F.linear(x.to(dt), weight.to(dt), bias)


#: held while a convolution has cuDNN's process-wide TF32 switch off
_tf32_lock = threading.Lock()


@contextlib.contextmanager
def _fp32_products(on_card):
    """cuDNN and cuBLAS without TF32 on the card: an fp32 convolution
    or product rounds as the reference's fp32 ``lax.conv`` or
    ``einsum`` does, whatever the process's
    ``torch.backends.cudnn.allow_tf32`` (``cuda.matmul.allow_tf32``)
    says. Each switch is
    process-wide, so it is turned off and restored under a lock: two
    threads' convolutions (the backward runs on autograd's device
    thread) never interleave the save and the restore. A cuDNN call
    of another thread that is not this module's may run without TF32
    while the switch is off."""
    if not on_card:
        yield
        return
    with _tf32_lock:
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev


class _Fp32Matmul(torch.autograd.Function):
    """``torch.matmul`` of two float tensors (batch dims broadcast)
    whose forward and backward both run without TF32 on the card
    (``_fp32_products`` covers cuBLAS's switch too): the reference's
    fp32 products outside Pallas (``jnp.einsum``) round as fp32 ones."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _fp32_products(a.is_cuda):
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _fp32_products(g.is_cuda):
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.mT).sum_to_size(a.shape)
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.mT, g).sum_to_size(b.shape)
        return ga, gb


def fp32_matmul(a, b):
    """``a @ b`` (both at least 2-d) of two float tensors of one type,
    with no TF32 on the card in either pass."""
    return _Fp32Matmul.apply(a, b)


class _Conv(torch.autograd.Function):
    """``aten.convolution`` (direct or transposed) whose forward and
    backward both run without TF32 (``_fp32_products``): the backward
    runs when ``backward()`` is called, outside any scope the forward
    could set."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, transposed, adj, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, pad, dilate, transposed, adj, groups)
        with _fp32_products(x.is_cuda):
            return torch.ops.aten.convolution(x, w, None, stride, pad,
                                              dilate, transposed, adj,
                                              groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, dilate, transposed, adj, groups = ctx.args
        with _fp32_products(g.is_cuda):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, stride, pad, dilate, transposed,
                adj, groups, [ctx.needs_input_grad[0],
                              ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None, None, None


def _add_bias(y, bias, channel_last, nsp):
    if bias is None:
        return y
    return y + (bias if channel_last
                else bias.reshape((1, -1) + (1,) * nsp))


def convolution(x, weight, bias=None, kernel=None, stride=1, dilate=1, pad=0,
                num_group=1, layout="NCHW"):
    """N-d convolution (cross-correlation, 1-3 spatial dims), symmetric
    ``pad``. The weight layout is the reference's: ``(O, I/g, *k)`` for
    ``NC*`` layouts and ``(O, *k, I/g)`` for ``N*C`` ones. fp32 products
    are exact fp32 (no TF32), forward and backward."""
    x, weight, bias = _amp("convolution", x, weight, bias)
    nsp = x.dim() - 2
    channel_last = not layout.startswith("NC")
    if channel_last:
        x, weight = x.movedim(-1, 1), weight.movedim(-1, 1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = _Conv.apply(x.to(dt), weight.to(dt), _tuplize(stride, nsp),
                    _tuplize(pad, nsp), _tuplize(dilate, nsp), False,
                    (0,) * nsp, int(num_group))
    if channel_last:
        y = y.movedim(1, -1)
    return _add_bias(y, bias, channel_last, nsp)


def deconvolution(x, weight, bias=None, stride=1, dilate=1, pad=0, adj=0,
                  num_group=1, target_shape=None, layout="NCHW"):
    """Transposed convolution, the gradient of ``convolution``: each
    input pixel scatters the unflipped kernel. The weight layout is the
    reference's: ``(I, O/g, *k)`` for ``NC*`` layouts, ``(I, *k, O/g)``
    for ``N*C`` ones. The output's extent is ``(in - 1) * stride - 2 *
    pad + dilate * (k - 1) + 1 + adj``; ``target_shape`` is accepted and
    not applied, as in the reference. fp32 products are exact fp32."""
    x, weight, bias = _amp("deconvolution", x, weight, bias)
    nsp = x.dim() - 2
    channel_last = not layout.startswith("NC")
    if channel_last:
        x, weight = x.movedim(-1, 1), weight.movedim(-1, 1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    y = _Conv.apply(x.to(dt), weight.to(dt), _tuplize(stride, nsp),
                    _tuplize(pad, nsp), _tuplize(dilate, nsp), True,
                    _tuplize(adj, nsp), int(num_group))
    if channel_last:
        y = y.movedim(1, -1)
    return _add_bias(y, bias, channel_last, nsp)


def _windows(x, kernel, stride, pads, fill):
    """x (N, C, *spatial) padded by ``pads`` ((lo, hi) per spatial dim)
    with ``fill``, as (N, C, *out, *kernel) windows (a strided view)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if any(flat):
        x = F.pad(x, flat, value=fill)
    for i, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + i, k, s)
    return x


def _pool_pads(shape, kernel, stride, pad, convention):
    """(lo, hi) padding of each spatial dim: symmetric ``pad`` for
    ``valid``; ``full`` adds to the high side what a ceil'd output needs;
    ``same`` splits ``ceil(in / s)`` outputs' need, the extra on the high
    side."""
    pads = []
    for n, k, s, p in zip(shape, kernel, stride, pad):
        if convention == "full":
            out = int(math.ceil((n + 2 * p - k) / s)) + 1
            pads.append((p, max((out - 1) * s + k - n - p, p)))
        elif convention == "same":
            total = max((int(math.ceil(n / s)) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        else:
            pads.append((p, p))
    return pads


def pooling(x, kernel=1, pool_type="max", stride=None, pad=0,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, p_value=2, layout="NCHW"):
    """Pooling over 1-3 spatial dims. ``max`` pads with -inf (an integer
    input with its type's minimum); ``avg`` divides by the whole
    kernel's size with ``count_include_pad``, else by the count of real
    elements in each window; ``lp`` is ``(sum |x|^p)^(1/p)``. Windows are
    strided views of the padded input (``unfold``), reduced in the
    input's type; ``avg`` of integers gives the default float."""
    nsp = x.dim() - 2
    channel_last = not layout.startswith("NC")
    if channel_last:
        x = x.movedim(-1, 1)
    src = x.dtype
    floating = x.is_floating_point()
    fill = float("-inf") if floating else 0 if src == torch.bool \
        else int(torch.iinfo(src).min)
    if src in WIDE_UNSIGNED:
        # torch pads and reduces no uint16/32: pool their int64 values
        y = pooling(x.to(torch.int64), kernel, pool_type, stride, pad,
                    global_pool, pooling_convention, count_include_pad,
                    p_value)
        y = y.to(src) if y.dtype == torch.int64 else y
        return y.movedim(1, -1) if channel_last else y
    if global_pool:
        dims = tuple(range(2, 2 + nsp))
        if pool_type == "max":
            y = x.amax(dim=dims, keepdim=True)
        elif pool_type == "avg":
            y = float_input(x).mean(dim=dims, keepdim=True)
        elif pool_type == "sum":
            y = x.sum(dim=dims, keepdim=True, dtype=x.dtype)
        else:
            y = x.abs().pow(p_value).sum(dim=dims, keepdim=True) \
                .pow(1.0 / p_value)
        return y.movedim(1, -1) if channel_last else y
    kernel = _tuplize(kernel, nsp)
    stride = _tuplize(stride if stride is not None else kernel, nsp)
    pads = _pool_pads(x.shape[2:], kernel, stride, _tuplize(pad, nsp),
                      pooling_convention)
    wdims = tuple(range(-nsp, 0))
    if pool_type == "max":
        y = _windows(x, kernel, stride, pads, fill).amax(dim=wdims)
    elif pool_type in ("avg", "sum"):
        y = _windows(x, kernel, stride, pads, 0).sum(dim=wdims,
                                                     dtype=x.dtype)
        if pool_type == "avg":
            y = float_input(y)
            if count_include_pad:
                y = y / math.prod(kernel)
            else:
                ones = torch.ones((1, 1) + tuple(x.shape[2:]),
                                  dtype=torch.float32, device=x.device)
                cnt = _windows(ones, kernel, stride, pads, 0).sum(dim=wdims)
                y = y / cnt.to(y.dtype)
    elif pool_type == "lp":
        y = _windows(x.abs().pow(p_value), kernel, stride, pads, 0) \
            .sum(dim=wdims).pow(1.0 / p_value)
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    return y.movedim(1, -1) if channel_last else y


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def accum_dtype(dtype):
    """Normalization statistics accumulate in fp32 for 16-bit inputs
    and in the input's own dtype otherwise (fp32 stays put)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _affine(out, gamma, beta, axis, cd):
    shape = [1] * out.dim()
    shape[axis] = out.shape[axis]
    out = out * gamma.to(cd).reshape(shape)
    return out if beta is None else out + beta.to(cd).reshape(shape)


def batch_norm_train(x, gamma, beta, axis=1, eps=1e-5):
    """(out, batch mean, batch variance) over every axis but ``axis``;
    the variance is the biased one. The caller updates the running
    statistics."""
    x, gamma, beta = _amp("batch_norm", x, gamma, beta)
    axis %= x.dim()
    dims = tuple(i for i in range(x.dim()) if i != axis)
    cd = accum_dtype(x.dtype)
    xc = x.to(cd)
    mean = xc.mean(dim=dims)
    var = xc.var(dim=dims, unbiased=False)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    out = (xc - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(shape)
    return _affine(out, gamma, beta, axis, cd).to(x.dtype), mean, var


def batch_norm_inference(x, gamma, beta, moving_mean, moving_var, axis=1,
                         eps=1e-5):
    x, gamma, beta, moving_mean, moving_var = _amp(
        "batch_norm", x, gamma, beta, moving_mean, moving_var)
    axis %= x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    cd = accum_dtype(x.dtype)
    inv = torch.rsqrt(moving_var.to(cd) + eps).reshape(shape)
    out = (x.to(cd) - moving_mean.to(cd).reshape(shape)) * inv
    return _affine(out, gamma, beta, axis, cd).to(x.dtype)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Biased-variance layer norm over ``axis``; the output returns in
    ``x``'s dtype."""
    x, gamma, beta = _amp("layer_norm", x, gamma, beta)
    cd = accum_dtype(x.dtype)
    xc = x.to(cd)
    mean = xc.mean(dim=axis, keepdim=True)
    var = xc.var(dim=axis, unbiased=False, keepdim=True)
    out = (xc - mean) * torch.rsqrt(var + eps)
    return _affine(out, gamma, beta, axis % x.dim(), cd).to(x.dtype)


def _promoted(*ts):
    """The type of the reference's ``out * gamma + beta``: group and
    instance norm return their operands' promoted type."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def group_norm(x, gamma, beta, num_groups=1, eps=1e-5):
    """Layout NC + spatial: statistics over each group of channels and
    the spatial dims; gamma and beta per channel."""
    x, gamma, beta = _amp("group_norm", x, gamma, beta)
    n, c = x.shape[0], x.shape[1]
    cd = accum_dtype(x.dtype)
    xg = x.to(cd).reshape((n, num_groups, c // num_groups)
                          + tuple(x.shape[2:]))
    dims = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=dims, keepdim=True)
    var = xg.var(dim=dims, unbiased=False, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return _affine(out, gamma, beta, 1, cd).to(_promoted(x, gamma, beta))


def instance_norm(x, gamma, beta, eps=1e-5):
    """Layout NC + spatial: statistics over each channel's spatial
    dims."""
    x, gamma, beta = _amp("instance_norm", x, gamma, beta)
    cd = accum_dtype(x.dtype)
    xc = x.to(cd)
    dims = tuple(range(2, x.dim()))
    mean = xc.mean(dim=dims, keepdim=True)
    var = xc.var(dim=dims, unbiased=False, keepdim=True)
    out = (xc - mean) * torch.rsqrt(var + eps)
    return _affine(out, gamma, beta, 1, cd).to(_promoted(x, gamma, beta))


def l2_normalization(x, eps=1e-10, mode="instance"):
    """x / sqrt(sum(x^2) + eps) over all but the batch axis
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``)."""
    (x,) = _amp("l2_normalization", x)
    dims = {"instance": tuple(range(1, x.dim())),
            "channel": (1,)}.get(mode, tuple(range(2, x.dim())))
    x = float_input(x)
    cd = accum_dtype(x.dtype)
    xc = x.to(cd)
    norm = torch.sqrt(xc.square().sum(dim=dims, keepdim=True) + eps)
    return (xc / norm).to(x.dtype)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """x / sqrt(mean(x^2) + eps) * gamma (no centring)."""
    cd = accum_dtype(x.dtype)
    xc = x.to(cd)
    ms = xc.square().mean(dim=axis, keepdim=True)
    return (xc * torch.rsqrt(ms + eps) * gamma.to(cd)).to(
        torch.promote_types(x.dtype, gamma.dtype))


# ---------------------------------------------------------------------------
# activations / softmax
# ---------------------------------------------------------------------------
def gelu(x):
    """Exact (erf) GELU: x * Phi(x)."""
    return F.gelu(x, approximate="none")


_ACTIVATIONS = {
    # bool gives int32, as in the reference; torch takes no uint16/32
    "relu": bool_route(int64_route(torch.relu)),
    "sigmoid": lambda x: torch.sigmoid(float_input(x)),
    "log_sigmoid": lambda x: F.logsigmoid(float_input(x)),
    "tanh": lambda x: torch.tanh(float_input(x)),
    "softrelu": lambda x: F.softplus(float_input(x)),
    "softsign": lambda x: F.softsign(float_input(x)),
    "mish": lambda x: F.mish(float_input(x)),
    "relu6": lambda x: torch.clamp(float_input(x), 0.0, 6.0),
    "gelu": lambda x: gelu(float_input(x)),
    "silu": lambda x: F.silu(float_input(x)),
    "swish": lambda x: F.silu(float_input(x)),
}


def activation(x, act_type):
    """``relu``, ``sigmoid``, ``log_sigmoid``, ``tanh``, ``softrelu``
    (softplus), ``softsign``, ``mish``, ``relu6``, ``gelu`` (erf),
    ``silu``/``swish``; an integer input of a float activation computes
    in the default float."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise ValueError(f"unknown activation {act_type!r}")
    return fn(x)


def leaky_relu(x, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """``leaky`` (slope x below 0), ``prelu`` (a learned ``gamma`` per
    channel, axis 1), ``elu`` (slope (e^x - 1)), ``selu``, ``gelu``,
    ``gelu_tanh`` and ``silu``."""
    if x.dtype in WIDE_UNSIGNED:
        x = x.to(torch.int64)          # torch compares no uint16/32
    if act_type == "leaky":
        return torch.where(x >= 0, x, slope * x)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and g.dim() < x.dim():
            shape = [1] * x.dim()
            if x.dim() > 1:
                shape[1] = g.shape[0]
            g = g.reshape(shape)
        return torch.where(x >= 0, x, g * x)
    x = float_input(x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        return F.selu(x)
    if act_type == "gelu":
        return gelu(x)
    if act_type == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if act_type == "silu":
        return F.silu(x)
    raise ValueError(f"unknown leaky_relu act_type {act_type!r}")


def masked_softmax(x, mask=None, axis=-1, temperature=1.0):
    """Softmax with the positions where ``mask`` is false at -inf
    (-1e30 for bf16), so they get no mass; a row masked whole gives
    NaN, as in the reference."""
    x, mask = _amp("masked_softmax", x, mask)
    if temperature != 1.0:
        x = x / temperature
    if mask is not None:
        x = torch.where(mask, x, -1e30 if x.dtype == torch.bfloat16
                        else float("-inf"))
    return torch.softmax(float_input(x), dim=axis)


def softmin(x, axis=-1):
    return torch.softmax(-float_input(x), dim=axis)


# ---------------------------------------------------------------------------
# dropout / embedding
# ---------------------------------------------------------------------------
def embedding(tokens, weight):
    """Row gather: ``weight[tokens]``."""
    return F.embedding(tokens.long(), weight)


def dropout(x, p, axes=(), generator=None):
    """Inverted dropout (the reference's ``ops.nn.dropout``): keep each
    element with probability ``1 - p`` (a uniform draw below it, as
    ``jax.random.bernoulli`` draws), scaled by ``1 / (1 - p)``, else 0;
    ``axes`` broadcast one draw along them. The draws come from
    ``generator`` and differ from JAX's for the same seed."""
    if p <= 0.0:
        return x
    shape = list(x.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = 1.0 - p
    u = torch.rand(shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# sequences (time-major by default)
# ---------------------------------------------------------------------------
def sequence_mask(x, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``; ``axis``
    (0 or 1) is the time axis, the other of the two the batch axis."""
    if not use_sequence_length or sequence_length is None:
        return x
    idx = torch.arange(x.shape[axis], device=x.device)
    idx = idx.reshape((-1, 1) if axis == 0 else (1, -1))
    ln = sequence_length.reshape((1, -1) if axis == 0 else (-1, 1))
    mask = idx < ln
    mask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))
    return torch.where(mask, x, value)


def sequence_last(x, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return x.select(axis, -1)
    ln = (sequence_length - 1).long()
    xm = x.movedim(axis, 0)
    return xm[ln, torch.arange(xm.shape[1], device=x.device)]


def sequence_reverse(x, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's valid steps reversed, the padding left in
    place."""
    if not use_sequence_length or sequence_length is None:
        return x.flip(axis)
    xm = x.movedim(axis, 0)
    idx = torch.arange(xm.shape[0], device=x.device).reshape(-1, 1)
    ln = sequence_length.reshape(1, -1).long()
    rev = torch.where(idx < ln, ln - 1 - idx, idx)
    rev = rev.reshape(tuple(rev.shape) + (1,) * (xm.dim() - 2)).expand(
        (-1, -1) + tuple(xm.shape[2:]))
    return torch.gather(xm, 0, rev).movedim(0, axis)


# ---------------------------------------------------------------------------
# fused RNN (the reference's flat cuDNN parameter layout)
# ---------------------------------------------------------------------------
# LSTM gates run [i, f, g, o]; GRU gates [r, z, n], linear before reset:
# n = tanh(xn + r * (h @ Wh_n + bh_n)).
_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional,
                   projection_size=None):
    """Length of the flat parameter vector: every layer's and
    direction's i2h and h2h weights and both biases, plus the LSTMP
    projections."""
    g = _RNN_GATES[mode]
    d = 2 if bidirectional else 1
    rec = projection_size if projection_size else state_size
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else rec * d
        size += d * g * state_size * (in_size + rec + 2)
    if projection_size:
        size += projection_size * state_size * num_layers * d
    return size


def _rnn_unpack(params, mode, input_size, state_size, num_layers,
                bidirectional, projection_size=None):
    """The flat vector as per-(layer, direction) weights: every weight
    first (i2h, h2h, then the LSTMP projection), then every bias (i2h,
    h2h)."""
    g = _RNN_GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    rec = projection_size if projection_size else h
    pos = 0
    weights, biases, projs = [], [], []

    def take(n, *shape):
        nonlocal pos
        t = params[pos:pos + n].reshape(shape)
        pos += n
        return t

    for layer in range(num_layers):
        in_size = input_size if layer == 0 else rec * d
        for _ in range(d):
            wi = take(g * h * in_size, g * h, in_size)
            wh = take(g * h * rec, g * h, rec)
            weights.append((wi, wh))
            if projection_size:
                projs.append(take(rec * h, rec, h))
    for _ in range(num_layers * d):
        biases.append((take(g * h, g * h), take(g * h, g * h)))
    return weights, biases, projs


def _rnn_layer_scan(mode, xp, bh, h0, c0, wh, mask, clip_min, clip_max,
                    clip_nan, wr=None):
    """One direction of one layer over time. ``xp`` (T, N, G*H) is the
    input projection with its bias (and, except for GRU, the h2h bias);
    ``mask`` (T, N, 1) or None: a masked step carries the state and
    emits zeros. ``wr`` (P, H) is the LSTMP projection."""
    h, c = h0, c0
    ys = []
    for t in range(xp.shape[0]):
        x_t = xp[t]
        m_t = None if mask is None else mask[t]
        if mode == "lstm":
            i, f, g, o = (x_t + h @ wh.T).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip_min is not None and clip_max is not None:
                if clip_nan:
                    c_new = torch.nan_to_num(c_new, nan=0.0)
                c_new = torch.clamp(c_new, clip_min, clip_max)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if wr is not None:
                h_new = h_new @ wr.T
            if m_t is not None:
                c_new = torch.where(m_t, c_new, c)
            c = c_new
        elif mode == "gru":
            xr, xz, xn = x_t.chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            h_new = (1.0 - z) * torch.tanh(xn + r * hn) + z * h
        else:
            pre = x_t + h @ wh.T
            h_new = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        if m_t is not None:
            h_new = torch.where(m_t, h_new, h)
            ys.append(torch.where(m_t, h_new, torch.zeros_like(h_new)))
        else:
            ys.append(h_new)
        h = h_new
    return torch.stack(ys), h, c


def rnn(data, params, state, state_cell=None, sequence_length=None,
        mode="lstm", state_size=None, num_layers=1, bidirectional=False,
        p=0.0, generator=None, train=False, projection_size=None,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False):
    """Fused multi-layer RNN. data (T, N, I); state (L*D, N, H), or
    (L*D, N, P) for LSTMP; returns (output (T, N, D*H or D*P), h_n)
    and, for LSTM, c_n. The input projection of every step is one
    product a layer and direction; the recurrence runs step by step. A
    reverse direction reads each sequence's valid steps reversed.
    Dropout of probability ``p`` (from ``generator``) follows every
    layer but the last when ``train``."""
    if projection_size and mode != "lstm":
        raise ValueError("projection_size is only defined for LSTM "
                         "(rnn-inl.h LSTMP)")
    d = 2 if bidirectional else 1
    t_len, _, input_size = data.shape
    if state_size is not None:
        h = state_size
    elif projection_size:
        h = state_cell.shape[-1]
    else:
        h = state.shape[-1]
    weights, biases, projs = _rnn_unpack(params, mode, input_size, h,
                                         num_layers, bidirectional,
                                         projection_size)
    mask = None
    if sequence_length is not None:
        mask = (torch.arange(t_len, device=data.device)[:, None]
                < sequence_length[None, :].long())[..., None]
    use_len = sequence_length is not None
    x = data
    h_outs, c_outs = [], []
    for layer in range(num_layers):
        dir_outs = []
        for di in range(d):
            idx = layer * d + di
            wi, wh = weights[idx]
            bi, bh = biases[idx]
            xin = x if di == 0 else sequence_reverse(x, sequence_length,
                                                     use_len)
            xp = xin @ wi.T + bi
            if mode != "gru":
                xp = xp + bh
            ys, hn, cn = _rnn_layer_scan(
                mode, xp, bh, state[idx],
                state_cell[idx] if state_cell is not None else None,
                wh, mask, lstm_state_clip_min, lstm_state_clip_max,
                lstm_state_clip_nan, wr=projs[idx] if projs else None)
            if di == 1:
                ys = sequence_reverse(ys, sequence_length, use_len)
            dir_outs.append(ys)
            h_outs.append(hn)
            c_outs.append(cn)
        x = dir_outs[0] if d == 1 else torch.cat(dir_outs, dim=-1)
        if train and p > 0.0 and layer < num_layers - 1:
            x = dropout(x, p, generator=generator)
    if mode == "lstm":
        return x, torch.stack(h_outs), torch.stack(c_outs)
    return x, torch.stack(h_outs)
