"""int8 quantization: weight-only int8 projections (per-channel
quantization and the fused dequantize-matmul, K4) and the int8 KV
cache's scales (``kv_scale``, ``kv_quantize``).

Counterpart of ``mxnet_tpu/ops/quantized.py``. Decode at small batch is
bound by the bytes of the weights it streams, so the projections keep
their weights as per-output-channel symmetric int8
(``quantize_channelwise``) and dequantize them on the fly:

    y = x @ (wq.float() * scale[:, None]).T

Activations are fp32 (a bf16 input is widened first, as the reference
casts x to fp32), so the only error source is the weight rounding.

``dequant_matmul`` dispatches on the device of its input: a CPU tensor
takes the plain version (the reference's blocked computation, one
output-channel block of ``_block_n`` channels at a time through
``_dequant_dot``), a CUDA tensor launches K4
(``csrc/dequant_matmul.cu``), which streams each int8 weight byte once,
converts it in registers and adds an optional bias in its epilogue —
or raises. There is no fallback.

The int8 KV cache quantizes K/V with the same convention (amax / 127,
round half to even, clip to ±127) through ``kv_scale`` and
``kv_quantize``, bitwise the reference's on the same fp32 input.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["quantize_channelwise", "dequant_matmul", "kv_scale",
           "kv_quantize", "launch_counts", "reset_launch_counts"]

_INT8_MAX = 127.0
#: the reference's output-channel block of the plain version
_BLOCK_N = 512

#: launches of K4 since the last reset — bumped by the wrapper right
#: where it launches, and nowhere else
_launches = {"dequant_matmul": 0}


def launch_counts() -> dict:
    """Snapshot of the launch counter."""
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0


def quantize_channelwise(w, axis=0):
    """fp32 weight -> ``(int8 weight, fp32 scales)`` with a symmetric
    range per output channel (``axis``; the Dense layout is
    ``(out, in)``, so each output row is quantized against its own
    absmax). ``dequant == wq.float() * scale`` broadcast over ``axis``;
    scales are returned flat ``(w.shape[axis],)``. Bitwise the
    reference's: fp32 division, round half to even, clip to ±127 and
    an all-zero channel's scale floored at 1e-12 / 127."""
    w = torch.as_tensor(w).float()
    red = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    absmax = w.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / _INT8_MAX
    wq = torch.clamp(torch.round(w / scale), -_INT8_MAX, _INT8_MAX) \
        .to(torch.int8)
    return wq, scale.reshape(-1)


def kv_scale(x, axes):
    """amax-derived symmetric int8 scale of ``x`` over ``axes`` (fp32):
    ``amax / 127``, a true division, with NO floor — an all-zero input
    (an empty slot, a zero page) gets scale 0, as in the reference."""
    return (x.abs().amax(dim=axes) / _INT8_MAX).float()


def kv_quantize(x, scale):
    """Quantize K/V values with a broadcast-ready ``scale``: divide by
    the scale floored at 1e-12 (a zero scale would mint NaN int8
    garbage, which a masked V row would still carry into ``p @ v`` as
    0 * NaN), round half to even, clip to ±127."""
    s = torch.clamp(scale, min=1e-12)
    return torch.clamp(torch.round(x / s), -_INT8_MAX, _INT8_MAX) \
        .to(torch.int8)


def _block_n(n, block_n):
    """Output channels per block: the requested width when it divides
    ``n``, otherwise the whole matrix in one block."""
    bn = min(int(block_n), n)
    return bn if n % bn == 0 else n


def _dequant_dot(x2, wq_blk, s_blk):
    """The one block computation of the plain version: convert the int8
    block, scale it per output channel, contract x's feature axis
    against the weight's ``in`` axis in fp32."""
    wf = wq_blk.float() * s_blk[:, None]
    return x2 @ wf.T


def _dequant_matmul_torch(x2, wq, scales, block_n=_BLOCK_N, bias=None):
    """The plain version of K4: ``_dequant_dot`` over ``block_n``-wide
    output-channel blocks, so at most one block of the weight is ever
    dequantized at a time; the bias, when given, is added after the
    product (the reference's ``_proj``: ``dequant_matmul(...) + bias``)."""
    n = wq.shape[0]
    bn = _block_n(n, block_n)
    if bn == n:
        out = _dequant_dot(x2, wq, scales)
    else:
        out = torch.cat([_dequant_dot(x2, wq[j:j + bn], scales[j:j + bn])
                         for j in range(0, n, bn)], dim=1)
    return out if bias is None else out + bias


def _check_bias(bias, n):
    if tuple(bias.shape) != (n,):
        raise ValueError(f"dequant_matmul: bias shape {tuple(bias.shape)} "
                         f"must be ({n},)")


#: x, wq, scales, bias, out; M, N, K; stream
_DEQUANT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def _dequant_matmul_cuda(x2, wq, scales, bias=None):
    """Launch K4 (``csrc/dequant_matmul.cu``): x2 (M, K) fp32, wq (N, K)
    int8, scales (N,) fp32 and an optional bias (N,) fp32, all
    contiguous on one card, K a multiple of 16 (16-byte weight loads).
    Anything else raises — nothing is copied."""
    name = "dequant_matmul"
    m, k = x2.shape
    n = wq.shape[0]
    checked = [("x", x2, torch.float32), ("wq", wq, torch.int8),
               ("scales", scales, torch.float32)]
    if bias is not None:
        _check_bias(bias, n)
        checked.append(("bias", bias, torch.float32))
    for what, t, dt in checked:
        if t.device != x2.device:
            raise ValueError(f"{name}: inputs on different devices "
                             f"({x2.device} vs {t.device} for {what})")
        if t.dtype != dt:
            raise TypeError(f"{name}: {what} must be {dt}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and start "
                             f"on a 16-byte boundary")
    if k % 16:
        raise ValueError(f"{name}: in-features {k} must be a multiple of "
                         f"16 for the kernel's 16-byte weight loads")
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    fn = _build.function(name, "mxtt_dequant_matmul", _DEQUANT_ARGTYPES)
    err = _build.launch_on(x2, fn, (
        x2.data_ptr(), wq.data_ptr(), scales.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k))
    _launches[name] += 1
    _build.check(name, err, name)
    return out


def dequant_matmul(x, wq, scales, block_n=_BLOCK_N, bias=None):
    """``x @ dequant(wq, scales).T (+ bias)``.

    ``x`` is ``(..., K)`` fp32, bf16 or float16, ``wq`` ``(N, K)`` int8
    (the Dense ``(out, in)`` layout), ``scales`` ``(N,)`` fp32, ``bias``
    ``(N,)`` of one of those types or None. Returns ``(..., N)`` fp32: a
    16-bit x and bias are widened to fp32 (exact), as the reference
    computes. CUDA inputs launch K4, which adds the bias in its epilogue
    (an fp32 ``x`` folded to ``(M, K)`` without a copy, so it must be
    contiguous); CPU inputs take the blocked plain version and add the
    bias after it."""
    n, k = wq.shape
    if x.shape[-1] != k:
        raise ValueError(f"x features {x.shape[-1]} do not match "
                         f"quantized weight in-dim {k}")
    if tuple(scales.shape) != (n,):
        raise ValueError(f"scales shape {tuple(scales.shape)} must be "
                         f"({n},)")
    if bias is not None:
        _check_bias(bias, n)
    lead = x.shape[:-1]
    if x.is_cuda:
        if x.dtype != torch.float32:
            x = x.float()
        if bias is not None and bias.dtype != torch.float32:
            bias = bias.float()
        if not x.is_contiguous():
            raise ValueError("dequant_matmul: x must be contiguous (the "
                             "kernel reads it as (M, K) without a copy)")
        out = _dequant_matmul_cuda(x.view(-1, k), wq, scales, bias)
    else:
        out = _dequant_matmul_torch(x.reshape(-1, k).float(), wq, scales,
                                    block_n, bias)
    return out.reshape(*lead, n)
