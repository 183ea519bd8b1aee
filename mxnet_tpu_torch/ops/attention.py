"""Attention ops of the port: flash attention (prefill / full forward)
and decode attention over a dense KV cache.

Counterpart of ``mxnet_tpu/ops/attention.py``, forward only. Each op
has a plain PyTorch version (``_blockwise_fwd``, ``_decode_fwd_torch``)
and a CUDA kernel written for Hopper (``csrc/flash_attention.cu``,
``csrc/decode_attention.cu``). The public functions dispatch on the
device of their inputs: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises — there is no fallback from the
kernel to the plain version.

All shapes are (batch, heads, seq, head_dim). ``kv_len`` means "only
the first kv_len entries of the key/value buffer are real": keys at or
past it never receive attention mass, and the causal diagonal is
end-aligned against the valid prefix (``offset = kv_len - seq_q``).

Numerical rules kept from the reference: the masked score is
``NEG_INF = -1e30`` (finite, never -inf), p is re-masked to 0 after
the exp, and the denominator is guarded (``l_safe``), so a query row
that sees no key returns zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

__all__ = ["NEG_INF", "mha_reference", "flash_attention",
           "flash_attention_fwd", "decode_attention", "launch_counts",
           "reset_launch_counts", "KERNEL_HEAD_DIMS"]

NEG_INF = -1e30

#: head dims the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

#: launches of each CUDA kernel since the last reset — bumped by the
#: wrappers right where they launch, and nowhere else
_launches = {"flash_attention_fwd": 0, "decode_attention": 0}


def launch_counts() -> dict:
    """Snapshot of the per-kernel launch counters."""
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def mha_reference(q, k, v, causal=False, scale=None):
    """Plain attention (for tests and tiny sequences)."""
    scale = _scale(q, scale)
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(col <= row + (sk - sq), s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------
def _check_kv_len(kv_len, sk):
    kv_len = sk if kv_len is None else int(kv_len)
    if not 0 < kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} out of range for key "
                         f"buffer of length {sk}")
    return kv_len


def _blockwise_fwd(q, k, v, causal, scale, block=512, kv_len=None):
    """The plain version of K1: the reference's blockwise online
    softmax (``_blockwise_fwd``), one key block at a time. Returns
    ``(out, lse)``; lse is fp32."""
    sq, sk = q.shape[-2], k.shape[-2]
    kv_len = _check_kv_len(kv_len, sk)
    offset = kv_len - sq
    dev = q.device
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    row = torch.arange(sq, device=dev)[:, None]
    for j in range(0, kv_len, block):
        kj, vj = k[..., j:j + block, :], v[..., j:j + block, :]
        col = torch.arange(j, j + kj.shape[-2], device=dev)[None, :]
        valid = col < kv_len
        if causal:
            valid = valid & (col <= row + offset)
        s = torch.einsum("...qd,...kd->...qk", q, kj).float() * scale
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "...qk,...kd->...qd", p.to(vj.dtype), vj).float()
        m = m_new
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def _kernel_strides(name, x, ndim=4):
    """The (b, h, s) element strides of ``x`` for a kernel that reads
    rows with 16-byte loads: the last axis must be contiguous, the base
    16-byte aligned and every row start a multiple of 4 elements. Any
    other layout raises — the wrappers never copy an input."""
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    st = x.stride()
    if st[-1] != 1 and x.shape[-1] > 1:
        raise ValueError(f"{name}: the head_dim axis must be contiguous "
                         f"(strides {st})")
    if x.data_ptr() % 16 or any(s % 4 for s in st[:-1]):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                         f"(strides {st}, data_ptr {x.data_ptr():#x})")
    return st[:-1]


def _check_cuda_f32(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices "
                             f"({dev} vs {t.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 inputs, got "
                            f"{t.dtype}")


#: q, k, v, out, lse; B, H, Sq, D, kv_len, causal; scale; strides; stream
_FLASH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _flash_fwd_cuda(q, k, v, causal, scale, kv_len):
    """Launch K1 (``csrc/flash_attention.cu``). q/k/v may be strided
    views — the prefill's come straight out of the head split's
    transpose — as long as each row is contiguous and 16-byte aligned;
    their strides are passed to the kernel and nothing is copied."""
    name = "flash_attention_fwd"
    _check_cuda_f32(name, q, k, v)
    b, h, sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{name}: batch*heads {b * h} exceeds the grid")
    strides = (ctypes.c_longlong * 9)(
        *_kernel_strides(name, q), *_kernel_strides(name, k),
        *_kernel_strides(name, v))
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "mxtt_flash_attention_fwd",
                         _FLASH_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, sq, d, kv_len, int(bool(causal)),
                 float(scale), ctypes.addressof(strides), stream)
    _launches[name] += 1
    _build.check("flash_attention", err, name)
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None, kv_len=None):
    """Flash attention forward, returning ``(out, lse)``. CUDA inputs
    launch K1; CPU inputs take the plain blockwise version."""
    kv_len = _check_kv_len(kv_len, k.shape[-2])
    scale = _scale(q, scale)
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale, kv_len)
    return _blockwise_fwd(q, k, v, causal, scale, kv_len=kv_len)


def flash_attention(q, k, v, causal=False, scale=None, kv_len=None):
    """``kv_len`` (int) marks the valid key prefix of a longer cache
    buffer: keys beyond it are masked out of the softmax and the causal
    diagonal end-aligns to the valid prefix (the last query row sees
    keys [0, kv_len))."""
    return flash_attention_fwd(q, k, v, causal, scale, kv_len)[0]


# ---------------------------------------------------------------------------
# decode attention (per-row lengths over a dense cache)
# ---------------------------------------------------------------------------
def _masked_attend(q, k, v, valid, scale):
    """Single-pass masked-softmax attention with the two guards the
    cache paths need: RE-MASK after the exp (a fully-masked row's
    scores are all NEG_INF, so exp(s - m) would be 1 across the board)
    and an l_safe denominator (an empty slot returns zeros, not NaN)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    p = (p / l_safe).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _decode_fwd_torch(q, k, v, lengths, scale):
    """The plain version of K2: every query row of batch b attends keys
    [0, lengths[b]) of its cache row. V rows at or past the length are
    zeroed before ``p @ v`` (the TPU kernel's overhang rule): a cache
    tail may hold garbage, even NaN, and 0 * NaN would poison the
    sum."""
    col = torch.arange(k.shape[2], device=k.device)
    live = col[None, :] < lengths.to(k.device).long()[:, None]    # (B, S)
    v = torch.where(live[:, None, :, None], v, torch.zeros_like(v))
    return _masked_attend(q, k, v, live[:, None, None, :], scale)


#: q, k, v, lengths, out; B, H, Sq, S, D; scale; strides; stream
_DECODE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _decode_cuda(q, k, v, lengths, scale):
    """Launch K2 (``csrc/decode_attention.cu``). q may be a strided
    view (the decode step's head split); k/v are the cache buffers;
    lengths is a (B,) int32 tensor on the same card."""
    name = "decode_attention"
    _check_cuda_f32(name, q, k, v)
    b, h, sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or lengths.shape != (b,) or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be a contiguous ({b},) "
                         f"int32 tensor on {q.device}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")
    if b > 65535 or sq > 65535 * 4:
        raise ValueError(f"{name}: batch {b} / queries {sq} exceed the grid")
    strides = (ctypes.c_longlong * 9)(
        *_kernel_strides(name, q), *_kernel_strides(name, k),
        *_kernel_strides(name, v))
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    fn = _build.function("decode_attention", "mxtt_decode_attention",
                         _DECODE_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, h, sq, k.shape[2],
                 d, float(scale), ctypes.addressof(strides), stream)
    _launches[name] += 1
    _build.check("decode_attention", err, name)
    return out


def decode_attention(q, k, v, lengths, scale=None):
    """Autoregressive decode attention against a preallocated KV cache.

    ``q`` is (B, H, Sq, D) — Sq is 1 on the decode hot path; ``k``/``v``
    are the cache buffers (B, H, S_max, D) filled left-to-right;
    ``lengths`` (B,) int32 marks each slot's valid prefix INCLUDING the
    just-inserted token. Every query attends keys [0, lengths[b]); a
    row with lengths == 0 (an empty serving slot riding along in the
    fixed-shape batch) returns zeros. CUDA inputs launch K2; CPU inputs
    take the plain version."""
    scale = _scale(q, scale)
    if not torch.is_tensor(lengths):
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=q.device)
    if q.is_cuda:
        return _decode_cuda(q, k, v, lengths, scale)
    return _decode_fwd_torch(q, k, v, lengths, scale)
