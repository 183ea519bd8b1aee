"""Attention ops of the port: flash attention (prefill / full forward),
decode attention over a dense KV cache and over a paged pool, and the
chunked-prefill attention of the paged engine.

Counterpart of ``mxnet_tpu/ops/attention.py``. Each op
that the reference ran as a Pallas kernel has a plain PyTorch version
(``_blockwise_fwd``, ``_decode_fwd_torch``, ``gather_pages`` +
``_decode_fwd_torch``) and a CUDA kernel written for Hopper
(``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``,
``csrc/paged_decode_attention.cu``). The two decode kernels come in an
fp32, an int8, a bf16 and a float16 instance: an int8 cache
(``k_scale``/``v_scale`` given) is dequantized before the masked softmax
in the plain version and in registers, after the int8 load, in the
kernel; a bf16 or float16 cache is read as it is and widened in
registers. K1 comes in an fp32, a bf16 and a float16 instance.
``flash_attention`` is differentiable, as the reference's ``custom_vjp``
is: its backward is the reference's blockwise ``_flash_bwd`` (plain
``jnp`` there), here a plain version beside a CUDA kernel of its own,
K1-bwd (``csrc/flash_attention_bwd.cu``), in the same three instances.
The public functions dispatch on
the device of their inputs: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises — there is no fallback from
the kernel to the plain version. ``chunked_prefill_attention`` is plain
``jnp`` in the reference and stays plain PyTorch here.

All shapes are (batch, heads, seq, head_dim). ``kv_len`` means "only
the first kv_len entries of the key/value buffer are real": keys at or
past it never receive attention mass, and the causal diagonal is
end-aligned against the valid prefix (``offset = kv_len - seq_q``).

Types follow the reference's jnp path, which the plain versions are:
bf16 scores and P where q and K are bf16, an output in q's type from
flash attention (lse fp32), and an output in the attended V's type from
the decode paths (bf16 for a bf16 cache, fp32 for an fp32 or int8 one);
mixed operands promote as jnp does (fp32 q against a bf16 cache scores
in fp32). The kernels compute in fp32 from the widened inputs, which
the reference's Pallas kernels do too, and round the output to the same
type as the plain version. float16 inputs take the Pallas kernels' way
in the plain versions as well (``_widened``): q, K and V widened to
fp32, every product and sum in fp32, the output rounded to float16 (q's
type for flash attention, V's for decode). No wrapper widens a cache to
call an fp32 instance: a dtype without an instance raises.

Numerical rules kept from the reference: the masked score is
``NEG_INF = -1e30`` (finite, never -inf), p is re-masked to 0 after
the exp, and the denominator is guarded (``l_safe``), so a decode row
that sees no key returns zeros. Flash attention's fully-masked causal
rows (``kv_len < seq_q``) follow the reference's blockwise path
instead, which does not re-mask: see ``_fill_unseen_rows``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

__all__ = ["NEG_INF", "mha_reference", "flash_attention",
           "flash_attention_fwd", "flash_attention_bwd",
           "decode_attention", "gather_pages", "expand_page_scales",
           "paged_decode_attention", "chunked_prefill_attention",
           "launch_counts", "reset_launch_counts", "KERNEL_HEAD_DIMS"]

NEG_INF = -1e30

#: head dims the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

#: launches of each CUDA kernel since the last reset — bumped by the
#: wrappers right where they launch, and nowhere else
_launches = {"flash_attention_fwd": 0, "flash_attention_fwd_bf16": 0,
             "flash_attention_fwd_f16": 0,
             "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
             "flash_attention_bwd_dq_bf16": 0,
             "flash_attention_bwd_dkv_bf16": 0,
             "flash_attention_bwd_dq_f16": 0,
             "flash_attention_bwd_dkv_f16": 0,
             "decode_attention": 0, "decode_attention_int8": 0,
             "decode_attention_bf16": 0, "decode_attention_f16": 0,
             "paged_decode_attention": 0,
             "paged_decode_attention_int8": 0,
             "paged_decode_attention_bf16": 0,
             "paged_decode_attention_f16": 0}

#: the instance suffix of each 16-bit element type
_HALF = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _widened(fn, *ts):
    """``fn`` of float16 tensors computed on their fp32 widening (exact),
    its result rounded back to float16: the plain float16 versions do
    what the reference's dtype-generic Pallas kernels do."""
    return fn(*(t.float() for t in ts)).to(torch.float16)


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
    16-byte aligned and every row start 16 bytes after the last (4 fp32,
    8 bf16 or 16 int8 elements). Any other layout raises — the wrappers
    never copy an input."""
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    st = x.stride()
    if st[-1] != 1 and x.shape[-1] > 1:
        raise ValueError(f"{name}: the head_dim axis must be contiguous "
                         f"(strides {st})")
    if x.data_ptr() % 16 or any(s * x.element_size() % 16
                                for s in st[:-1]):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                         f"(strides {st}, data_ptr {x.data_ptr():#x})")
    return st[:-1]


#: the element types the kernels have instances for
_KERNEL_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _check_flash_inputs(name, q, k, v):
    """q, k and v on one device, all fp32, all bf16 or all float16
    (K1's three instances); returns that dtype."""
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on different devices "
                             f"({q.device} vs {t.device})")
    if q.dtype not in _KERNEL_FLOATS or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or "
                        f"float16 q, k and v of one type, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    return q.dtype


def _check_flash_shapes(name, q, k, v):
    """q (B, H, Sq, D) against k and v (B, H, Sk, D), D a head dim the
    kernels are instantiated for."""
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")


#: q, k, v, out, lse; B, H, Sq, D, kv_len, causal; scale; strides; stream
_FLASH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the (b, h, s) strides of q, k and v, as the kernel reads them
_Strides9 = ctypes.c_longlong * 9
#: K1's rows per query tile (the fp32 instance's; the 16-bit ones' are
#: 64, so the check holds for all), and its grid's limit on query tiles
_FLASH_BLOCK_Q, _GRID_Y_MAX = 32, 65535


def _flash_fwd_cuda(q, k, v, causal, scale, kv_len):
    """Launch K1 (``csrc/flash_attention.cu``): its fp32 instance, or
    its bf16 or float16 instance on q/k/v of that type (an output of
    that type, lse fp32). q/k/v may be strided views — the prefill's
    come straight out of the head split's transpose — as long as each
    row is contiguous and 16-byte aligned; their strides are passed to
    the kernel and nothing is copied."""
    half = _HALF.get(_check_flash_inputs("flash_attention_fwd", q, k, v))
    name = f"flash_attention_fwd_{half}" if half else "flash_attention_fwd"
    _check_flash_shapes(name, q, k, v)
    b, h, sq, d = q.shape
    if -(-sq // _FLASH_BLOCK_Q) > _GRID_Y_MAX:
        raise ValueError(f"{name}: {sq} query rows exceed the grid")
    strides = _Strides9(*_kernel_strides(name, q), *_kernel_strides(name, k),
                        *_kernel_strides(name, v))
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", f"mxtt_{name}", _FLASH_ARGTYPES)
    err = _build.launch_on(q, fn, (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, d, kv_len, int(bool(causal)),
        float(scale), ctypes.addressof(strides)))
    _launches[name] += 1
    _build.check("flash_attention", err, name)
    return out, lse


def _fill_unseen_rows(out, lse, v, n_rows, block=512):
    """The reference's value for the first ``n_rows`` query rows of a
    causal call with ``kv_len < seq_q``, which see no key. Its blockwise
    path does not re-mask after the exp: every score of such a row is
    NEG_INF, so exp(s - m) is 1 on every column of every key block of
    the zero-padded buffer, and the row comes out as the sum of V over
    the buffer divided by the padded length, with lse = NEG_INF (the
    log of that length vanishes against 1e30 in fp32). Both kernels
    and the plain version compute zeros there; the wrapper overwrites
    those rows in place."""
    sk = v.shape[-2]
    padded = -(-sk // block) * block
    out[..., :n_rows, :] = (v.sum(dim=-2, keepdim=True).float()
                            / padded).to(out.dtype)
    lse[..., :n_rows] = NEG_INF
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None, kv_len=None):
    """Flash attention forward, returning ``(out, lse)``. CUDA inputs
    launch K1; CPU inputs take the plain blockwise version. Causal rows
    that see no key (``kv_len < seq_q``) get the reference's value
    (``_fill_unseen_rows``) on both paths."""
    kv_len = _check_kv_len(kv_len, k.shape[-2])
    scale = _scale(q, scale)
    if q.is_cuda:
        out, lse = _flash_fwd_cuda(q, k, v, causal, scale, kv_len)
    elif q.dtype == torch.float16:
        out, lse = _blockwise_fwd(q.float(), k.float(), v.float(), causal,
                                  scale, kv_len=kv_len)
        out = out.to(torch.float16)
    else:
        out, lse = _blockwise_fwd(q, k, v, causal, scale, kv_len=kv_len)
    if causal and kv_len < q.shape[-2]:
        out, lse = _fill_unseen_rows(out, lse, v, q.shape[-2] - kv_len)
    return out, lse


def flash_attention(q, k, v, causal=False, scale=None, kv_len=None):
    """``kv_len`` (int) marks the valid key prefix of a longer cache
    buffer: keys beyond it are masked out of the softmax and the causal
    diagonal end-aligns to the valid prefix (the last query row sees
    keys [0, kv_len)).

    Differentiable, as the reference's ``custom_vjp`` is: when grad
    mode is on and q, k or v requires grad, the call goes through
    ``_FlashAttention`` (forward K1, backward K1-bwd on the card; the
    plain versions on the CPU). ``causal``, ``scale`` and ``kv_len`` get
    no gradient (the reference's ``nondiff_argnums=(3, 4, 5)``).
    Otherwise — every serving call runs under ``no_grad`` — it builds no
    graph and saves nothing."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, kv_len)
    return flash_attention_fwd(q, k, v, causal, scale, kv_len)[0]


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention.defvjp(_flash_fwd, _flash_bwd)``:
    the forward saves q, k, v, out and lse; the backward rematerializes
    P from them (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------
def _flash_bwd(q, k, v, o, lse, do, causal, scale, kv_len=None, block=512):
    """The plain version of K1-bwd: the reference's blockwise backward
    (``_flash_bwd``), in the kernel's two halves: ``_flash_bwd_dq``
    (``delta = sum(dO * out)``, then P rematerialized from lse one key
    block at a time) and ``_flash_bwd_dkv`` (one query block at a time).
    Returns dq, dk, dv in q's, k's and v's types."""
    kv_len = _check_kv_len(kv_len, k.shape[-2])
    dq, delta = _flash_bwd_dq(q, k, v, o, lse, do, causal, scale, kv_len,
                              block)
    dk, dv = _flash_bwd_dkv(q, k, v, lse, do, delta, causal, scale, kv_len,
                            block)
    return dq, dk, dv


def _flash_bwd_dq(q, k, v, o, lse, do, causal, scale, kv_len, block=512):
    """dq and delta: ``p = where(valid, exp(s - lse), 0)``,
    ``ds = p * (dp - delta) * scale``, ``dq = ds K``; s is computed in
    the inputs' type and widened, as the reference's einsum does,
    everything after it in fp32. Only the keys below ``kv_len`` are read:
    the reference also reads the zero-padded and masked tail, where it
    adds exact zeros on finite data (p = 0 there), so the result is the
    same."""
    sq = q.shape[-2]
    offset = kv_len - sq
    dev = q.device
    do32 = do.float()
    delta = (do32 * o.float()).sum(-1)                       # (..., sq)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    row = torch.arange(sq, device=dev)[:, None]
    for j in range(0, kv_len, block):
        kj = k[..., j:min(j + block, kv_len), :]
        vj = v[..., j:min(j + block, kv_len), :].float()
        col = torch.arange(j, j + kj.shape[-2], device=dev)[None, :]
        valid = col <= row + offset if causal else torch.ones_like(
            col, dtype=torch.bool)
        s = torch.einsum("...qd,...kd->...qk", q, kj).float() * scale
        p = torch.where(valid, torch.exp(s - lse[..., None]),
                        torch.zeros_like(s))
        dp = torch.einsum("...qd,...kd->...qk", do32, vj)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("...qk,...kd->...qd", ds, kj.float())
    return dq.to(q.dtype), delta


def _flash_bwd_dkv(q, k, v, lse, do, delta, causal, scale, kv_len,
                   block=512):
    """dk and dv from the dq half's delta: ``dv = P^T dO`` and
    ``dk = dS^T q``, one query block at a time over the keys below
    ``kv_len``; keys at or past it get exact-zero dk and dv."""
    sq = q.shape[-2]
    offset = kv_len - sq
    dev = q.device
    do32 = do.float()
    kl, vl32 = k[..., :kv_len, :], v[..., :kv_len, :].float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
    col = torch.arange(kv_len, device=dev)[None, :]
    for i in range(0, sq, block):
        qi, doi = q[..., i:i + block, :], do32[..., i:i + block, :]
        row = torch.arange(i, i + qi.shape[-2], device=dev)[:, None]
        valid = col <= row + offset if causal else torch.ones_like(
            col, dtype=torch.bool)
        s = torch.einsum("...qd,...kd->...qk", qi, kl).float() * scale
        p = torch.where(valid, torch.exp(s - lse[..., i:i + block, None]),
                        torch.zeros_like(s))
        dv[..., :kv_len, :] += torch.einsum("...qk,...qd->...kd", p, doi)
        dp = torch.einsum("...qd,...kd->...qk", doi, vl32)
        ds = p * (dp - delta[..., i:i + block, None]) * scale
        dk[..., :kv_len, :] += torch.einsum("...qk,...qd->...kd", ds,
                                            qi.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _dense_rows(x):
    """True when ``x`` has the row layout the kernels read (contiguous
    last axis, 16-byte aligned base and row starts)."""
    st = x.stride()
    return (st[-1] == 1 or x.shape[-1] == 1) and not x.data_ptr() % 16 \
        and not any(s * x.element_size() % 16 for s in st[:-1])


#: q, k, v, out | dO, dO | lse, lse | delta, dq | dk, delta | dv;
#: B, H, Sq, Sk, D, kv_len, causal; scale; strides; stream
_FLASH_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the (b, h, s) strides of q, k, v, out and dO
_Strides15 = ctypes.c_longlong * 15
#: K1-bwd's rows (queries or keys) per tile
_FLASH_BWD_TILE = 64


def _flash_bwd_launch(kind, q, k, v, out, lse, do, causal, scale, kv_len,
                      delta=None):
    """One of K1-bwd's two launches (``csrc/flash_attention_bwd.cu``),
    its fp32, bf16 or float16 instance by q's type: ``"dq"`` returns
    ``(dq, delta)``; ``"dkv"``, given that launch's delta, returns
    ``(dk, dv)``. q, k and v are read through their strides, as K1 reads
    them (the head split's views, no copy); out and lse are the
    forward's."""
    half = _HALF.get(_check_flash_inputs("flash_attention_bwd", q, k, v))
    name = f"flash_attention_bwd_{kind}" + (f"_{half}" if half else "")
    _check_flash_shapes(name, q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for t, what in ((out, "out"), (do, "dO")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {what} must be {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t is not None and (t.shape != q.shape[:-1]
                              or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{tuple(q.shape[:-1])} float32 tensor")
    if max(-(-sq // _FLASH_BWD_TILE), -(-sk // _FLASH_BWD_TILE)) \
            > _GRID_Y_MAX:
        raise ValueError(f"{name}: {max(sq, sk)} rows exceed the grid")
    if not _dense_rows(do):
        # the one input the wrapper copies: dO comes from whatever the
        # consumer's backward made (an expanded or transposed gradient)
        do = do.contiguous()
    strides = _Strides15(*_kernel_strides(name, q), *_kernel_strides(name, k),
                         *_kernel_strides(name, v),
                         *_kernel_strides(name, out),
                         *_kernel_strides(name, do))
    if kind == "dq":
        dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
        delta = torch.empty((b, h, sq), dtype=torch.float32,
                            device=q.device)
        ptrs, res = (q, k, v, out, do, lse, dq, delta), (dq, delta)
    elif delta is None:
        raise ValueError(f"{name}: needs the dq launch's delta")
    else:
        dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
        dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
        ptrs, res = (q, k, v, do, lse, delta, dk, dv), (dk, dv)
    fn = _build.function("flash_attention_bwd", f"mxtt_{name}",
                         _FLASH_BWD_ARGTYPES)
    err = _build.launch_on(q, fn, (
        *(t.data_ptr() for t in ptrs), b, h, sq, sk, d, kv_len,
        int(bool(causal)), float(scale), ctypes.addressof(strides)))
    _launches[name] += 1
    _build.check("flash_attention_bwd", err, name)
    return res


def _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_len):
    """Launch K1-bwd: the dq launch (which also writes delta), then the
    dk/dv launch, queued after it on the same stream."""
    dq, delta = _flash_bwd_launch("dq", q, k, v, out, lse, do, causal,
                                  scale, kv_len)
    dk, dv = _flash_bwd_launch("dkv", q, k, v, out, lse, do, causal, scale,
                               kv_len, delta)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        kv_len=None):
    """Flash attention backward: ``(dq, dk, dv)`` from the forward's
    inputs, its ``(out, lse)`` and the output gradient ``do``. CUDA
    inputs launch K1-bwd; CPU inputs take the plain blockwise version.
    Keys at or past ``kv_len`` get exact-zero dk and dv, and causal rows
    that see no key get zero gradients on both paths."""
    kv_len = _check_kv_len(kv_len, k.shape[-2])
    scale = _scale(q, scale)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale, kv_len)
    return _flash_bwd(q, k, v, out, lse, do, causal, scale, kv_len)


# ---------------------------------------------------------------------------
# decode attention (per-row lengths over a dense cache)
# ---------------------------------------------------------------------------
def _masked_attend(q, k, v, valid, scale):
    """Single-pass masked-softmax attention with the two guards the
    cache paths need: RE-MASK after the exp (a fully-masked row's
    scores are all NEG_INF, so exp(s - m) would be 1 across the board)
    and an l_safe denominator (an empty slot returns zeros, not NaN).
    q and k of two float types promote as jnp promotes them; p takes
    v's type, and so does the result."""
    dt = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt)).float() * scale
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


def _check_decode_inputs(name, q, k, v, k_scale, v_scale, scale_rows):
    """The checks K2 and K3 share: every input on q's device, q fp32,
    bf16 or float16, K/V both of one of those types — or, with scales,
    int8 K/V and contiguous (``scale_rows``, H) fp32 scales."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{name}: k_scale and v_scale come together")
    tensors = (q, k, v, k_scale, v_scale) if quant else (q, k, v)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on different devices "
                             f"({q.device} vs {t.device})")
    if q.dtype not in _KERNEL_FLOATS:
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or "
                        f"float16 queries, got {q.dtype}")
    want = (torch.int8,) if quant else _KERNEL_FLOATS
    if k.dtype not in want or v.dtype != k.dtype:
        raise TypeError(f"{name}: the kernel takes K/V of one type in "
                        f"{want} here, got {k.dtype} and {v.dtype}")
    if quant:
        shape = (scale_rows, q.shape[1])
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or tuple(t.shape) != shape \
                    or not t.is_contiguous():
                raise ValueError(f"{name}: scales must be contiguous "
                                 f"{shape} float32, got {t.dtype} "
                                 f"{tuple(t.shape)}")


def _dequantize(x, scale):
    """int8 K/V -> fp32 with a scale broadcast over the trailing axes
    it lacks (``(B, H)`` per slot, ``(B, H, S)`` per position)."""
    return x.float() * scale.reshape(*scale.shape, *[1] * (
        x.dim() - scale.dim()))


#: q, k, v, lengths, out; B, H, Sq, S, D; scale; strides; stream
_DECODE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the int8 instance: q, k, v, k_scale, v_scale, lengths, out; the rest
_DECODE_INT8_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the bf16 and float16 instances: q, q_half, k, v, lengths, out; the
#: rest
_DECODE_HALF_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _decode_instance(kind, q, k_dtype):
    """The decode kernel instance for a cache of ``k_dtype``: its name,
    the query it reads and the output's type. A bf16 (float16) instance
    reads an fp32 q, or one of the cache's type, as it is and writes the
    cache's type (the attended V's); any other q is widened first
    (exact). The fp32 and int8 instances read fp32, so a 16-bit q is
    widened first, and write fp32."""
    half = _HALF.get(k_dtype)
    if half is not None:
        if q.dtype not in (torch.float32, k_dtype):
            q = q.float()
        return f"{kind}_{half}", q, k_dtype
    if q.dtype != torch.float32:
        q = q.float()
    return (f"{kind}_int8" if k_dtype == torch.int8 else kind), q, \
        torch.float32


def _decode_cuda(q, k, v, lengths, scale, k_scale=None, v_scale=None):
    """Launch K2 (``csrc/decode_attention.cu``): the instance of the
    cache's type — fp32, bf16, or with ``k_scale``/``v_scale`` (B, H)
    int8. q may be a strided view (the decode step's head split); k/v
    are the cache buffers; lengths is a (B,) int32 tensor on the same
    card."""
    quant = k_scale is not None
    b, h, sq, d = q.shape
    _check_decode_inputs("decode_attention", q, k, v, k_scale, v_scale, b)
    name, q, out_dtype = _decode_instance("decode_attention", q, k.dtype)
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
    strides = _Strides9(*_kernel_strides(name, q), *_kernel_strides(name, k),
                        *_kernel_strides(name, v))
    out = torch.empty((b, h, sq, d), dtype=out_dtype, device=q.device)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quant else ()
    half = out_dtype in _HALF
    q_args = (q.data_ptr(), int(q.dtype == out_dtype)) if half \
        else (q.data_ptr(),)
    fn = _build.function(
        "decode_attention", f"mxtt_{name}",
        _DECODE_HALF_ARGTYPES if half
        else _DECODE_INT8_ARGTYPES if quant else _DECODE_ARGTYPES)
    err = _build.launch_on(q, fn, (
        *q_args, k.data_ptr(), v.data_ptr(), *scales,
        lengths.data_ptr(), out.data_ptr(), b, h, sq, k.shape[2], d,
        float(scale), ctypes.addressof(strides)))
    _launches[name] += 1
    _build.check("decode_attention", err, name)
    return out


def decode_attention(q, k, v, lengths, scale=None, k_scale=None,
                     v_scale=None):
    """Autoregressive decode attention against a preallocated KV cache.

    ``q`` is (B, H, Sq, D) — Sq is 1 on the decode hot path; ``k``/``v``
    are the cache buffers (B, H, S_max, D) filled left-to-right;
    ``lengths`` (B,) int32 marks each slot's valid prefix INCLUDING the
    just-inserted token. Every query attends keys [0, lengths[b]); a
    row with lengths == 0 (an empty serving slot riding along in the
    fixed-shape batch) returns zeros.

    ``k_scale``/``v_scale`` (B, H) fp32 mark an INT8 cache: the stored
    int8 K/V dequantize with each slot's per-head scale. A bf16 or
    float16 cache gives a result of its type, an fp32 or int8 one fp32
    (the module's type rule). CUDA inputs launch K2 (the instance of the
    cache's type); CPU inputs take the plain version (dequantize, then
    ``_decode_fwd_torch``; a float16 cache ``_widened``)."""
    scale = _scale(q, scale)
    if not torch.is_tensor(lengths):
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=q.device)
    if q.is_cuda:
        return _decode_cuda(q, k, v, lengths, scale, k_scale, v_scale)
    if k_scale is not None:
        k, v = _dequantize(k, k_scale), _dequantize(v, v_scale)
    if k.dtype == torch.float16:
        return _widened(lambda *t: _decode_fwd_torch(*t, lengths, scale),
                        q, k, v)
    return _decode_fwd_torch(q, k, v, lengths, scale)


# ---------------------------------------------------------------------------
# paged decode attention (a page pool addressed through a page table)
# ---------------------------------------------------------------------------
def gather_pages(pool, table):
    """Materialize each slot's logical KV view from a paged pool:
    ``pool`` (n_pages, H, page_size, D) + ``table`` (B, P_max) int ->
    (B, H, P_max * page_size, D). Logical position ``t`` of slot ``b``
    lives at ``pool[table[b, t // ps], :, t % ps]``. Free table entries
    point at the reserved scrap page (id 0): their rows are garbage that
    per-row length masking must exclude."""
    g = pool[table.long()]                     # (B, P_max, H, ps, D)
    b, pm, h, ps, d = g.shape
    return g.transpose(1, 2).reshape(b, h, pm * ps, d)


def expand_page_scales(pool_scale, table, page_size):
    """Broadcast per-head-per-PAGE scales onto token positions:
    ``pool_scale`` (n_pages, H) + ``table`` (B, P_max) ->
    (B, H, P_max * page_size) — position ``t`` of slot ``b`` carries
    the scale of its page ``table[b, t // page_size]``. The dequant
    companion of ``gather_pages`` for an int8 pool."""
    g = pool_scale[table.long()]                # (B, P_max, H)
    return g.transpose(1, 2).repeat_interleave(int(page_size), dim=2)


#: q, k_pool, v_pool, table, lengths, out; B, H, Sq, D, page_size,
#: P_max, n_pages; scale; q strides; stream
_PAGED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the int8 instance: q, k_pool, v_pool, k_scale, v_scale, table,
#: lengths, out; the rest
_PAGED_INT8_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
#: the bf16 and float16 instances: q, q_half, k_pool, v_pool, table,
#: lengths, out; the rest
_PAGED_HALF_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [
    ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def _paged_decode_cuda(q, k_pool, v_pool, table, lengths, scale,
                       k_scale=None, v_scale=None):
    """Launch K3 (``csrc/paged_decode_attention.cu``): the instance of
    the pool's type — fp32, bf16, or with ``k_scale``/``v_scale``
    (n_pages, H) int8. q may be a strided view (the decode step's head
    split); the pools must be contiguous (n_pages, H, ps, D) and 16-byte
    aligned; table (B, P_max) and lengths (B,) contiguous int32, all on
    one card. Anything else raises — nothing is copied but a q that the
    instance does not read as it is (``_decode_instance``)."""
    quant = k_scale is not None
    name = "paged_decode_attention"
    b, h, sq, d = q.shape
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or (k_pool.shape[1], k_pool.shape[3]) != (h, d):
        raise ValueError(f"{name}: pool layout {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    n_pages, _, ps, _ = k_pool.shape
    _check_decode_inputs(name, q, k_pool, v_pool, k_scale, v_scale,
                         n_pages)
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{name}: the page pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: the page pools must start on 16-byte "
                         f"boundaries")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    for what, t, shape in (("table", table, None), ("lengths", lengths,
                                                    (b,))):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous() \
                or (shape is not None and t.shape != shape) \
                or (shape is None and (t.dim() != 2 or t.shape[0] != b)):
            raise ValueError(f"{name}: {what} must be a contiguous int32 "
                             f"tensor on {q.device} with {b} rows, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if b > 65535 or sq > 65535 * 4:
        raise ValueError(f"{name}: batch {b} / queries {sq} exceed the grid")
    name, q, out_dtype = _decode_instance(name, q, k_pool.dtype)
    q_strides = (ctypes.c_longlong * 3)(*_kernel_strides(name, q))
    out = torch.empty((b, h, sq, d), dtype=out_dtype, device=q.device)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quant else ()
    half = out_dtype in _HALF
    q_args = (q.data_ptr(), int(q.dtype == out_dtype)) if half \
        else (q.data_ptr(),)
    fn = _build.function(
        "paged_decode_attention", f"mxtt_{name}",
        _PAGED_HALF_ARGTYPES if half
        else _PAGED_INT8_ARGTYPES if quant else _PAGED_ARGTYPES)
    err = _build.launch_on(q, fn, (
        *q_args, k_pool.data_ptr(), v_pool.data_ptr(), *scales,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, sq, d,
        ps, table.shape[1], n_pages, float(scale),
        ctypes.addressof(q_strides)))
    _launches[name] += 1
    _build.check("paged_decode_attention", err, name)
    return out


def paged_decode_attention(q, k_pool, v_pool, table, lengths, scale=None,
                           k_scale=None, v_scale=None):
    """Decode attention against a PAGED KV cache.

    ``q`` is (B, H, Sq, D); ``k_pool``/``v_pool`` are the page pools
    (n_pages, H, page_size, D); ``table`` (B, P_max) int32 maps each
    slot's logical page index to a physical pool page; ``lengths`` (B,)
    int32 marks each slot's valid token prefix. The result equals
    ``decode_attention`` over the gathered per-slot view, which is what
    the plain version computes (``gather_pages`` + ``_decode_fwd_torch``,
    the reference's own jnp definition); CUDA inputs launch K3, which
    walks each slot's valid pages through the table and never loads a
    row at or past its length.

    ``k_scale``/``v_scale`` (n_pages, H) fp32 mark an INT8 pool: the
    plain version dequantizes the gathered view with each page's
    per-head scale (``expand_page_scales``); K3's int8 instance
    dequantizes each key in registers with its page's scales. A bf16 or
    float16 pool gives a result of its type and runs K3's instance of
    that type on the card."""
    scale = _scale(q, scale)
    if not torch.is_tensor(lengths):
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=q.device)
    if not torch.is_tensor(table):
        table = torch.as_tensor(table, dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return _paged_decode_cuda(q, k_pool, v_pool, table, lengths, scale,
                                  k_scale, v_scale)
    k = gather_pages(k_pool, table)
    v = gather_pages(v_pool, table)
    if k_scale is not None:
        ps = k_pool.shape[2]
        k = _dequantize(k, expand_page_scales(k_scale, table, ps))
        v = _dequantize(v, expand_page_scales(v_scale, table, ps))
    if k.dtype == torch.float16:
        return _widened(lambda *t: _decode_fwd_torch(*t, lengths, scale),
                        q, k, v)
    return _decode_fwd_torch(q, k, v, lengths, scale)


def chunked_prefill_attention(q, k, v, start, scale=None):
    """Attention for one PREFILL CHUNK against a cache buffer.

    ``q`` (B, H, C, D) holds the chunk's queries at global positions
    ``start + i`` (``start`` a (B,) int tensor or a scalar); ``k``/``v``
    (B, H, S, D) are each row's gathered cache holding valid keys
    ``[0, start + C)``. Row ``i`` attends keys ``[0, start + i]``: the
    causal mask in global coordinates, which also masks every
    unwritten or garbage cache position. Single-pass masked softmax,
    as in the reference (plain jnp there, plain PyTorch here)."""
    scale = _scale(q, scale)
    start = torch.as_tensor(start, device=q.device).to(torch.long)
    if start.dim() == 0:
        start = start[None]
    row = torch.arange(q.shape[2], device=q.device)[None, None, :, None]
    col = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    valid = col <= start[:, None, None, None] + row
    return _masked_attend(q, k, v, valid, scale)
