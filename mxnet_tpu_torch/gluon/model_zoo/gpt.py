"""GPT — the causal decoder family: dense and paged generation over an
fp32, bf16, float16 or int8 KV cache, with optional weight-only int8
projections, bf16 or float16 compute, multi-tick decode and batched
multi-tenant LoRA.

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py``: token plus learned
position embedding, N pre-LayerNorm blocks (q/k/v/out projections, an
erf-GELU FFN), a final LayerNorm and an untied LM head, with the same
explicit-cache generation API beside the plain ``forward``:

- ``init_cache(batch_size)`` — ``{"k": L tensors (B, H, S_max, Dh),
  "v": same, "len": (B,) int32}``, allocated ONCE.
- ``prefill(tokens, valid_length, cache, slots=...)`` — causal flash
  attention over the (bucket-padded) prompts, K/V rows written into
  the cache rows ``slots``, ``len`` set, last-valid-token logits
  returned.
- ``decode_step(tokens, cache)`` — one token per slot: its K/V written
  at the clamped position ``pos = min(len, S_max - 1)``, attention over
  ``[0, pos + 1)``, ``len`` bumped.

What differs from the JAX model: the cache is updated IN PLACE. The
reference's ``_cache_insert`` and ``c.at[slots].set`` produce new
arrays that XLA donates back into the old buffers; here they are
indexed writes into the tensors ``init_cache`` allocated, and
``prefill``/``decode_step`` keep the reference's ``(logits, cache)``
signature by returning those same tensors. PyTorch runs eagerly, so
there is no jit and no trace counter: the port's form of "no
steady-state recompiles" is "no steady-state reallocation" — the cache
tensors keep their ``data_ptr()`` across admissions and decode steps.

The PAGED cache (``init_paged_cache``) is a global pool of fixed-size
pages per layer plus a page table: ``prefill_paged`` (a whole short
prompt, ``fresh=True``, or one chunk against the gathered page view),
``decode_step_paged`` (inactive rows write into the scrap page 0),
``peek_logits_paged`` (the prefix-hit path: logits of the last cached
token, no write), ``bind_slot_paged`` and ``copy_page_paged`` (the copy
half of copy-on-write). Like the dense cache, the pool, the table and
the lengths are written in place and keep their ``data_ptr()``.

``dtype="int8"`` (either cache) stores K/V as int8 with fp32 per-head
scales beside them (``k_scale``/``v_scale``): per slot for the dense
cache, set at prefill from the prompt's amax over its padded bucket and
reused by every decode write into that slot; per PAGE for the paged
pool, set when a prefill writes the page, inherited by a page whose
first token a decode step writes from the slot's previous page, and
copied with the page by ``copy_page_paged``. The scales are written in
place like the rest of the cache.

``quantize_params`` arms weight-only int8: every block projection of
``_QUANTIZED_PROJECTIONS`` keeps an int8 copy of its weight with
per-channel scales, and the GENERATION calls (dense and paged) route
those projections through ``ops.quantized.dequant_matmul``. As in the
reference, the plain ``forward`` stays fp32.

Attention runs through ``ops.attention``: on the card, prefill and the
full forward launch K1 (``csrc/flash_attention.cu``), dense decode
launches K2 (``csrc/decode_attention.cu``) and paged decode and peek
launch K3 (``csrc/paged_decode_attention.cu``), each in its int8
instance over an int8 cache; the int8 projections launch K4
(``csrc/dequant_matmul.cu``). On the CPU each takes its plain version.
The chunked-prefill attention is plain PyTorch, as it is plain jnp in
the reference.

``cast_compute_params("bfloat16")`` arms bf16 compute: every floating
parameter gets a bf16 copy, which the generation calls read in place of
the fp32 masters (bound per call and per thread, ``bind_shadows``); the
masters stay the source of truth, and ``forward`` reads them. Types
then flow as in the reference, tensor by tensor: bf16 activations,
LayerNorm and softmax statistics in fp32, fp32 logits out; an int8
projection widens its input to fp32 and gives fp32, which promotes the
residual stream to fp32 from there on. ``init_cache``/
``init_paged_cache(dtype="bfloat16")`` hold bf16 K/V (the cache
default of a bf16 model), read by the bf16 instances of K2 and K3; K1
runs its bf16 instance on bf16 q/k/v. ``GPTModel(dtype="bfloat16")``
keeps bf16 parameters (LayerNorms fp32, as in the reference). float16
is the same with float16 in place of bf16: ``GPTModel(dtype="float16")``
(its cache defaults to float16), ``cast_compute_params("float16")`` and
``init_cache``/``init_paged_cache(dtype="float16")``, read by the
float16 instances of K1, K2 and K3.

``decode_multi``/``decode_multi_paged`` run k decode steps in one call
with no host sync between them: a row stops on the device when it emits
its eos id or spends its budget (its ``len`` then stands still, its
write lands at the frozen waterline or in scrap page 0, it re-feeds its
last token and its picks are masked out of ``emitted``).

Speculative decoding (the reference's verify closures):
``verify_step``/``verify_step_paged`` write R tokens per row above the
``len`` waterline and return the logits at all R positions (the
chunked-prefill attention with per-row ``start``; the projections take
``_proj``, so an int8 target runs K4 at M = B x R);
``advance_len``/``advance_len_paged`` move the waterline (commit, and
the draft's rollback); ``propose_tokens`` runs a draft's k chained
decode steps (K2 on the card), tokens fed on the device; and
``verify_commit``/``verify_commit_paged`` verify, apply the accept rule
(``ops.sampling``) and advance ``len`` in one call with no host sync.

Batched multi-tenant LoRA (``arm_lora``, ``set_adapter``,
``clear_adapter``): every generation call takes ``adapters=``, one bank
slot per row (0, the reserved zero adapter, is the base model), and the
armed projections add each row's low-rank delta after their product
(``ops/lora.py``). The banks are allocated once per projection for all
layers and written in place; a call gathers each row's factors once for
every layer.

Training (``parallel.TrainStep``) runs the plain ``forward``, the one
call without ``no_grad``: its attention is differentiable
(``ops.attention.flash_attention``: K1 forward, K1-bwd backward on the
card), and ``Dropout`` at ``embed_drop`` and each block's ``drop`` acts
in training mode. Every generation call keeps ``no_grad`` and builds no
graph.

The reference's tensor-parallel sharding is a later slice.
"""
from __future__ import annotations

import contextlib
import math

import numpy as onp
import torch

from ...context import resolve_device
from ...ops import attention as _att
from ...ops import lora as _lora
from ...ops import quantized as _qz
from ...ops import nn as _nn
from ...ops import sampling as _smp
from ..block import HybridBlock
from ..parameter import Parameter, bind_shadows, load_jax_params
from ..nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["GPTBlock", "GPTModel", "gpt_small", "load_jax_params"]

#: the weight-only int8 target set: every per-block projection on the
#: decode path. Embeddings, LayerNorms and the lm_head stay fp32.
_QUANTIZED_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "out_proj",
                          "ffn1", "ffn2")

#: the batched-LoRA target set (``arm_lora``): the attention projections
#: of every block. An adapter adds to a projection's pre-activation
#: output, so a projection with a fused activation (ffn1's gelu) cannot
#: take one; ffn2 can.
_LORA_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "out_proj")


def _to_pages(a, page_size):
    """Reshape a (1, H, C, Dh) chunk of K or V into page-pool layout
    (C / page_size, H, page_size, Dh) for a scatter into the pool —
    the one place the pool's page layout is encoded."""
    h, c, d = a.shape[1:]
    return a[0].reshape(h, c // page_size, page_size, d).transpose(0, 1)


def _dtype_name(dtype) -> str:
    """The name of a dtype given as a string, a numpy or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    try:
        return onp.dtype(dtype).name
    except TypeError:
        return str(dtype)


def _cache_dtype(dtype):
    """The cache's element type: float32, bfloat16, float16 or int8."""
    name = _dtype_name(dtype)
    if name in ("float32", "bfloat16", "float16", "int8"):
        return getattr(torch, name)
    raise ValueError(f"unsupported KV cache dtype {dtype!r} (float32, "
                     f"bfloat16, float16 or int8)")


def _write_quantized(pool, scales, a, idx):
    """Quantize ``a`` (rows, H, ., Dh) with its per-(row, head) amax
    scale (``kv_scale`` over the last two axes) and write both in
    place: the int8 values to ``pool[idx]``, the scales to
    ``scales[idx[0]]``."""
    s = _qz.kv_scale(a, (2, 3))
    pool[idx] = _qz.kv_quantize(a, s[:, :, None, None])
    scales[idx[0]] = s


class GPTBlock(HybridBlock):
    """Pre-norm causal transformer block with an explicit-KV decode
    path (``prefill`` / ``decode``) beside the plain ``forward``."""

    def __init__(self, units, num_heads, hidden_size=None, dropout=0.0,
                 dtype="float32"):
        super().__init__()
        if units % num_heads:
            raise ValueError("units must be divisible by num_heads")
        hidden = hidden_size or 4 * units
        self._units = units
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self.ln1 = LayerNorm(in_channels=units)
        self.q_proj = Dense(units, flatten=False, dtype=dtype, in_units=units)
        self.k_proj = Dense(units, flatten=False, dtype=dtype, in_units=units)
        self.v_proj = Dense(units, flatten=False, dtype=dtype, in_units=units)
        self.out_proj = Dense(units, flatten=False, dtype=dtype,
                              in_units=units)
        self.ln2 = LayerNorm(in_channels=units)
        self.ffn1 = Dense(hidden, activation="gelu", flatten=False,
                          dtype=dtype, in_units=units)
        self.ffn2 = Dense(units, flatten=False, dtype=dtype, in_units=hidden)
        self.drop = Dropout(dropout) if dropout else None
        #: ``{proj_name: (int8 weight, fp32 scales)}`` while a generation
        #: call of a quantized model runs (``GPTModel._bound``); None
        #: keeps every projection on its Dense
        self._qbind = None
        #: ``{proj_name: (A, B, scale) gathered per row}`` while a
        #: generation call of a LoRA-armed model runs; None adds no delta
        self._lbind = None

    def _split(self, x):
        """(B, S, U) -> (B, H, S, Dh), a strided view (no copy)."""
        b, s, _ = x.shape
        return x.reshape(b, s, self._num_heads,
                         self._head_dim).transpose(1, 2)

    def _merge(self, out):
        b, h, s, d = out.shape
        return out.transpose(1, 2).reshape(b, s, h * d)

    def _proj(self, name, x):
        """One projection: the Dense, or — when the bound quant table
        carries ``name`` — the fused dequant-matmul over its int8 weight
        (K4 on the card, which adds the Dense's bias in its epilogue).
        The activation follows the Dense's own, after the product, so
        the two paths differ only in the weight rounding. The int8 path
        computes in fp32 whatever x's type (the reference casts x to
        fp32), and a bf16 bias joins it widened, as jnp promotes it.
        A LoRA-armed call then adds each row's low-rank delta, in fp32,
        after the bias (``ops.lora``; the targets carry no activation),
        where the reference adds it."""
        layer = getattr(self, name)
        q = self._qbind.get(name) if self._qbind else None
        if q is None:
            y = layer(x)
        else:
            bias = layer.bias._read() if layer.bias is not None else None
            y = _qz.dequant_matmul(x, *q, bias=bias)
            if layer._act_type is not None:
                y = _nn.activation(y, layer._act_type)
        rows = self._lbind.get(name) if self._lbind else None
        return y if rows is None else _lora.apply_rows(y, x, *rows)

    def _qkv(self, x):
        h = self.ln1(x)
        return (self._split(self._proj("q_proj", h)),
                self._split(self._proj("k_proj", h)),
                self._split(self._proj("v_proj", h)))

    def _finish(self, x, attn):
        y = self._proj("out_proj", self._merge(attn))
        if self.drop is not None:
            y = self.drop(y)
        x = x + y
        y = self._proj("ffn2", self._proj("ffn1", self.ln2(x)))
        if self.drop is not None:
            y = self.drop(y)
        return x + y

    def forward(self, x):
        q, k, v = self._qkv(x)
        return self._finish(x, _att.flash_attention(q, k, v, causal=True))

    def prefill(self, x):
        """Causal attention over the (padded) prompt; returns the block
        output and the raw K/V rows to write into the cache."""
        q, k, v = self._qkv(x)
        attn = _att.flash_attention(q, k, v, True, None)
        return self._finish(x, attn), (k, v)

    def decode(self, x, k_cache, v_cache, pos, att_len, k_scale=None,
               v_scale=None):
        """One decode step: write this token's K/V at ``pos`` (B,) of
        each row IN PLACE, attend over the valid prefix ``[0,
        att_len)``. Returns the block output and the (same) buffers.
        ``k_scale``/``v_scale`` (B, H) mark an INT8 cache: the new token
        quantizes against its slot's per-head scale (fixed at prefill)
        and attention dequantizes in the kernel (K2's int8 instance on
        the card)."""
        q, k, v = self._qkv(x)
        rows = torch.arange(x.shape[0], device=x.device)
        if k_scale is not None:
            k_cache[rows, :, pos] = _qz.kv_quantize(k[:, :, 0],
                                                    k_scale[:, :, None])
            v_cache[rows, :, pos] = _qz.kv_quantize(v[:, :, 0],
                                                    v_scale[:, :, None])
        else:
            k_cache[rows, :, pos] = k[:, :, 0].to(k_cache.dtype)
            v_cache[rows, :, pos] = v[:, :, 0].to(v_cache.dtype)
        attn = _att.decode_attention(q, k_cache, v_cache, att_len,
                                     k_scale=k_scale, v_scale=v_scale)
        return self._finish(x, attn), k_cache, v_cache

    def verify(self, x, k_cache, v_cache, pos, start, k_scale=None,
               v_scale=None):
        """One speculative VERIFY step: write R tokens' K/V IN PLACE at
        the contiguous positions ``[pos, pos + R)`` of each row, then
        attend all R queries over the global causal mask in one pass
        (``chunked_prefill_attention`` with per-row ``start``, each
        row's committed length). The caller keeps ``pos + R <= S_max``
        (the engine's ``spec_k`` margin); past it the write starts at
        ``S_max - R``, as the reference's dynamic update slice clamps.
        ``k_scale``/``v_scale`` (B, H) mark an INT8 cache: the writes
        quantize against the slot's prefill scale and the attention
        view dequantizes with it. Returns the block output and the
        (same) buffers."""
        q, k, v = self._qkv(x)
        b, r = x.shape[0], x.shape[1]
        rows = torch.arange(b, device=x.device)[:, None]
        cols = pos.long().clamp(max=k_cache.shape[2] - r)[:, None] \
            + torch.arange(r, device=x.device)
        if k_scale is None:
            k_cache[rows, :, cols] = k.transpose(1, 2).to(k_cache.dtype)
            v_cache[rows, :, cols] = v.transpose(1, 2).to(v_cache.dtype)
            kf, vf = k_cache, v_cache
        else:
            ks, vs = k_scale[:, :, None, None], v_scale[:, :, None, None]
            k_cache[rows, :, cols] = _qz.kv_quantize(k, ks).transpose(1, 2)
            v_cache[rows, :, cols] = _qz.kv_quantize(v, vs).transpose(1, 2)
            kf, vf = k_cache.float() * ks, v_cache.float() * vs
        attn = _att.chunked_prefill_attention(q, kf.to(q.dtype),
                                              vf.to(q.dtype), start)
        return self._finish(x, attn), k_cache, v_cache

    # -- paged-cache generation ----------------------------------------
    def decode_paged(self, x, k_pool, v_pool, table, page, offset,
                     att_len, k_scale=None, v_scale=None, prev_page=None):
        """One decode step against a PAGED cache: write this token's K/V
        into pool page ``page[b]`` at row ``offset[b]`` IN PLACE, attend
        over each row's valid pages through the table (K3 on the card).
        Inactive rows arrive with ``page == 0`` (the scrap page): a free
        slot's table row may alias pages another slot owns, so its
        write is redirected, never masked after the fact. Several
        inactive rows then write the same scrap row in one
        ``index_put``; which value lands there is unspecified, and
        nothing reads that row as valid.

        ``k_scale``/``v_scale`` (n_pages, H) mark an INT8 pool. The
        write page's per-head scale quantizes the new token; a FRESH
        page (``offset == 0``) inherits ``prev_page``'s scale (the
        page's later tokens share it; a recycled page's stale scale
        never leaks in). Both scales are read before the write page's
        scale is written, and the scale write rides the same scrap-page
        redirect as the data: inactive rows write page 0's own scale
        back into it."""
        q, k, v = self._qkv(x)
        if k_scale is not None:
            fresh = (offset == 0)[:, None]
            for pool, sc, a in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
                eff = torch.where(fresh, sc[prev_page], sc[page])
                sc[page] = eff
                pool[page, :, offset] = _qz.kv_quantize(a[:, :, 0],
                                                        eff[:, :, None])
        else:
            k_pool[page, :, offset] = k[:, :, 0].to(k_pool.dtype)
            v_pool[page, :, offset] = v[:, :, 0].to(v_pool.dtype)
        attn = _att.paged_decode_attention(q, k_pool, v_pool, table,
                                           att_len, k_scale=k_scale,
                                           v_scale=v_scale)
        return self._finish(x, attn)

    def prefill_chunk(self, x, k_pool, v_pool, pages, page_ids, start,
                      k_scale=None, v_scale=None):
        """One prefill CHUNK against a paged cache: scatter the chunk's
        K/V into its pool pages ``page_ids`` IN PLACE, then attend the
        chunk's queries over the slot's whole gathered view (shared
        prefix pages, earlier chunks and this one) under the causal
        mask in global coordinates (``start`` is the chunk's first
        position). ``k_scale``/``v_scale`` (n_pages, H) mark an INT8
        pool: each written page gets its own per-head amax scale, and
        the gathered view dequantizes every page, shared-prefix pages
        included, with the scale it was written under."""
        q, k, v = self._qkv(x)
        ps = k_pool.shape[2]
        if k_scale is None:
            k_pool[page_ids] = _to_pages(k, ps).to(k_pool.dtype)
            v_pool[page_ids] = _to_pages(v, ps).to(v_pool.dtype)
            kg = _att.gather_pages(k_pool, pages[None]).to(q.dtype)
            vg = _att.gather_pages(v_pool, pages[None]).to(q.dtype)
        else:
            _write_quantized(k_pool, k_scale, _to_pages(k, ps), (page_ids,))
            _write_quantized(v_pool, v_scale, _to_pages(v, ps), (page_ids,))
            kg, vg = (_att.gather_pages(pool, pages[None]).float()
                      * _att.expand_page_scales(sc, pages[None], ps)[
                          ..., None]
                      for pool, sc in ((k_pool, k_scale), (v_pool, v_scale)))
        attn = _att.chunked_prefill_attention(q, kg, vg, start)
        return self._finish(x, attn)

    def verify_paged(self, x, k_pool, v_pool, table, page, offset, start,
                     k_scale=None, v_scale=None, fresh=None,
                     anchor_page=None):
        """Speculative VERIFY against a PAGED cache: scatter R tokens'
        K/V per row IN PLACE into pool pages ``page``/``offset`` (B, R)
        — inactive rows and positions past a slot's reservation arrive
        redirected to scrap page 0, the decode-write discipline — then
        attend the R queries over each row's gathered table view under
        the global causal mask (``chunked_prefill_attention`` with
        per-row ``start``).

        ``k_scale``/``v_scale`` (n_pages, H) mark an INT8 pool:
        ``fresh`` (B, R) flags positions whose page holds no committed
        token yet — they quantize (and stamp the page) with
        ``anchor_page``'s scale (the page of the row's last committed
        token), ``decode_paged``'s predecessor rule for a
        multi-position write; the other positions reuse their page's
        scale. Both scales are read before any is written."""
        q, k, v = self._qkv(x)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)    # (B, R, H, Dh)
        ps = k_pool.shape[2]
        if k_scale is None:
            k_pool[page, :, offset] = kt.to(k_pool.dtype)
            v_pool[page, :, offset] = vt.to(v_pool.dtype)
            kg = _att.gather_pages(k_pool, table).to(q.dtype)
            vg = _att.gather_pages(v_pool, table).to(q.dtype)
        else:
            for pool, sc, a in ((k_pool, k_scale, kt), (v_pool, v_scale, vt)):
                eff = torch.where(fresh[..., None],
                                  sc[anchor_page][:, None, :], sc[page])
                sc[page] = eff
                pool[page, :, offset] = _qz.kv_quantize(a, eff[..., None])
            kg, vg = (_att.gather_pages(pool, table).float()
                      * _att.expand_page_scales(sc, table, ps)[..., None]
                      for pool, sc in ((k_pool, k_scale), (v_pool, v_scale)))
        attn = _att.chunked_prefill_attention(q, kg, vg, start)
        return self._finish(x, attn)

    def peek_paged(self, x, k_pool, v_pool, table, att_len, k_scale=None,
                   v_scale=None):
        """Logits-only attention for the LAST already-cached token of
        one slot (its K/V, its own included, is in the pool): no write,
        cache untouched — the prefix-hit path."""
        q, _k, _v = self._qkv(x)
        attn = _att.paged_decode_attention(q, k_pool, v_pool, table,
                                           att_len, k_scale=k_scale,
                                           v_scale=v_scale)
        return self._finish(x, attn)


class GPTModel(HybridBlock):
    """Decoder-only transformer LM: token + learned position
    embeddings -> N pre-norm ``GPTBlock``s -> final LayerNorm -> LM
    head. ``forward`` gives full-sequence logits; ``init_cache`` /
    ``prefill`` / ``decode_step`` are the generation path.

    ``device`` defaults to the CUDA card and raises without one (pass
    ``device="cpu"`` for the CPU). Parameters are allocated on it
    uninitialized: call :meth:`initialize` (numpy-seeded) or
    :func:`load_jax_params` before use."""

    def __init__(self, vocab_size, units=256, num_layers=4, num_heads=4,
                 hidden_size=None, max_length=256, dropout=0.0,
                 dtype="float32", device=None):
        dtype = _dtype_name(dtype)
        dev = resolve_device(device)
        super().__init__()
        self._vocab_size = vocab_size
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._max_length = max_length
        self._dtype = dtype
        #: per-block ``{proj_name: (int8 weight, fp32 scales)}`` once
        #: ``quantize_params`` armed weight-only int8, else None
        self._quant = None
        #: ``{Parameter: bf16 or float16 copy}`` once
        #: ``cast_compute_params`` armed reduced-precision compute, else
        #: None; ``_cast_dtype`` names its type
        self._cast = None
        self._cast_dtype = None
        #: batched LoRA (``arm_lora``): per projection name, the stacked
        #: banks of every layer ``{"A": (n, L, d_in, r), "B": (n, L, r,
        #: d_out)}`` and one ``(n,)`` scale; ``_lora`` is the reference's
        #: per-block ``{proj: bank}`` view of them
        self._lora_stack = None
        self._lora_scale = None
        self._lora = None
        self._lora_meta = None   # (n_adapters, rank, include)
        #: the all-base (B,) index vector, one per batch size
        self._lora_zero_idx: dict = {}
        with dev:
            self.word_embed = Embedding(vocab_size, units, dtype=dtype)
            self.position_weight = Parameter(
                "position_weight", shape=(max_length, units), dtype=dtype)
            self.embed_drop = Dropout(dropout) if dropout else None
            self.layers = HybridSequential()
            for _ in range(num_layers):
                self.layers.add(GPTBlock(units, num_heads,
                                         hidden_size=hidden_size,
                                         dropout=dropout, dtype=dtype))
            self.ln_f = LayerNorm(in_channels=units)
            self.lm_head = Dense(vocab_size, use_bias=False, flatten=False,
                                 dtype=dtype, in_units=units)

    @property
    def max_length(self):
        return self._max_length

    @property
    def device(self) -> torch.device:
        return self.position_weight._var().device

    @property
    def quantized(self) -> bool:
        """True once ``quantize_params`` armed the weight-only int8
        generation path."""
        return self._quant is not None

    def quantize_params(self, include=_QUANTIZED_PROJECTIONS):
        """Arm (or refresh) weight-only int8 generation: quantize every
        ``include`` projection of every block per output channel
        (``ops.quantized.quantize_channelwise``, bitwise the
        reference's tables) on the model's device, and route the
        generation calls' projections through the fused dequant-matmul.
        Embeddings, LayerNorms and the lm_head stay fp32, and the plain
        ``forward`` is untouched: the fp32 parameters remain the source
        of truth. Call it again after moving the model to another
        device. Returns self."""
        tabs = []
        for blk in self._blocks():
            tab = {}
            for name in include:
                layer = getattr(blk, name, None)
                if not isinstance(layer, Dense):
                    raise ValueError(
                        f"unknown quantizable projection {name!r} "
                        f"(choose from {_QUANTIZED_PROJECTIONS})")
                tab[name] = _qz.quantize_channelwise(layer.weight._read())
            tabs.append(tab)
        self._quant = tabs
        if self._cast is not None:   # which biases it widens follows _quant
            self.cast_compute_params(self._cast_dtype)
        return self

    @property
    def compute_dtype(self) -> str:
        """The generation calls' parameter and activation type:
        ``"float32"`` (the parameters as they are), or ``"bfloat16"`` /
        ``"float16"`` once :meth:`cast_compute_params` armed it."""
        return self._cast_dtype or "float32"

    def cast_compute_params(self, dtype="bfloat16"):
        """Arm (or refresh) reduced-precision compute: cast every
        floating parameter to ``dtype`` (bf16 or float16) into copies
        that the generation calls read in place of the fp32 masters,
        which stay the source of truth (``forward``, ``quantize_params``
        and re-casts read them). Call it again after changing the
        weights. LayerNorm and softmax statistics still accumulate in
        fp32 and every generation call returns fp32 logits. Composes
        with an int8 KV cache and with weight-only int8 (the quantized
        projections keep their tables; the other parameters are what
        this casts, and a quantized projection's bias, which only its
        fp32 product reads, is held rounded and widened back, so K4 adds
        it in its epilogue as jnp adds a bf16 bias to an fp32 product).
        ``None`` disarms, after which the generation calls are bitwise
        what they were. The reference's model takes float16 here and
        its engine refuses it, as the port's does. Returns self."""
        if dtype is None:
            self._cast = self._cast_dtype = None
            return self
        name = _dtype_name(dtype)
        if name not in ("bfloat16", "float16"):
            raise ValueError(f"compute dtype {dtype!r} not supported "
                             f"(bfloat16 or float16)")
        dt = getattr(torch, name)
        widened = {getattr(blk, n).bias for blk, tab in
                   zip(self._blocks(), self._quant or ()) for n in tab}
        cast = {}
        for p in self.collect_params().values():
            t = p._read()
            if t.is_floating_point():
                t = t.to(dt)
                if p in widened:
                    t = t.float()
            cast[p] = t
        self._cast = cast
        self._cast_dtype = name
        return self

    def quantized_param_stats(self):
        """``(n_elements, bytes_saved)`` of the current quant tables
        (fp32 -> int8 saves 3 bytes per element; the per-channel scales
        are counted against the saving)."""
        if self._quant is None:
            return 0, 0
        n = sum(wq.numel() for tab in self._quant for wq, _s in tab.values())
        scale_bytes = sum(s.numel() * 4 for tab in self._quant
                          for _wq, s in tab.values())
        return n, n * 3 - scale_bytes

    @contextlib.contextmanager
    def _bound(self, adapters, batch):
        """Bind, for the duration of one generation call (the
        reference's ``_make_bind``): the reduced-precision copies of the
        parameters (on this thread only), each block's int8 tables, and
        on a LoRA-armed model each row's adapter factors (``adapters``,
        one bank index per row of the call's ``batch``; None is all
        base). The factors are gathered once per call for every layer,
        one gather per stacked bank, and each block reads its layer's
        view. An fp32 model binds nothing."""
        with bind_shadows(self._cast):
            if self._quant is None and self._lora is None:
                yield
                return
            blocks = self._blocks()
            for blk, tab in zip(blocks, self._quant or ()):
                blk._qbind = tab
            if self._lora is not None:
                idx = self._lora_idx(adapters, batch)
                s = self._lora_scale[idx]
                rows = {name: (st["A"][idx], st["B"][idx])
                        for name, st in self._lora_stack.items()}
                for li, blk in enumerate(blocks):
                    blk._lbind = {name: (a[:, li], b[:, li], s)
                                  for name, (a, b) in rows.items()}
            try:
                yield
            finally:
                for blk in blocks:
                    blk._qbind = blk._lbind = None

    def _blocks(self):
        return list(self.layers._modules.values())

    # -- batched multi-tenant LoRA (ops/lora.py; serving/generate.py) ---
    @property
    def lora_armed(self) -> bool:
        """True once ``arm_lora`` allocated the stacked adapter banks."""
        return self._lora is not None

    def arm_lora(self, n_adapters, rank, include=_LORA_PROJECTIONS):
        """Arm batched multi-tenant LoRA: allocate all-zeros stacked
        adapter banks (``n_adapters`` slots, slot 0 reserved as the
        base-model zero adapter) for every ``include`` projection of
        every block on the model's device, and route the generation
        calls' projections through the per-row delta ``y += (x @
        A[idx]) @ B[idx] * scale[idx]`` (``ops/lora.py``). The banks are
        allocated once: :meth:`set_adapter` and :meth:`clear_adapter`
        write into them, and arming again with the same ``n_adapters``,
        ``rank`` and ``include`` keeps them. The plain ``forward`` is
        untouched. Returns self."""
        include = tuple(include)
        if not include:
            raise ValueError("arm_lora needs at least one projection")
        blk0 = self._blocks()[0]
        for name in include:
            probe = getattr(blk0, name, None)
            if not isinstance(probe, Dense):
                raise ValueError(
                    f"unknown LoRA projection {name!r} (choose from "
                    f"{_LORA_PROJECTIONS + ('ffn2',)}; ffn1 carries "
                    f"a fused activation and cannot take the delta)")
            if probe._act_type is not None:
                raise ValueError(
                    f"LoRA projection {name!r} carries a fused "
                    f"activation: the low-rank delta must add to the "
                    f"pre-activation output (choose projections "
                    f"without one, e.g. {_LORA_PROJECTIONS})")
        meta = (int(n_adapters), int(rank), tuple(sorted(include)))
        if self._lora_meta == meta:
            return self
        n_layers = len(self._blocks())
        stack = {}
        for name in meta[2]:
            d_out, d_in = getattr(blk0, name).weight.shape
            stack[name] = _lora.init_layers(meta[0], n_layers, d_in, d_out,
                                            meta[1], device=self.device)
        # one scale vector (alpha / rank is per adapter) for every bank
        scale = stack[meta[2][0]]["scale"]
        for st in stack.values():
            st["scale"] = scale
        self._lora_stack, self._lora_scale = stack, scale
        self._lora = [{name: {"A": st["A"][:, li], "B": st["B"][:, li],
                              "scale": scale}
                       for name, st in stack.items()}
                      for li in range(n_layers)]
        self._lora_meta = meta
        return self

    def set_adapter(self, idx, params, alpha=1.0):
        """Install one tenant's LoRA factors into bank slot ``idx``
        (1-based; slot 0 is the reserved base adapter), in place.
        ``params`` is a flat mapping ``{"layers.<li>.<proj>.A": (d_in,
        rank), "layers.<li>.<proj>.B": (rank, d_out)}`` covering exactly
        the armed include set of every block; ``alpha`` is the adapter's
        scaling numerator (applied as ``alpha / rank``). Coverage,
        shapes and finiteness are checked on the host before any slot
        is touched, so a bad adapter never leaves the bank half
        written. Returns self."""
        if self._lora is None:
            raise RuntimeError("set_adapter before arm_lora")
        n, rank, include = self._lora_meta
        expect = {f"layers.{li}.{name}.{half}"
                  for li in range(len(self._lora))
                  for name in include for half in ("A", "B")}
        got = set(params)
        if got != expect:
            missing = sorted(expect - got)[:3]
            extra = sorted(got - expect)[:3]
            raise ValueError(
                f"adapter params must cover the armed include set "
                f"exactly (missing {missing}, unexpected {extra})")
        host = {}
        for key in sorted(got):
            v = params[key]
            v = v.detach().cpu().numpy() if torch.is_tensor(v) \
                else onp.asarray(v)
            li, name, half = key.split(".")[1:]
            bank = self._lora[int(li)][name]
            want = tuple(bank[half].shape[1:])
            if v.shape != want:
                raise ValueError(f"adapter {half} shape {v.shape} != bank "
                                 f"slot shape {want} ({key!r})")
            if not bool(onp.isfinite(v).all()):
                raise ValueError(
                    f"adapter param {key!r} contains non-finite values "
                    f"— a NaN/inf factor would poison every request "
                    f"bound to this slot; rejected before any install")
            host[key] = v
        for li, tab in enumerate(self._lora):
            for name in include:
                _lora.set_slot(tab[name], idx, host[f"layers.{li}.{name}.A"],
                               host[f"layers.{li}.{name}.B"], alpha)
        return self

    def clear_adapter(self, idx):
        """Zero bank slot ``idx`` back to the base (no-op) adapter, in
        place. Returns self."""
        if self._lora is None:
            raise RuntimeError("clear_adapter before arm_lora")
        for tab in self._lora:
            for bank in tab.values():
                _lora.clear_slot(bank, idx)
        return self

    def lora_bank_bytes(self) -> int:
        """Device bytes of the armed adapter banks as the reference
        counts them (each bank's A, B and scale); 0 when unarmed."""
        return _lora.bank_bytes(self._lora) if self._lora else 0

    def _lora_idx(self, adapters, batch):
        """A per-row adapter-index vector on the model's device:
        ``None`` means all base (index 0, the reserved zero adapter; the
        constant vector is cached per batch size, not made anew per
        step)."""
        b = int(batch)
        if adapters is None:
            z = self._lora_zero_idx.get(b)
            if z is None:
                z = self._lora_zero_idx.setdefault(
                    b, torch.zeros((b,), dtype=torch.long,
                                   device=self.device))
            return z
        idx = adapters if torch.is_tensor(adapters) \
            else torch.as_tensor(onp.asarray(adapters, "i8"))
        idx = idx.to(self.device, torch.long, non_blocking=True).reshape(-1)
        if idx.shape[0] != b:
            raise ValueError(
                f"adapters must be one index per row ({b}), got shape "
                f"{tuple(idx.shape)}")
        return idx

    def initialize(self, seed=0):
        """Fill every parameter from ``numpy.random.RandomState(seed)``:
        weights Xavier-uniform (MXNet's default ``Xavier()``: factor
        "avg", magnitude 3, i.e. U(-a, a) with a = sqrt(3 / ((fan_in +
        fan_out) / 2))), biases and LayerNorm betas 0, gammas 1.
        Returns self."""
        rng = onp.random.RandomState(seed)
        for name, p in self.collect_params().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "beta"):
                arr = onp.zeros(p.shape, "f4")
            elif leaf == "gamma":
                arr = onp.ones(p.shape, "f4")
            else:
                fan_out, fan_in = p.shape[0], p.shape[1]
                a = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
                arr = rng.uniform(-a, a, size=p.shape).astype("f4")
            p.set_data(torch.from_numpy(arr))
        return self

    def _as_tokens(self, tokens):
        if not torch.is_tensor(tokens):
            tokens = torch.as_tensor(onp.asarray(tokens))
        return tokens.to(self.device, torch.long)

    def _embed(self, tokens):
        x = self.word_embed(tokens)
        x = x + self.position_weight._read()[:tokens.shape[-1]]
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        return x

    def forward(self, tokens):
        """Full-sequence logits. Differentiable: ``parallel.TrainStep``
        binds the leaves it differentiates in place of the parameters
        (``bind_shadows``); its attention is ``flash_attention``, whose
        backward is K1-bwd on the card. Dropout acts in training mode.
        Called on the parameters themselves it builds no graph (they do
        not require grad)."""
        tokens = self._as_tokens(tokens)
        x = self._embed(tokens)
        for blk in self._blocks():
            x = blk(x)
        return self.lm_head(self.ln_f(x))

    # -- generation API ------------------------------------------------
    def init_cache(self, batch_size, max_length=None, dtype=None):
        """Preallocated fixed-shape KV cache for ``batch_size`` slots:
        ``{"k": tuple of L (B, H, S_max, Dh) tensors, "v": same, "len":
        (B,) int32}`` on the model's device, all zeros. ``prefill`` and
        ``decode_step`` update it in place. ``dtype`` defaults to the
        model's parameter type; ``"bfloat16"`` holds bf16 K/V.

        ``dtype="int8"`` allocates a QUANTIZED cache (a quarter of the
        K/V bytes of fp32) with ``k_scale``/``v_scale`` tuples of L
        (B, H) fp32 per-slot-per-head scales, set at prefill from each
        prompt's amax and reused by every decode write into that
        slot."""
        s = int(max_length) if max_length is not None else self._max_length
        if not 1 <= s <= self._max_length:
            raise ValueError(
                f"cache max_length {s} out of range (position table "
                f"holds {self._max_length})")
        dt = _cache_dtype(dtype if dtype is not None else self._dtype)
        b = int(batch_size)
        shape = (b, self._num_heads, s, self._head_dim)
        cache = {"k": self._zeros(shape, dt), "v": self._zeros(shape, dt),
                 "len": torch.zeros((b,), dtype=torch.int32,
                                    device=self.device)}
        if dt == torch.int8:
            cache["k_scale"] = self._zeros((b, self._num_heads))
            cache["v_scale"] = self._zeros((b, self._num_heads))
        return cache

    def _zeros(self, shape, dtype=torch.float32):
        """One zero tensor of ``shape`` per layer, on the model's
        device."""
        return tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                     for _ in range(self._num_layers))

    def _kv_scales(self, cache):
        """The cache's per-layer ``(k_scale, v_scale)`` tuples, or L
        Nones each for an fp32 cache."""
        if "k_scale" in cache:
            return cache["k_scale"], cache["v_scale"]
        return (None,) * self._num_layers, (None,) * self._num_layers

    @torch.no_grad()
    def prefill(self, tokens, valid_length, cache, slots=None, adapters=None):
        """Run the (padded) prompts ``tokens`` (B_req, S_bucket) through
        the model, write their K/V into ``cache`` rows ``slots`` (default
        ``0..B_req-1``), set ``len`` to ``valid_length``. Returns
        ``(last_logits, cache)`` — fp32 ``(B_req, vocab)`` logits of each
        row's last valid token and the same cache, updated in place.
        ``adapters`` (B_req,) selects each row's LoRA bank slot on an
        armed model (every generation call takes it; None is the base
        model)."""
        tokens = self._as_tokens(tokens)
        if tokens.dim() != 2:
            raise ValueError(f"prefill tokens must be (batch, seq), got "
                             f"shape {tuple(tokens.shape)}")
        s_max = cache["k"][0].shape[2]
        b, sb = tokens.shape
        if sb > s_max:
            raise ValueError(
                f"prompt bucket {sb} exceeds cache max_length {s_max}")
        dev = self.device
        valid_len = torch.as_tensor(onp.asarray(valid_length)).to(
            dev, torch.int32).reshape(b)
        slots = torch.arange(b, device=dev) if slots is None else \
            torch.as_tensor(onp.asarray(slots)).to(dev, torch.long)
        with self._bound(adapters, b):
            x = self._embed(tokens)
            for blk, kc, vc, ks, vs in zip(self._blocks(), cache["k"],
                                           cache["v"],
                                           *self._kv_scales(cache)):
                x, (k, v) = blk.prefill(x)
                if ks is None:
                    kc[slots, :, :sb] = k.to(kc.dtype)
                    vc[slots, :, :sb] = v.to(vc.dtype)
                else:
                    # per-slot-per-head scales from the prompt's amax
                    # over the padded bucket (the pad rows contribute,
                    # as in the reference)
                    idx = (slots, slice(None), slice(None, sb))
                    _write_quantized(kc, ks, k, idx)
                    _write_quantized(vc, vs, v, idx)
            # logits of the LAST VALID prompt token (predicts token 1)
            idx = (valid_len.long() - 1).clamp(0, sb - 1)
            last = x[torch.arange(b, device=dev), idx][:, None, :]
            logits = self.lm_head(self.ln_f(last))
        cache["len"][slots] = valid_len
        return logits[:, 0, :].float(), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache, adapters=None):
        """One greedy-decoding step for EVERY cache slot: write the K/V
        of ``tokens`` (B,) at each row's clamped position, attend over
        the valid prefix, bump ``len``. Returns ``(logits, cache)`` —
        fp32 ``(B, vocab)`` next-token logits and the same cache,
        updated in place. Rows of free slots produce logits that callers
        ignore: the batch shape never changes with occupancy."""
        tokens = self._as_tokens(tokens)
        with self._bound(adapters, tokens.shape[0]):
            return self._decode_body(tokens, cache)

    def _decode_body(self, tokens, cache, live=None):
        """One decode step's computation, under ``_bound`` (shared by
        ``decode_step`` and ``decode_multi``'s loop). ``live`` (B,) bool,
        when given, freezes dead rows: their ``len`` stands still, so
        their (fixed-shape) cache write lands at the frozen waterline,
        above which nothing is attended; without it every row
        advances."""
        s_max = cache["k"][0].shape[2]
        ln = cache["len"]
        pos = ln.clamp(max=s_max - 1).long()   # clamped write position
        att_len = (pos + 1).to(torch.int32)    # incl. the new token
        emb = self.word_embed(tokens)          # (B, U)
        x = (emb + self.position_weight._read()[pos])[:, None, :]
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        for blk, kc, vc, ks, vs in zip(self._blocks(), cache["k"],
                                       cache["v"], *self._kv_scales(cache)):
            x, _, _ = blk.decode(x, kc, vc, pos, att_len, ks, vs)
        logits = self.lm_head(self.ln_f(x))    # (B, 1, V)
        ln += 1 if live is None else live.to(torch.int32)
        return logits[:, 0, :].float(), cache

    # -- multi-tick decode ---------------------------------------------
    @torch.no_grad()
    def decode_multi(self, tokens, budgets, cache, k, generators, temps,
                     top_ks, top_ps, eos_ids, adapters=None):
        """``k`` decode steps for every cache slot in one call, with no
        host sync between them (the reference's fused scan). A row stops
        on the device once it emits ``eos_ids[row]`` (-1: no eos) or its
        ``budgets[row]`` runs out; a stopped row rides along in the
        fixed-shape batch with its ``len`` frozen (its write lands at the
        frozen waterline, never attended), re-feeds its last token, and
        its picks are masked out of ``emitted``. A row whose budget is 0
        on entry never runs (a free slot). Greedy rows (``temps <= 0``)
        take the argmax of the raw logits, as ``decode_step``'s caller
        does; when a row samples, every step calls
        ``ops.sampling.sample_tokens``, which advances each sampled
        row's ``generators[row]`` once per step, as one engine tick at
        k = 1 does, so a seeded stream is the same for every k. The
        knobs (``temps``, ``top_ks``, ``top_ps``, ``budgets``,
        ``eos_ids``) are host arrays (B,). Returns ``(tokens (B, k)
        int32, emitted (B, k) bool, generators, cache)``: row i emitted
        ``tokens[i, :emitted[i].sum()]`` (the live mask is monotone);
        the cache is updated in place."""
        return self._multi(False, tokens, budgets, cache, k, generators,
                           temps, top_ks, top_ps, eos_ids, adapters)

    @torch.no_grad()
    def decode_multi_paged(self, tokens, budgets, cache, k, generators,
                           temps, top_ks, top_ps, eos_ids, adapters=None):
        """Paged-cache :meth:`decode_multi`: the same steps and stop
        rule, a stopped row's write redirected into scrap page 0 as
        ``decode_step_paged`` does for an inactive row (``len`` frozen,
        table untouched)."""
        return self._multi(True, tokens, budgets, cache, k, generators,
                           temps, top_ks, top_ps, eos_ids, adapters)

    def _multi(self, paged, tokens, budgets, cache, k, generators, temps,
               top_ks, top_ps, eos_ids, adapters):
        dev = self.device
        cur = self._as_tokens(tokens)
        budget = torch.as_tensor(onp.asarray(budgets, "i4")).to(dev)
        eos = torch.as_tensor(onp.asarray(eos_ids, "i4")).to(dev)
        temps = onp.asarray(temps, "f4").reshape(-1)
        sampled = bool((temps > 0).any())
        live = budget > 0
        toks, emits = [], []
        with self._bound(adapters, cur.shape[0]):
            for _ in range(int(k)):
                if paged:
                    logits, cache = self._decode_body_paged(cur, live, cache)
                else:
                    logits, cache = self._decode_body(cur, cache, live)
                tok = _smp.sample_tokens(generators, logits, temps, top_ks,
                                         top_ps) if sampled \
                    else logits.argmax(dim=-1)
                # a stopped row re-feeds its last token
                tok = torch.where(live, tok, cur)
                emits.append(live)
                budget = budget - live.to(torch.int32)
                live = live & (tok != eos) & (budget > 0)
                toks.append(tok)
                cur = tok
        return (torch.stack(toks, 1).to(torch.int32), torch.stack(emits, 1),
                generators, cache)

    # -- speculative decoding ------------------------------------------
    def _verify_embed(self, tokens, pos):
        x = self.word_embed(tokens) + self.position_weight._read()[pos]
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        return x

    def _verify_body(self, tokens, cache):
        """The dense R-token verify computation, under ``_bound``: write
        R tokens per row at ``[len, len + R)``, attend all R queries
        under the global causal mask; returns (B, R, V) fp32 logits with
        ``len`` unchanged."""
        r = tokens.shape[1]
        ln = cache["len"]
        # a dead row's len may sit past the margin: its (unread) logits
        # take the last position's embedding instead of reading past
        # the table
        pos = (ln.long()[:, None] + torch.arange(r, device=ln.device)) \
            .clamp(max=cache["k"][0].shape[2] - 1)
        x = self._verify_embed(tokens, pos)
        for blk, kc, vc, ks, vs in zip(self._blocks(), cache["k"],
                                       cache["v"], *self._kv_scales(cache)):
            x, _, _ = blk.verify(x, kc, vc, ln, ln, ks, vs)
        return self.lm_head(self.ln_f(x)).float()

    def _verify_body_paged(self, tokens, live, cache):
        """The paged R-token verify computation, under ``_bound``:
        scatter each live row's R tokens through its page table (other
        rows write scrap page 0), attend the gathered view; returns
        (B, R, V) fp32 logits with ``len`` unchanged."""
        b, r = tokens.shape
        ps = cache["k"][0].shape[2]
        table, ln = cache["table"], cache["len"]
        s_max = table.shape[1] * ps
        rows = torch.arange(b, device=ln.device)
        pos = (ln.long()[:, None] + torch.arange(r, device=ln.device)) \
            .clamp(max=s_max - 1)
        lpage = pos // ps
        live2 = live[:, None]
        zero = torch.zeros_like(pos)
        page = torch.where(live2, table[rows[:, None], lpage].long(), zero)
        offset = torch.where(live2, pos % ps, zero)
        fresh = anchor = None
        if "k_scale" in cache:
            # a page with no committed token yet inherits the scale of
            # the page holding the row's last committed token
            anchor = torch.where(
                live, table[rows, (ln.long() - 1).clamp(min=0) // ps].long(),
                torch.zeros_like(rows))
            fresh = lpage * ps >= ln.long()[:, None]
        x = self._verify_embed(tokens, pos)
        for blk, kp, vp, ks, vs in zip(self._blocks(), cache["k"],
                                       cache["v"], *self._kv_scales(cache)):
            x = blk.verify_paged(x, kp, vp, table, page, offset, ln, ks, vs,
                                 fresh, anchor)
        return self.lm_head(self.ln_f(x)).float()

    def _live(self, active):
        """A host (B,) activity mask as a bool tensor on the device."""
        return torch.as_tensor(onp.asarray(active)).to(
            self.device, non_blocking=True) > 0

    @torch.no_grad()
    def verify_step(self, tokens, cache, adapters=None):
        """Speculative VERIFY over every dense cache slot: write the K/V
        of ``tokens`` (B, R) — per row ``[last, d_1 .. d_{R-1}]``, the
        committed tail token and the draft's proposals — at positions
        ``[len, len + R)`` and return the logits at all R positions
        ``(B, R, V)`` fp32 and the cache, updated in place. ``len`` is
        unchanged: :meth:`advance_len` commits the accepted prefix and
        so rolls the rejected tail back (it sits above ``len``, is never
        attended, and the next verify overwrites it). Rows must keep
        ``len + R <=`` the cache capacity (the engine's ``spec_k``
        margin)."""
        tokens = self._as_tokens(tokens)
        if tokens.dim() != 2:
            raise ValueError(f"verify tokens must be (batch, R), got "
                             f"shape {tuple(tokens.shape)}")
        with self._bound(adapters, tokens.shape[0]):
            return self._verify_body(tokens, cache), cache

    @torch.no_grad()
    def verify_step_paged(self, tokens, active, cache, adapters=None):
        """Speculative VERIFY for every slot of a PAGED cache: write each
        active row's ``tokens`` (B, R) at positions ``[len, len + R)``
        through its page table and return the logits at all R positions
        ``(B, R, V)`` fp32 and the cache, updated in place. Inactive rows
        (``active == 0``) and positions past a slot's page reservation
        write into the scrap page; ``len`` is unchanged (commit with
        :meth:`advance_len_paged`)."""
        tokens = self._as_tokens(tokens)
        if tokens.dim() != 2:
            raise ValueError(f"verify tokens must be (batch, R), got "
                             f"shape {tuple(tokens.shape)}")
        with self._bound(adapters, tokens.shape[0]):
            return self._verify_body_paged(tokens, self._live(active),
                                           cache), cache

    @torch.no_grad()
    def advance_len(self, delta, cache):
        """Advance each row's valid length by ``delta`` (B,) — the
        speculative COMMIT and ROLLBACK primitive (0 leaves a row put; a
        draft's cache rolls back to the accept point with a negative
        delta). In place; returns the cache."""
        cache["len"] += torch.as_tensor(onp.asarray(delta, "i4")).to(
            self.device, non_blocking=True)
        return cache

    advance_len_paged = advance_len

    @torch.no_grad()
    def propose_tokens(self, tokens, cache, k, generators=None, temps=None,
                       top_ks=None, top_ps=None):
        """DRAFT side of one speculative iteration: ``k`` chained decode
        steps over every dense cache slot, each feeding its token to the
        next on the device (no host sync). Greedy (no ``temps``):
        returns ``(draft_tokens (B, k) int32, cache)``. Sampled (per-row
        ``generators`` and host knob arrays (B,), as
        ``ops.sampling.sample_tokens`` takes them): every step draws with
        ``sample_with_probs``; returns ``(draft_tokens, warped probs (B,
        k, V), generators, cache)`` — what the accept rule needs. ``len``
        advances by k on every row; :meth:`advance_len` rolls it back to
        the accept point."""
        cur = self._as_tokens(tokens)
        toks, qs = [], []
        with self._bound(None, cur.shape[0]):
            for _ in range(int(k)):
                logits, cache = self._decode_body(cur, cache)
                if temps is None:
                    cur = logits.argmax(dim=-1)
                else:
                    cur, q = _smp.sample_with_probs(generators, logits, temps,
                                                    top_ks, top_ps)
                    qs.append(q)
                toks.append(cur)
        d = torch.stack(toks, 1).to(torch.int32)
        if temps is None:
            return d, cache
        return d, torch.stack(qs, 1), generators, cache

    @torch.no_grad()
    def verify_commit(self, last, d_toks, active, cache, q=None,
                      generators=None, temps=None, top_ks=None, top_ps=None,
                      adapters=None):
        """TARGET side of one speculative iteration, in one call with no
        host sync: verify the ``k + 1`` positions ``[last, d_1 .. d_k]``
        (``verify_step``'s computation), apply the accept rule, and
        advance every active row's ``len`` by its commit count. Greedy
        (no ``q``): ``greedy_accept``, returns ``(commit (B, k+1) int32,
        n_commit (B,) int32, cache)``; sampled (``q`` the draft's warped
        probabilities, per-row ``generators`` and host knobs):
        ``speculative_accept``, returns ``(commit, n_commit, generators,
        cache)``. A row the engine then clips (eos, budget, capacity)
        keeps the full-commit ``len``: it is evicted, and nobody reads
        its counter."""
        return self._verify_commit(False, last, d_toks, active, cache, q,
                                   generators, temps, top_ks, top_ps,
                                   adapters)

    @torch.no_grad()
    def verify_commit_paged(self, last, d_toks, active, cache, q=None,
                            generators=None, temps=None, top_ks=None,
                            top_ps=None, adapters=None):
        """Paged-cache :meth:`verify_commit` (the verify of
        ``verify_step_paged``; the accept rule and the ``len`` advance
        are the same)."""
        return self._verify_commit(True, last, d_toks, active, cache, q,
                                   generators, temps, top_ks, top_ps,
                                   adapters)

    def _verify_commit(self, paged, last, d_toks, active, cache, q,
                       generators, temps, top_ks, top_ps, adapters):
        last, d_toks = self._as_tokens(last), self._as_tokens(d_toks)
        live = self._live(active)
        vt = torch.cat([last[:, None], d_toks], dim=1)
        with self._bound(adapters, vt.shape[0]):
            logits = self._verify_body_paged(vt, live, cache) if paged \
                else self._verify_body(vt, cache)
        if q is None:
            commit, n_commit = _smp.greedy_accept(logits, d_toks)
        else:
            commit, n_commit = _smp.speculative_accept(
                generators, logits, d_toks, q, temps, top_ks, top_ps)
        cache["len"] += n_commit * live.to(torch.int32)
        if q is None:
            return commit, n_commit, cache
        return commit, n_commit, generators, cache

    # -- paged-cache generation API ------------------------------------
    def init_paged_cache(self, batch_size, n_pages, page_size,
                         max_length=None, dtype=None):
        """Preallocated PAGED KV cache: a global pool of ``n_pages``
        fixed-size pages per layer plus a fixed-shape page table —
        ``{"k": tuple of L (n_pages, H, page_size, Dh) tensors, "v":
        same, "table": (B, P_max) int32, "len": (B,) int32}`` with
        ``P_max = max_length // page_size``, all zeros on the model's
        device. Logical position ``t`` of slot ``b`` lives at
        ``pool[table[b, t // ps], :, t % ps]``. Page 0 is the reserved
        SCRAP page: free table entries point at it and redirected
        writes land in it. The paged calls update it in place.

        ``dtype="int8"`` allocates an int8 pool with ``k_scale``/
        ``v_scale`` tuples of L (n_pages, H) fp32 per-head-per-PAGE
        scales: a shared prefix page carries its own scale wherever its
        refcount travels, and COW copies it with the data."""
        s = int(max_length) if max_length is not None else self._max_length
        if not 1 <= s <= self._max_length:
            raise ValueError(
                f"cache max_length {s} out of range (position table "
                f"holds {self._max_length})")
        ps = int(page_size)
        if ps < 1 or s % ps != 0:
            raise ValueError(
                f"page_size {ps} must divide cache max_length {s}")
        if int(n_pages) < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is the "
                             "reserved scrap page)")
        dt = _cache_dtype(dtype if dtype is not None else self._dtype)
        shape = (int(n_pages), self._num_heads, ps, self._head_dim)
        dev = self.device
        cache = {"k": self._zeros(shape, dt), "v": self._zeros(shape, dt),
                 "table": torch.zeros((int(batch_size), s // ps),
                                      dtype=torch.int32, device=dev),
                 "len": torch.zeros((int(batch_size),), dtype=torch.int32,
                                    device=dev)}
        if dt == torch.int8:
            cache["k_scale"] = self._zeros((int(n_pages), self._num_heads))
            cache["v_scale"] = self._zeros((int(n_pages), self._num_heads))
        return cache

    def _as_row(self, pages):
        return torch.as_tensor(onp.asarray(pages, "i4")).to(self.device)

    @torch.no_grad()
    def prefill_paged(self, tokens, n_valid, slot, pages, cache, *,
                      start=0, fresh=False, adapters=None):
        """Prefill one chunk (or, with ``fresh=True``, one whole short
        prompt) of ``slot`` into pool pages. ``tokens`` is (1, W) with
        W a multiple of the page size; ``pages`` is the slot's FULL
        (P_max,) physical-page row (entries past its reservation point
        at scrap page 0); ``start`` is the chunk's global offset (a
        multiple of the page size; 0 when ``fresh``); ``n_valid``
        counts the real tokens of this chunk. Returns
        ``(last_valid_logits (1, V), cache)``, the cache updated in
        place.

        ``fresh=True`` runs the dense prefill's computation (causal
        flash over the prompt block only, K1 on the card) and is
        bitwise equal to dense ``prefill``; the general path attends
        the gathered page view (shared prefix and earlier chunks) under
        the global causal mask."""
        tokens = self._as_tokens(tokens)
        if tokens.dim() != 2 or tokens.shape[0] != 1:
            raise ValueError(f"paged prefill tokens must be (1, W), got "
                             f"shape {tuple(tokens.shape)}")
        ps = cache["k"][0].shape[2]
        s_max = cache["table"].shape[1] * ps
        w = tokens.shape[1]
        start, n_valid, slot = int(start), int(n_valid), int(slot)
        if w % ps or w > s_max:
            raise ValueError(
                f"chunk width {w} must be a multiple of page_size {ps} "
                f"and fit cache capacity {s_max}")
        if start % ps:
            raise ValueError(f"chunk start {start} must be a multiple of "
                             f"page_size {ps}")
        if fresh and start != 0:
            raise ValueError("fresh prefill starts at 0 by definition")
        pages = self._as_row(pages)
        page_ids = pages[start // ps:(start + w) // ps].long()
        layers = list(zip(self._blocks(), cache["k"], cache["v"],
                          *self._kv_scales(cache)))
        with self._bound(adapters, 1):
            if fresh:
                x = self._embed(tokens)
                for blk, kp, vp, ks, vs in layers:
                    x, (k, v) = blk.prefill(x)
                    if ks is None:
                        kp[page_ids] = _to_pages(k, ps).to(kp.dtype)
                        vp[page_ids] = _to_pages(v, ps).to(vp.dtype)
                    else:   # per-page, per-head amax scales
                        _write_quantized(kp, ks, _to_pages(k, ps),
                                         (page_ids,))
                        _write_quantized(vp, vs, _to_pages(v, ps),
                                         (page_ids,))
            else:
                pw = self.position_weight._read()
                x = self.word_embed(tokens) + pw[start:start + w]
                if self.embed_drop is not None:
                    x = self.embed_drop(x)
                for blk, kp, vp, ks, vs in layers:
                    x = blk.prefill_chunk(x, kp, vp, pages, page_ids, start,
                                          ks, vs)
            idx = min(max(n_valid - 1, 0), w - 1)
            logits = self.lm_head(self.ln_f(x[:, idx:idx + 1]))
        cache["table"][slot] = pages
        cache["len"][slot] = start + n_valid
        return logits[:, 0, :].float(), cache

    @torch.no_grad()
    def decode_step_paged(self, tokens, active, cache, adapters=None):
        """One decode step for every slot of a PAGED cache: write each
        active row's K/V into its current page at ``len % page_size``,
        attend its valid pages, bump its ``len``. ``active`` (B,) masks
        rows: inactive rows run the same fixed-shape step but their
        writes go to the scrap page and their ``len`` stands still (a
        freed slot's table row may alias pages someone else owns).
        Returns ``(logits (B, V), cache)``, the cache updated in
        place."""
        tokens = self._as_tokens(tokens)
        with self._bound(adapters, tokens.shape[0]):
            return self._decode_body_paged(tokens, self._live(active), cache)

    def _decode_body_paged(self, tokens, live, cache):
        """One paged decode step's computation, under ``_bound`` (shared
        by ``decode_step_paged`` and ``decode_multi_paged``'s loop):
        ``live`` (B,) bool masks rows, whose writes go to scrap page 0
        and whose ``len`` stands still."""
        ps = cache["k"][0].shape[2]
        table, ln = cache["table"], cache["len"]
        s_max = table.shape[1] * ps
        rows = torch.arange(ln.shape[0], device=self.device)
        pos = ln.clamp(max=s_max - 1).long()
        att_len = (pos + 1).to(torch.int32)
        zero = torch.zeros_like(pos)
        # inactive rows write into scrap page 0: their table rows may
        # alias pages now owned by other slots
        page = torch.where(live, table[rows, pos // ps].long(), zero)
        offset = torch.where(live, pos % ps, zero)
        # the previous page, whose scale a fresh page of an int8 pool
        # inherits; same scrap-page redirect
        prev_page = torch.where(
            live, table[rows, (pos // ps - 1).clamp(min=0)].long(), zero)
        x = (self.word_embed(tokens) + self.position_weight._read()[pos])[
            :, None, :]
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        for blk, kp, vp, ks, vs in zip(self._blocks(), cache["k"],
                                       cache["v"], *self._kv_scales(cache)):
            x = blk.decode_paged(x, kp, vp, table, page, offset, att_len,
                                 ks, vs, prev_page)
        logits = self.lm_head(self.ln_f(x))
        ln += live.to(torch.int32)
        return logits[:, 0, :].float(), cache

    @torch.no_grad()
    def peek_logits_paged(self, token, slot, cache, adapters=None):
        """Next-token logits for a slot whose ENTIRE prompt is already
        cached (prefix reuse): recompute the last prompt token's query
        at position ``len - 1`` and attend the cached pages — no
        prefill, no write. Returns (vocab,) logits."""
        slot = int(slot)
        ln = cache["len"][slot:slot + 1]
        pos = (ln - 1).long()
        tok = self._as_tokens([int(token)])
        table1 = cache["table"][slot:slot + 1]
        with self._bound(adapters, 1):
            x = (self.word_embed(tok) + self.position_weight._read()[pos])[
                :, None, :]
            if self.embed_drop is not None:
                x = self.embed_drop(x)
            for blk, kp, vp, ks, vs in zip(self._blocks(), cache["k"],
                                           cache["v"],
                                           *self._kv_scales(cache)):
                x = blk.peek_paged(x, kp, vp, table1, ln, ks, vs)
            return self.lm_head(self.ln_f(x))[0, 0].float()

    @torch.no_grad()
    def bind_slot_paged(self, slot, pages, length, cache):
        """Install a slot's page-table row and valid length (the
        prefix-hit admission, and the rebind after a COW copy): no
        compute; an int8 pool's scales stay as they are. Returns the
        cache, updated in place."""
        cache["table"][int(slot)] = self._as_row(pages)
        cache["len"][int(slot)] = int(length)
        return cache

    @torch.no_grad()
    def copy_page_paged(self, src, dst, cache):
        """Copy physical page ``src`` to ``dst`` across every layer's K
        and V pools — the copy half of copy-on-write at a shared
        divergence page — and, for an int8 pool, its scales. Returns the
        cache, updated in place."""
        src, dst = int(src), int(dst)
        for pool in (*cache["k"], *cache["v"], *cache.get("k_scale", ()),
                     *cache.get("v_scale", ())):
            pool[dst] = pool[src]
        return cache


def gpt_small(vocab_size=1000, units=64, num_layers=2, num_heads=4,
              max_length=128, dropout=0.0, dtype="float32", **kwargs):
    """Tiny configuration for tests."""
    return GPTModel(vocab_size=vocab_size, units=units,
                    num_layers=num_layers, num_heads=num_heads,
                    max_length=max_length, dropout=dropout, dtype=dtype,
                    **kwargs)
