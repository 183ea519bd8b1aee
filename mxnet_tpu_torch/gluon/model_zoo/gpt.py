"""GPT — the causal decoder family, dense fp32 generation path.

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

Attention runs through ``ops.attention``: on the card, prefill and the
full forward launch K1 (``csrc/flash_attention.cu``) and decode
launches K2 (``csrc/decode_attention.cu``); on the CPU both take their
plain versions.

The reference's other generation modes (paged cache, int8 weights,
bf16 compute, LoRA, speculative verify, multi-tick decode,
tensor-parallel sharding) are later slices; a non-fp32 model or cache
raises ``NotImplementedError`` naming the ROADMAP.md item.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ...base import not_ported
from ...context import resolve_device
from ...ops import attention as _att
from ..block import HybridBlock
from ..parameter import Parameter
from ..nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["GPTBlock", "GPTModel", "gpt_small", "load_jax_params"]


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

    def _split(self, x):
        """(B, S, U) -> (B, H, S, Dh), a strided view (no copy)."""
        b, s, _ = x.shape
        return x.reshape(b, s, self._num_heads,
                         self._head_dim).transpose(1, 2)

    def _merge(self, out):
        b, h, s, d = out.shape
        return out.transpose(1, 2).reshape(b, s, h * d)

    def _qkv(self, x):
        h = self.ln1(x)
        return (self._split(self.q_proj(h)), self._split(self.k_proj(h)),
                self._split(self.v_proj(h)))

    def _finish(self, x, attn):
        y = self.out_proj(self._merge(attn))
        if self.drop is not None:
            y = self.drop(y)
        x = x + y
        y = self.ffn2(self.ffn1(self.ln2(x)))
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

    def decode(self, x, k_cache, v_cache, pos, att_len):
        """One decode step: write this token's K/V at ``pos`` (B,) of
        each row IN PLACE, attend over the valid prefix ``[0,
        att_len)``. Returns the block output and the (same) buffers."""
        q, k, v = self._qkv(x)
        rows = torch.arange(x.shape[0], device=x.device)
        k_cache[rows, :, pos] = k[:, :, 0].to(k_cache.dtype)
        v_cache[rows, :, pos] = v[:, :, 0].to(v_cache.dtype)
        attn = _att.decode_attention(q, k_cache, v_cache, att_len)
        return self._finish(x, attn), k_cache, v_cache


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
        if str(dtype) != "float32":
            raise not_ported(f"GPTModel(dtype={dtype!r})",
                             "10 (bf16 compute)")
        dev = resolve_device(device)
        super().__init__()
        self._vocab_size = vocab_size
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._max_length = max_length
        self._dtype = dtype
        with dev:
            self.word_embed = Embedding(vocab_size, units, dtype=dtype)
            self.position_weight = Parameter(
                "position_weight", (max_length, units), dtype=dtype)
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

    def _blocks(self):
        return list(self.layers._modules.values())

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
        x = x + self.position_weight.data()[:tokens.shape[-1]]
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        return x

    @torch.no_grad()
    def forward(self, tokens):
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
        ``decode_step`` update it in place."""
        s = int(max_length) if max_length is not None else self._max_length
        if not 1 <= s <= self._max_length:
            raise ValueError(
                f"cache max_length {s} out of range (position table "
                f"holds {self._max_length})")
        if dtype is not None and str(dtype) != "float32":
            raise not_ported(
                f"a {dtype} KV cache",
                "8 (int8 KV)" if str(dtype) == "int8" else "10 (bf16)")
        shape = (int(batch_size), self._num_heads, s, self._head_dim)
        dev = self.device

        def zeros():
            return tuple(torch.zeros(shape, dtype=torch.float32, device=dev)
                         for _ in range(self._num_layers))
        return {"k": zeros(), "v": zeros(),
                "len": torch.zeros((int(batch_size),), dtype=torch.int32,
                                   device=dev)}

    @torch.no_grad()
    def prefill(self, tokens, valid_length, cache, slots=None):
        """Run the (padded) prompts ``tokens`` (B_req, S_bucket) through
        the model, write their K/V into ``cache`` rows ``slots`` (default
        ``0..B_req-1``), set ``len`` to ``valid_length``. Returns
        ``(last_logits, cache)`` — fp32 ``(B_req, vocab)`` logits of each
        row's last valid token and the same cache, updated in place."""
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
        x = self._embed(tokens)
        for blk, kc, vc in zip(self._blocks(), cache["k"], cache["v"]):
            x, (k, v) = blk.prefill(x)
            kc[slots, :, :sb] = k.to(kc.dtype)
            vc[slots, :, :sb] = v.to(vc.dtype)
        # logits of the LAST VALID prompt token (predicts token 1)
        idx = (valid_len.long() - 1).clamp(0, sb - 1)
        last = x[torch.arange(b, device=dev), idx][:, None, :]
        logits = self.lm_head(self.ln_f(last))
        cache["len"][slots] = valid_len
        return logits[:, 0, :].float(), cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One greedy-decoding step for EVERY cache slot: write the K/V
        of ``tokens`` (B,) at each row's clamped position, attend over
        the valid prefix, bump ``len``. Returns ``(logits, cache)`` —
        fp32 ``(B, vocab)`` next-token logits and the same cache,
        updated in place. Rows of free slots produce logits that callers
        ignore: the batch shape never changes with occupancy."""
        tokens = self._as_tokens(tokens)
        s_max = cache["k"][0].shape[2]
        ln = cache["len"]
        pos = ln.clamp(max=s_max - 1).long()   # clamped write position
        att_len = (pos + 1).to(torch.int32)    # incl. the new token
        emb = self.word_embed(tokens)          # (B, U)
        x = (emb + self.position_weight.data()[pos])[:, None, :]
        if self.embed_drop is not None:
            x = self.embed_drop(x)
        for blk, kc, vc in zip(self._blocks(), cache["k"], cache["v"]):
            x, _, _ = blk.decode(x, kc, vc, pos, att_len)
        logits = self.lm_head(self.ln_f(x))    # (B, 1, V)
        ln += 1
        return logits[:, 0, :].float(), cache


def gpt_small(vocab_size=1000, units=64, num_layers=2, num_heads=4,
              max_length=128, dropout=0.0, dtype="float32", **kwargs):
    """Tiny configuration for tests."""
    return GPTModel(vocab_size=vocab_size, units=units,
                    num_layers=num_layers, num_heads=num_heads,
                    max_length=max_length, dropout=dropout, dtype=dtype,
                    **kwargs)


def load_jax_params(model, params):
    """Fill ``model``'s parameters from the JAX model's
    ``collect_params()`` exported to numpy (``{name: array}``), mapping
    names one to one. Raises on a missing name, an extra name or a
    shape mismatch, before writing anything. Returns ``model``."""
    ours = model.collect_params()
    missing = [n for n in ours if n not in params]
    extra = [n for n in params if n not in ours]
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    bad = [(n, tuple(onp.shape(params[n])), p.shape)
           for n, p in ours.items() if tuple(onp.shape(params[n])) != p.shape]
    if bad:
        raise ValueError(f"parameter shapes differ (name, given, "
                         f"expected): {bad}")
    for name, p in ours.items():
        p.set_data(torch.from_numpy(onp.array(params[name], dtype="f4")))
    return model
