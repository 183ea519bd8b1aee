"""Attention layers (the port of ``mxnet_tpu/gluon/nn/attention.py``):
``MultiHeadAttention`` and ``TransformerEncoderCell``.

``MultiHeadAttention`` keeps the reference's three routes:

- ``valid_length`` given: padding-masked attention, explicit scores
  and a masked softmax (the flash kernel has no pad mask), its products
  without TF32 on the card (``ops.nn.fp32_matmul``);
- ``sequence_parallel=True``: ring attention over the sequence axis,
  which waits for the port's parallelism (ROADMAP.md queue 1, item 20);
- otherwise ``ops.attention.flash_attention`` (``npx.flash_attention``):
  K1 forward on the card, and K1-bwd (its dq and dkv launches) when a
  gradient flows back under ``autograd.record()``; their plain versions
  on the CPU.

The projections are ``Dense`` layers (full fp32 on the card).
"""
from __future__ import annotations

import math

import torch

from ...base import not_ported
from ...ops import attention as _att
from ...ops import nn as _nn
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderCell"]


class MultiHeadAttention(HybridBlock):
    """Self or cross attention over (batch, seq, embed) inputs."""

    _tensor_forward = True

    def __init__(self, embed_dim, num_heads, dropout=0.0, use_bias=True,
                 causal=False, sequence_parallel=False, dtype="float32"):
        super().__init__()
        assert embed_dim % num_heads == 0, \
            "embed_dim must be divisible by num_heads"
        self._embed_dim = embed_dim
        self._num_heads = num_heads
        self._head_dim = embed_dim // num_heads
        self._causal = causal
        self._sequence_parallel = sequence_parallel
        self.q_proj = Dense(embed_dim, use_bias=use_bias, flatten=False,
                            dtype=dtype)
        self.k_proj = Dense(embed_dim, use_bias=use_bias, flatten=False,
                            dtype=dtype)
        self.v_proj = Dense(embed_dim, use_bias=use_bias, flatten=False,
                            dtype=dtype)
        self.out_proj = Dense(embed_dim, use_bias=use_bias, flatten=False,
                              dtype=dtype)
        self.dropout = Dropout(dropout) if dropout else None

    def _split(self, x):
        """(B, S, E) -> (B, H, S, D), a strided view."""
        b, s, _ = x.shape
        return x.reshape(b, s, self._num_heads,
                         self._head_dim).transpose(1, 2)

    def forward(self, query, key=None, value=None, valid_length=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if valid_length is not None:
            scale = 1.0 / math.sqrt(self._head_dim)
            scores = _nn.fp32_matmul(q, k.transpose(-1, -2)) * scale
            s_q, s_k = scores.shape[-2], scores.shape[-1]
            pos = torch.arange(s_k, device=scores.device).reshape(
                1, 1, 1, s_k)
            mask = pos < valid_length.reshape(-1, 1, 1, 1)
            if self._causal:
                cm = torch.arange(s_q, device=scores.device).reshape(
                    1, 1, s_q, 1) >= pos
                mask = torch.logical_and(mask, cm)
            attn = _nn.masked_softmax(scores, mask, axis=-1)
            out = _nn.fp32_matmul(attn.to(v.dtype), v)
        elif self._sequence_parallel:
            raise not_ported("MultiHeadAttention(sequence_parallel=True) "
                             "(ring attention)", 20)
        else:
            out = _att.flash_attention(q, k, v, causal=self._causal)
        b, h, s, d = out.shape
        out = self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Transformer block: attention and a two-layer MLP. ``pre_norm``
    (the default) is the GPT-style block, else the BERT-style post-norm
    one; ``activation`` is the MLP's nonlinearity."""

    _tensor_forward = True

    def __init__(self, embed_dim, num_heads, hidden_dim=None, dropout=0.0,
                 causal=False, sequence_parallel=False,
                 activation="relu", pre_norm=True, dtype="float32"):
        super().__init__()
        hidden_dim = hidden_dim or 4 * embed_dim
        self._pre_norm = pre_norm
        self.ln1 = LayerNorm()
        self.attn = MultiHeadAttention(
            embed_dim, num_heads, dropout=dropout, causal=causal,
            sequence_parallel=sequence_parallel, dtype=dtype)
        self.ln2 = LayerNorm()
        self.ffn1 = Dense(hidden_dim, activation=activation,
                          flatten=False, dtype=dtype)
        self.ffn2 = Dense(embed_dim, flatten=False, dtype=dtype)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, valid_length=None):
        if self._pre_norm:
            h = x + self.attn(self.ln1(x), valid_length=valid_length)
            y = self.ffn2(self.ffn1(self.ln2(h)))
            if self.dropout is not None:
                y = self.dropout(y)
            return h + y
        h = self.ln1(x + self.attn(x, valid_length=valid_length))
        y = self.ffn2(self.ffn1(h))
        if self.dropout is not None:
            y = self.dropout(y)
        return self.ln2(h + y)
