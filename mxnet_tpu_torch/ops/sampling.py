"""Sampling heads of the serving engine: temperature / top-k / top-p
logit warping and per-row categorical sampling with an explicit
generator per row.

Counterpart of ``mxnet_tpu/ops/sampling.py``'s ``warp_logits`` and
``sample_tokens``; plain PyTorch, as the reference is plain jnp.

- ``warp_logits`` is deterministic and follows the reference step for
  step (temperature, then top-k, then top-p over the renormalized
  post-top-k distribution; ties kept at the k-th value; a token is kept
  by top-p iff the mass before it, in a stable descending order, is
  still below p, so the head token always survives). ``top_k <= 0``
  (or >= vocab) and ``top_p >= 1`` disable their filters;
  ``temperature <= 0`` rows are warped at temperature 1.
- Randomness is an explicit ``torch.Generator`` per sampled row (the
  reference threads a raw PRNG key per row). A row's draw consumes
  only its own generator, so a request's stream depends on its seed
  alone — never on its co-tenants or its slot — and the same seed
  gives the same tokens on the same device. Philox (PyTorch) and
  Threefry (JAX) streams differ, so draws are never compared with the
  reference token for token, only as distributions.
- ``temperature <= 0`` marks a GREEDY row: ``argmax`` of the RAW
  logits, the engine's greedy path exactly.

The draw is Gumbel-max in its exponential form, ``argmax(p / E)`` with
``E ~ Exp(1)`` drawn from the row's generator: a few kernels per row,
all on the device, so sampling adds no host sync to the step's one read
of its tokens. Masked tokens have p = 0 and are never drawn (E is
floored at the smallest normal float, so p / E stays finite).
"""
from __future__ import annotations

import numpy as onp
import torch

#: the attention convention's finite -inf: masked logits must survive
#: softmax without minting NaNs
NEG_INF = -1e30

__all__ = ["warp_logits", "sample_tokens"]


def _knob(x, dtype, device):
    """A per-row knob on ``device``. A host array is copied without
    waiting for the device (the copy is staged at once, so the array
    may change afterwards): choosing and warping the sampled rows adds
    no host sync to a decode step."""
    return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)


def warp_logits(logits, temperature, top_k, top_p):
    """Apply temperature, then top-k, then top-p to ``logits`` (..., V)
    with per-row knobs broadcast over the leading axes ((B,) vectors
    against (B, V) logits). Masked entries are set to ``NEG_INF``; at
    least one entry per row always survives. Returns fp32."""
    dev = logits.device
    v = logits.shape[-1]
    temperature = _knob(temperature, torch.float32, dev)
    top_k = _knob(top_k, torch.int64, dev)
    top_p = _knob(top_p, torch.float32, dev)
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))[..., None]
    x = logits.float() / t
    # top-k: keep the k largest (k <= 0 or >= V disables)
    desc = torch.sort(x, dim=-1, descending=True).values
    k_eff = top_k.clamp(1, v).expand(x.shape[:-1])
    kth = torch.gather(desc, -1, (k_eff - 1)[..., None])
    k_on = (top_k > 0) & (top_k < v)
    x = torch.where(k_on[..., None] & (x < kth),
                    torch.full_like(x, NEG_INF), x)
    # top-p: smallest prefix of the (post-top-k) sorted distribution
    # whose mass reaches p; the sort is stable, as jnp.argsort's is
    probs = torch.softmax(x, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    ps = torch.gather(probs, -1, order)
    cum = torch.cumsum(ps, dim=-1)
    p_on = (top_p > 0) & (top_p < 1.0)
    keep_sorted = ((cum - ps) < top_p.clamp(0.0, 1.0)[..., None]) \
        | ~p_on[..., None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, x, torch.full_like(x, NEG_INF))


def sample_tokens(generators, logits, temperature, top_k, top_p):
    """One sampling step over a row batch (B, V): every row with
    ``temperature > 0`` draws one token from its warped distribution
    with ``generators[row]`` (a ``torch.Generator`` on the logits'
    device, advanced in place); greedy rows take ``argmax`` of the raw
    logits. The knobs are host arrays (B,). Returns (B,) int64 tokens
    on the logits' device."""
    temperature = onp.asarray(temperature, "f4").reshape(-1)
    tok = logits.argmax(dim=-1)
    rows = [i for i in range(logits.shape[0]) if temperature[i] > 0]
    if not rows:
        return tok
    # every row is warped (a greedy row at temperature 1, unused), so
    # no row index has to reach the device
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    for i in rows:
        e = torch.empty_like(probs[i]).exponential_(
            generator=generators[i]).clamp_(min=tiny)
        tok[i] = (probs[i] / e).argmax()
    return tok
