"""Sampling heads of the serving engine: temperature / top-k / top-p
logit warping, per-row categorical sampling with an explicit generator
per row, and the speculative-decoding accept rules.

Counterpart of ``mxnet_tpu/ops/sampling.py``; plain PyTorch, as the
reference is plain jnp.

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

``greedy_accept`` and ``speculative_accept`` are the accept rules of one
speculative verify step (docs/SERVING.md "Accept rules"): greedy rows
accept draft token ``d_{j+1}`` while it equals the target's argmax
``t_j`` and commit the target's token at the cut, so the committed
stream is non-speculative greedy decode's; sampled rows follow the
Leviathan rule on the WARPED distributions — accept ``d`` when ``u <=
p(d) / max(q(d), 1e-20)``, draw the cut token from the residual
``norm(max(p - q, 0))`` (from ``p`` when the residual is numerically
empty, and after a full accept, where q = 0) — so every committed token
is distributed as the warped target. A sampled row draws the same
values in every call, whatever is accepted: k uniforms and one
exponential race over the vocabulary, all on the device; its stream
then depends on its seed, k and the draft only.
"""
from __future__ import annotations

import numpy as onp
import torch

#: the attention convention's finite -inf: masked logits must survive
#: softmax without minting NaNs
NEG_INF = -1e30

__all__ = ["warp_logits", "sample_tokens", "sample_with_probs",
           "greedy_accept", "speculative_accept"]


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


def _sampled_rows(temperature, n):
    """The host array of per-row temperatures (B,) and the indices of
    its sampled rows."""
    temperature = onp.asarray(temperature, "f4").reshape(-1)
    return temperature, [i for i in range(n) if temperature[i] > 0]


def _race(generators, probs, rows, tok):
    """Write into ``tok[i]``, for each of ``rows``, a draw from
    ``probs[i]`` with ``generators[i]``: the exponential race
    ``argmax(p / E)``, one exponential per vocabulary entry."""
    tiny = torch.finfo(torch.float32).tiny
    for i in rows:
        e = torch.empty_like(probs[i]).exponential_(
            generator=generators[i]).clamp_(min=tiny)
        tok[i] = (probs[i] / e).argmax()
    return tok


def sample_tokens(generators, logits, temperature, top_k, top_p):
    """One sampling step over a row batch (B, V): every row with
    ``temperature > 0`` draws one token from its warped distribution
    with ``generators[row]`` (a ``torch.Generator`` on the logits'
    device, advanced in place); greedy rows take ``argmax`` of the raw
    logits. The knobs are host arrays (B,). Returns (B,) int64 tokens
    on the logits' device."""
    temperature, rows = _sampled_rows(temperature, logits.shape[0])
    tok = logits.argmax(dim=-1)
    if not rows:
        return tok
    # every row is warped (a greedy row at temperature 1, unused), so
    # no row index has to reach the device
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return _race(generators, probs, rows, tok)


def sample_with_probs(generators, logits, temperature, top_k, top_p):
    """``sample_tokens`` that also returns the WARPED probability rows
    (B, V) fp32 the tokens were drawn from — the draft step of
    speculative decoding, whose distribution ``q`` the accept rule
    needs. Greedy rows' probabilities are returned but unused (their
    accept rule compares argmaxes). Returns ``(tokens (B,) int64,
    probs)``."""
    temperature, rows = _sampled_rows(temperature, logits.shape[0])
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return _race(generators, probs, rows, logits.argmax(dim=-1)), probs


def _commit_rows(draft_tokens, n_acc, cut):
    """The committed block (B, K+1) int32: the accepted draft prefix,
    then the cut token, then zeros; and ``n_commit = n_acc + 1``."""
    b, k = draft_tokens.shape
    j = torch.arange(k + 1, device=draft_tokens.device)[None, :]
    d_pad = torch.cat([draft_tokens, draft_tokens.new_zeros((b, 1))], dim=1)
    n = n_acc[:, None]
    commit = torch.where(j < n, d_pad,
                         torch.where(j == n, cut[:, None],
                                     torch.zeros_like(d_pad)))
    return commit.to(torch.int32), (n_acc + 1).to(torch.int32)


def greedy_accept(target_logits, draft_tokens):
    """The GREEDY accept rule alone over one verify step:
    ``target_logits`` (B, K+1, V) at the verified positions (position j
    predicts the token after ``[last, d_1 .. d_j]``), ``draft_tokens``
    (B, K). Accept ``d_{j+1}`` while it equals the target argmax
    ``t_j``; commit the target's token at the cut. Returns ``(commit
    (B, K+1) int32, n_commit (B,) int32)``: row b commits ``commit[b,
    :n_commit[b]]``, the same tokens non-speculative greedy decode
    would. Deterministic, with no sort and no draw: an all-greedy
    iteration pays for neither."""
    k = target_logits.shape[1] - 1
    draft_tokens = draft_tokens.to(torch.long)
    tgt = target_logits.argmax(dim=-1)                       # (B, K+1)
    acc = (draft_tokens == tgt[:, :k]).to(torch.int32)
    n_acc = torch.cumprod(acc, dim=-1).sum(dim=-1)
    cut = torch.gather(tgt, 1, n_acc[:, None].long())[:, 0]
    return _commit_rows(draft_tokens, n_acc, cut)


def speculative_accept(generators, target_logits, draft_tokens,
                       draft_probs, temperature, top_k, top_p):
    """The speculative-decoding accept rule over one verify step, per
    row: greedy rows (``temperature <= 0``) follow ``greedy_accept``;
    sampled rows accept ``d_j`` when ``u_j <= p(d_j) / max(q(d_j),
    1e-20)`` (``p`` the warped target distribution at position j-1,
    ``q = draft_probs`` the warped draft distribution ``d_j`` was drawn
    from, ``u_j`` uniform) and draw the cut token from ``norm(max(p -
    q, 0))`` at the first rejection (``p`` itself after a full accept,
    or when the residual sums to <= 1e-20).

    ``target_logits`` (B, K+1, V), ``draft_tokens`` (B, K),
    ``draft_probs`` (B, K, V); the knobs are host arrays (B,); a
    sampled row draws its k uniforms and its cut race from
    ``generators[row]``, the same count in every call. Returns
    ``(commit (B, K+1) int32, n_commit (B,) int32)``, ``1 <= n_commit
    <= K+1``."""
    b, k1, v = target_logits.shape
    k = k1 - 1
    dev = target_logits.device
    temperature, rows = _sampled_rows(temperature, b)
    if not rows:
        return greedy_accept(target_logits, draft_tokens)
    draft_tokens = draft_tokens.to(torch.long)
    tgt = target_logits.argmax(dim=-1)
    acc_g = draft_tokens == tgt[:, :k]
    # (B, 1) knobs broadcast over the K + 1 positions
    p = torch.softmax(warp_logits(
        target_logits, temperature[:, None],
        onp.asarray(top_k).reshape(-1, 1),
        onp.asarray(top_p).reshape(-1, 1)), dim=-1)
    u = torch.ones((b, k), dtype=torch.float32, device=dev)
    for i in rows:
        u[i].uniform_(generator=generators[i])
    p_d = torch.gather(p[:, :k], 2, draft_tokens[..., None])[..., 0]
    q_d = torch.gather(draft_probs, 2, draft_tokens[..., None])[..., 0]
    acc_s = u <= p_d / q_d.clamp(min=1e-20)
    greedy = torch.as_tensor(temperature <= 0).to(dev, non_blocking=True)
    acc = torch.where(greedy[:, None], acc_g, acc_s).to(torch.int32)
    n_acc = torch.cumprod(acc, dim=-1).sum(dim=-1)
    # the cut position's residual; after a full accept q is 0 there
    idx = n_acc[:, None, None].long().expand(b, 1, v)
    p_cut = torch.gather(p, 1, idx)[:, 0]
    q_pad = torch.cat([draft_probs.float(), draft_probs.new_zeros(
        (b, 1, v), dtype=torch.float32)], dim=1)
    q_cut = torch.gather(q_pad, 1, idx)[:, 0]
    resid = (p_cut - q_cut).clamp(min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    dist = torch.where(rs > 1e-20, resid / rs.clamp(min=1e-20), p_cut)
    cut = torch.gather(tgt, 1, n_acc[:, None].long())[:, 0]
    cut = _race(generators, dist, rows, cut)
    return _commit_rows(draft_tokens, n_acc, cut)
