"""K1's bf16 instance (``csrc/flash_attention.cu``,
``flash_fwd_bf16_kernel``) emulated in plain torch on the CPU, against
the JAX package's Pallas kernel (``flash_attention_pallas`` with
``interpret=True``), which widens its bf16 blocks to fp32 as the card's
kernel must (the jnp path rounds the scores and P to bf16 instead).

The emulation follows the kernel's arithmetic: 64-key tiles taken
round-robin by the block's warpgroups (the count read from the source),
each with its own online softmax in the log2 domain; S = Q K^T of the
bf16 values summed in fp32 (bf16 x bf16 is exact in fp32); masked raw
scores -inf on the tiles that cross kv_len or the diagonal; the scale on
the fp32 scores; P split into bf16 hi = bf16(P) and lo = bf16(P - hi),
both against the bf16 V into one fp32 accumulator; the warpgroups'
states folded in in order; out = o / l_safe rounded to bf16 once.

- Its bf16 output against the Pallas kernel's on the same bf16 inputs
  within one bf16 step, 2^-8 x max(1, max|ref|) (``chip_smoke.py``'s
  ``BF16_ULP``: both compute in fp32 before one rounding), and its lse
  within ``LSE_TOL`` = 1e-4.
- Its fp32 output before that rounding against the Pallas kernel on the
  inputs widened to fp32: the hi + lo split stays within 2^-16 of the
  magnitude (2.4e-6 at most here), at least 64 times below the error of
  a single bf16 P (no lo part: up to 1.7e-3 here), which alone would take
  about half of the output's own bf16 step. That is why the kernel runs
  the second P V product.
"""
import math
import re
from pathlib import Path

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import attention as jat

SRC = (Path(__file__).resolve().parents[1] / "mxnet_tpu_torch" / "csrc"
       / "flash_attention.cu").read_text()
#: keys per K/V tile
TILE = int(re.search(r"constexpr int kWgKeys = (\d+);", SRC).group(1))
_NW = re.search(r"constexpr int kWgConsumers = D <= 64 \? (\d+) : (\d+);",
                SRC)
BF16_ULP = 2.0 ** -8
LSE_TOL = 1e-4
LOG2E = 1.4426950408889634


def _warpgroups(d):
    return int(_NW.group(1)) if d <= 64 else int(_NW.group(2))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate(q, k, v, causal, kv_len=None, split=True):
    """The kernel's arithmetic on bf16 (B, H, S, D) q/k/v in plain
    torch: returns ``(out fp32 before the output's rounding, lse)``.
    ``split=False`` feeds P V a single bf16 P (no lo part)."""
    b, h, sq, d = q.shape
    kv_len = k.shape[2] if kv_len is None else kv_len
    qs = 1.0 / math.sqrt(d) * LOG2E
    offset = kv_len - sq
    nw = _warpgroups(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(b, h, sq, d)
    lse = torch.empty(b, h, sq)
    for q0 in range(0, sq, TILE):
        rows = torch.arange(q0, min(q0 + TILE, sq))
        last = kv_len - 1
        if causal:
            last = min(last, q0 + TILE - 1 + offset)
        n_tiles = last // TILE + 1 if last >= 0 else 0
        lim = torch.full((len(rows),), kv_len - 1)
        if causal:
            lim = torch.clamp(rows + offset, max=kv_len - 1)
        states = []
        for wg in range(nw):
            m = torch.full((b, h, len(rows)), -1e30)
            l = torch.zeros(b, h, len(rows))
            o = torch.zeros(b, h, len(rows), d)
            for t in range(wg, n_tiles, nw):
                keys = torch.arange(t * TILE, (t + 1) * TILE)
                kt = torch.zeros(b, h, TILE, d)
                vt = torch.zeros(b, h, TILE, d)
                live = keys < kv_len           # rows past kv_len: zeros
                kt[:, :, live] = kf[:, :, keys[live]]
                vt[:, :, live] = vf[:, :, keys[live]]
                s = qf[:, :, rows] @ kt.transpose(-1, -2)
                s = torch.where(keys[None, :] > lim[:, None],
                                torch.tensor(-math.inf), s)
                mx = s.amax(-1) * qs
                mn = torch.maximum(m, mx)
                alpha = torch.exp2(m - mn)
                p = torch.exp2(s * qs - mn[..., None])
                l = l * alpha + p.sum(-1)
                hi = _bf16(p)
                pv = hi @ vt
                if split:
                    pv = pv + _bf16(p - hi) @ vt
                o = o * alpha[..., None] + pv
                m = mn
            states.append((m, l, o))
        m, l, o = states[0]
        for pm, pl, po in states[1:]:
            nm = torch.maximum(m, pm)
            a, c = torch.exp2(m - nm), torch.exp2(pm - nm)
            l, o, m = l * a + pl * c, o * a[..., None] + po * c[..., None], nm
        ls = torch.where(l > 0, l, torch.ones_like(l))
        out[:, :, rows] = o * (1.0 / ls)[..., None]
        lse[:, :, rows] = torch.where(m == -1e30, m, m * math.log(2)) \
            + torch.log(ls)
    return out, lse


def _inputs(seed, b, h, sq, sk, d):
    rng = onp.random.RandomState(seed)
    return [torch.from_numpy((rng.standard_normal((b, h, s, d)) * 0.5)
                             .astype("f4")).bfloat16()
            for s in (sq, sk, sk)]


def _pallas(q, k, v, causal, kv_len, dtype):
    j = [jnp.asarray(x.float().numpy()).astype(dtype) for x in (q, k, v)]
    out, lse = jat.flash_attention_pallas(*j, causal=causal, kv_len=kv_len,
                                          interpret=True)
    return (torch.from_numpy(onp.array(out.astype(jnp.float32))),
            torch.from_numpy(onp.array(lse)))


#: (b, h, sq, sk, d, causal, kv_len)
CASES = [
    (1, 2, 200, 200, 64, True, None),
    (1, 2, 200, 200, 64, False, None),
    (1, 2, 70, 150, 64, True, 130),
    (2, 1, 90, 150, 64, False, 100),
    (1, 2, 130, 130, 16, True, None),
    (1, 2, 130, 130, 128, True, None),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,kv_len", CASES,
                         ids=[f"s{c[2]}-k{c[3]}-d{c[4]}-causal{c[5]}"
                              f"-kv{c[6]}" for c in CASES])
def test_emulation_against_pallas(b, h, sq, sk, d, causal, kv_len):
    q, k, v = _inputs(sq + d, b, h, sq, sk, d)
    out, lse = emulate(q, k, v, causal, kv_len)
    ref, ref_lse = _pallas(q, k, v, causal, kv_len, jnp.bfloat16)
    tol = BF16_ULP * max(1.0, float(ref.abs().max()))
    assert float((_bf16(out) - ref).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL

    ref32, _ = _pallas(q, k, v, causal, kv_len, jnp.float32)
    scale = max(1.0, float(ref32.abs().max()))
    e_split = float((out - ref32).abs().max())
    e_single = float((emulate(q, k, v, causal, kv_len, split=False)[0]
                      - ref32).abs().max())
    assert e_split <= 2.0 ** -16 * scale, (e_split, e_single)
    assert e_split * 64 <= e_single, (e_split, e_single)


def test_source_constants():
    assert TILE == 64
    assert all(_warpgroups(d) * 128 <= 512 for d in (16, 32, 64, 128))
