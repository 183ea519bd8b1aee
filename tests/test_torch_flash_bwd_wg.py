"""K1-bwd's bf16 and float16 instances (``csrc/flash_attention_bwd.cu``,
``flash_bwd_wg_kernel``) emulated in plain torch on the CPU, against
``jax.vjp`` of the JAX package's ``flash_attention`` (its ``custom_vjp``
backward, ``_flash_bwd``) run in fp32 on the same 16-bit values widened,
which is the kernel's contract (``chip_smoke.py`` holds the card's kernel
to the port's plain version the same way).

The emulation follows the kernels' arithmetic, with the tile size and
float16's scale constants read from the source: 64-row tiles, one
warpgroup a block; the dq launch walks a q-tile's key tiles in order up
to the causal diagonal of its last row, the dkv launch a key tile's
query tiles from the first row that sees its first key; K/V rows at or
past kv_len arrive as zeros; S and dP are the fp32 products of the
16-bit values (exact products summed in fp32); P = exp2(s scale log2 e -
lse log2 e) where the pair is valid, else 0 by a select; dS = P (dP -
delta) scale; P and dS split as hi = T(x), lo = T(x - hi) into one fp32
accumulator each; under float16 each accumulator row's dS scaled by 2^e,
e the running min over its tiles of the exponent that brings the row's
max |dS| into [2^13, 2^14) (the accumulator rescaled when e falls,
scaled back at the end); each gradient rounded once to T.

Tolerances, relative to max|ref| (not max(1, max|ref|)), the reference
rounded to T as the card's check rounds it: two steps of the type,
2^-7 for bf16 and 2^-9 for float16 (``chip_smoke.py`` ``BWD_TOL``): both
compute in fp32 from the same 16-bit values (the splits keep P and dS to
about 2^-16 (bf16) and 2^-21 (float16) of themselves), and a gradient
rounded once may land a step away across a rounding boundary, a step
being up to 2^-8 (2^-10) of max|ref| when max|ref| sits just above a
power of two.

The small-dO case: dO scaled by 2^-11 at (1, 2, 256, 64), causal, so
that max |dS| falls under float16's smallest normal, 2^-14 (2^-14.07
here), while max |dq|, |dk| and |dv| stay normal (2^-13.1, 2^-13.0 and
2^-10.3). Without the scale the split dS loses its bits in float16's
subnormal range and the emulation misses the float16 tolerance (4.7e-3
of max|ref| against 2^-9 = 2.0e-3); with it, it passes (5.2e-4).
"""
import math
import re
from pathlib import Path

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import attention as jat

from mxnet_tpu_torch.ops import attention as tat

_CSRC = Path(__file__).resolve().parents[1] / "mxnet_tpu_torch" / "csrc"
SRC = (_CSRC / "flash_attention_bwd.cu").read_text()
COMMON = (_CSRC / "common.cuh").read_text()
#: rows of every tile
TILE = int(re.search(r"constexpr int kWgRows = (\d+);", SRC).group(1))
SCALE_TOP = int(re.search(r"constexpr int kScaleTop = (\d+);", SRC).group(1))
SCALE_MAX = int(re.search(r"constexpr int kScaleMax = (\d+);", SRC).group(1))
LOG2E = 1.4426950408889634
F16_MIN_NORMAL = 2.0 ** -14
TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -9}


def _split(x, dt):
    hi = x.to(dt).float()
    return hi, (x - hi).to(dt).float()


def _scale_exponent(m):
    """The kernel's scale_exponent on a tensor of row maxima."""
    be = (m.contiguous().view(torch.int32) >> 23) & 0xff
    return torch.where(be == 0, torch.full_like(be, SCALE_MAX),
                       torch.clamp(SCALE_TOP - be, max=SCALE_MAX))


def _pow2(n):
    return torch.ldexp(torch.ones(n.shape), n.float())


class _Rows:
    """A block's accumulator over its rows, and under float16 scaling the
    exponents of its rows."""

    def __init__(self, shape, scaled):
        self.acc = torch.zeros(shape)
        self.ex = torch.full(shape[:-1], SCALE_MAX, dtype=torch.int32)
        self.scaled = scaled

    def add(self, a, b, dt):
        """acc += (hi + lo) b for a = hi + lo, the scale applied to a."""
        if self.scaled:
            n = torch.minimum(self.ex, _scale_exponent(a.abs().amax(-1)))
            self.acc *= _pow2(torch.clamp(n - self.ex, min=-126))[..., None]
            self.ex = n
            a = a * _pow2(n)[..., None]
        hi, lo = _split(a, dt)
        self.acc += hi @ b + lo @ b

    def value(self):
        return self.acc * _pow2(-self.ex)[..., None] if self.scaled \
            else self.acc


def _rows(x, start, n, limit):
    """Rows [start, start + n) of (B, H, S, D) ``x``, those at or past
    ``limit`` zero (a TMA box past its map's end)."""
    out = torch.zeros(*x.shape[:2], n, x.shape[-1])
    stop = min(start + n, limit)
    if stop > start:
        out[:, :, :stop - start] = x[:, :, start:stop]
    return out


def emulate(q, k, v, out, lse, do, causal, kv_len, scale_ds=None):
    """The kernels' arithmetic on 16-bit (B, H, S, D) q, k, v, out and dO
    and fp32 lse: returns dq, dk, dv in fp32 before their rounding.
    ``scale_ds`` (default: float16) applies float16's dS scale."""
    dt = q.dtype
    scaled = dt == torch.float16 if scale_ds is None else scale_ds
    b, h, sq, d = q.shape
    sk = k.shape[2]
    sc = 1.0 / math.sqrt(d)
    offset = kv_len - sq
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * out.float()).sum(-1)

    def probs(s, dp, lse_, delta_, valid):
        p = torch.where(valid, torch.exp2(s * (sc * LOG2E) - lse_ * LOG2E),
                        torch.zeros(()))
        return p, p * (dp - delta_) * sc

    dq = torch.zeros(b, h, sq, d)
    for r0 in range(0, sq, TILE):
        rows = torch.arange(r0, r0 + TILE)
        last = kv_len - 1
        if causal:
            last = min(last, r0 + TILE - 1 + offset)
        n_tiles = last // TILE + 1 if last >= 0 else 0
        qt, dot = _rows(qf, r0, TILE, sq), _rows(dof, r0, TILE, sq)
        lt = _rows(lse[..., None], r0, TILE, sq)
        dlt = _rows(delta[..., None], r0, TILE, sq)
        wgs = [_Rows((b, h, TILE, d), scaled)]
        for t in range(n_tiles):
            keys = torch.arange(t * TILE, (t + 1) * TILE)
            kt, vt = _rows(kf, t * TILE, TILE, kv_len), _rows(
                vf, t * TILE, TILE, kv_len)
            valid = (keys[None, :] < kv_len) & (rows[:, None] < sq)
            if causal:
                valid &= keys[None, :] <= rows[:, None] + offset
            p, ds = probs(qt @ kt.transpose(-1, -2),
                          dot @ vt.transpose(-1, -2), lt, dlt, valid)
            wgs[0].add(ds, kt, dt)
        dq[:, :, r0:r0 + TILE] = wgs[0].value()[:, :, :min(TILE, sq - r0)]

    dk = torch.zeros(b, h, sk, d)
    dv = torch.zeros(b, h, sk, d)
    for r0 in range(0, min(sk, kv_len), TILE):
        keys = torch.arange(r0, r0 + TILE)
        kt, vt = _rows(kf, r0, TILE, kv_len), _rows(vf, r0, TILE, kv_len)
        t_first = max(0, r0 - offset) // TILE if causal else 0
        n_tiles = -(-sq // TILE) - t_first
        gv, gk = _Rows((b, h, TILE, d), False), _Rows((b, h, TILE, d), scaled)
        for t in range(n_tiles):
            c0 = (t_first + t) * TILE
            cols = torch.arange(c0, c0 + TILE)
            qt, dot = _rows(qf, c0, TILE, sq), _rows(dof, c0, TILE, sq)
            lt = _rows(lse[..., None], c0, TILE, sq)[..., 0][:, :, None]
            dlt = _rows(delta[..., None], c0, TILE, sq)[..., 0][:, :, None]
            valid = (keys[:, None] < kv_len) & (cols[None, :] < sq)
            if causal:
                valid &= keys[:, None] <= cols[None, :] + offset
            p, ds = probs(kt @ qt.transpose(-1, -2),
                          vt @ dot.transpose(-1, -2), lt, dlt, valid)
            gv.add(p, dot, dt)
            gk.add(ds, qt, dt)
        n = min(TILE, sk - r0)
        live = (keys < kv_len)[:n, None]
        for g, tot in ((dv, gv.value()), (dk, gk.value())):
            g[:, :, r0:r0 + n] = torch.where(live, tot[:, :, :n],
                                             torch.zeros(()))
    return dq, dk, dv


def _inputs(seed, b, h, sq, sk, d, dt, do_scale=1.0):
    rng = onp.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype("f4") * 0.5
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                      (b, h, sq, d))]
    arrs[3] = arrs[3] * onp.float32(do_scale)
    return [torch.from_numpy(a).to(dt) for a in arrs]


def _forward(q, k, v, causal, kv_len):
    """out (in q's type, as K1 returns it) and lse, from the port's plain
    forward on the widened values."""
    out, lse = tat.flash_attention_fwd(q.float(), k.float(), v.float(),
                                       causal, None, kv_len)
    return out.to(q.dtype), lse


def _reference(q, k, v, do, causal, kv_len):
    """``jax.vjp`` of the JAX package's flash_attention in fp32 on the
    widened values."""
    j = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(
        lambda q, k, v: jat.flash_attention(q, k, v, causal, None, kv_len),
        *j[:3])
    return [torch.from_numpy(onp.array(g)) for g in vjp(j[3])]


def _errors(got, ref, dt):
    """max |got - ref| / max|ref| per gradient, both rounded to dt."""
    out = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = r.to(dt).float()
        out[name] = float((g.to(dt).float() - r).abs().max()) \
            / float(r.abs().max())
    return out


#: (b, h, sq, sk, d, causal, kv_len)
CASES = [
    (1, 2, 150, 150, 16, True, None),
    (1, 2, 130, 200, 128, False, 170),
    (1, 2, 140, 160, 16, True, 100),
    (1, 1, 200, 200, 128, True, None),
]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,kv_len", CASES,
                         ids=[f"s{c[2]}-k{c[3]}-d{c[4]}-causal{c[5]}"
                              f"-kv{c[6]}" for c in CASES])
def test_emulation_against_reference_vjp(b, h, sq, sk, d, causal, kv_len,
                                         dt):
    q, k, v, do = _inputs(sq + sk + d, b, h, sq, sk, d, dt)
    kl = sk if kv_len is None else kv_len
    out, lse = _forward(q, k, v, causal, kl)
    got = emulate(q, k, v, out, lse, do, causal, kl)
    ref = _reference(q, k, v, do, causal, kv_len)
    errs = _errors(got, ref, dt)
    assert max(errs.values()) <= TOL[dt], errs
    if kl < sk:
        # keys at or past kv_len: exact zeros
        for g in got[1:]:
            assert bool((g[:, :, kl:] == 0).all())
    if causal and kl < sq:
        # query rows that see no key: zero dq
        assert bool((got[0][:, :, :sq - kl] == 0).all())


def test_small_do_needs_float16_scale():
    dt = torch.float16
    b, h, s, d = 1, 2, 256, 64
    q, k, v, do = _inputs(7, b, h, s, s, d, dt, do_scale=2.0 ** -11)
    out, lse = _forward(q, k, v, True, s)
    ref = _reference(q, k, v, do, True, None)
    # the regime: dS under float16's smallest normal, the gradients above
    mask = torch.triu(torch.full((s, s), -math.inf), 1)
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2)
                      / math.sqrt(d) + mask, -1)
    dp = do.float() @ v.float().transpose(-1, -2)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) / math.sqrt(d)
    assert float(ds.abs().max()) < F16_MIN_NORMAL
    assert all(float(r.abs().max()) >= F16_MIN_NORMAL for r in ref)
    scaled = _errors(emulate(q, k, v, out, lse, do, True, s), ref, dt)
    plain = _errors(emulate(q, k, v, out, lse, do, True, s,
                            scale_ds=False), ref, dt)
    assert max(scaled.values()) <= TOL[dt], scaled
    assert max(plain.values()) > TOL[dt], plain


def test_source_constants():
    """The emulation's constants are the source's: 64-row tiles (the
    wgmma m and the TMA box's rows), one warpgroup a block, float16's
    scale into [2^13, 2^14) below float16's largest finite value, and the
    swizzle by head dim that ``tensor_map_rows`` (common.cuh) and the
    descriptors share."""
    assert TILE == 64
    assert "const cuuint32_t box[4] = {(cuuint32_t)kSwizzle / 2, 64, 1, 1};" \
        in COMMON
    assert "static constexpr int kThreads = 128;" in SRC
    # a row max with biased exponent be lands in [2^(be-127+e), 2^(be-126+e))
    assert SCALE_TOP - 127 == 13 and 2.0 ** (SCALE_TOP - 126) < 65504
    assert SCALE_MAX <= 127
    sw = re.search(r"static constexpr int kSwizzle = D \* 2 >= 128 \? "
                   r"128 : D \* 2;", SRC)
    assert sw is not None
    assert {d: min(128, 2 * d) for d in (16, 32, 64, 128)} == {
        16: 32, 32: 64, 64: 128, 128: 128}
