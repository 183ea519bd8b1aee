"""Why K1 (csrc/flash_attention.cu) splits its operands for the TF32
tensor cores (3xTF32), shown in numpy on the CPU.

The kernel rounds each fp32 operand x to TF32 as ``cvt.rna.tf32.f32``
does (10 mantissa bits, round to nearest, ties away from zero), giving
``big``; ``small = x - big`` is exact in fp32 and reaches the tensor
core as it is, which reads a TF32 operand's top 19 bits (emulated here
as truncation, the worse case). Each product is
``small * big + big * small + big * big`` with fp32 accumulation. Here
the rounding is emulated on the fp32 bit pattern, the products are
exact (float64 sums rounded to fp32, as a tensor core's exact products
summed in fp32 would be, up to the order of the sum), and attention at a
cut prefill shape (1, 2, 256, 64), causal, is held to the float64
result at ``chip_smoke.py``'s kernel tolerances (out 2e-5, lse 1e-4) and
to the port's plain version (``_blockwise_fwd``, fp32). Single TF32
(``big * big`` only) is computed beside it: its output error is the
record of why the kernel does not use it.
"""
import math

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import attention as tat

#: chip_smoke.py's K1 gates
OUT_TOL, LSE_TOL = 2e-5, 1e-4


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits of the fp32 pattern,
    rounding half away from zero (add half an ulp of TF32 to the
    magnitude bits, clear the low 13)."""
    x = onp.asarray(x, onp.float32)
    u = x.view(onp.uint32).astype(onp.uint64)
    u = onp.where(onp.isfinite(x), u + 0x1000, u) & 0xFFFFE000
    return u.astype(onp.uint32).view(onp.float32)


def tf32_trunc(x):
    """A TF32 operand as the tensor core reads it: the low 13 bits of
    the fp32 pattern dropped."""
    x = onp.asarray(x, onp.float32)
    return (x.view(onp.uint32) & onp.uint32(0xFFFFE000)).view(onp.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_trunc(onp.float32(x) - big)


def _dot(a, b):
    return a.astype(onp.float64) @ b.astype(onp.float64)


def matmul_3xtf32(a, b):
    (ab, a_s), (bb, b_s) = split(a), split(b)
    return (_dot(a_s, bb) + _dot(ab, b_s) + _dot(ab, bb)).astype(onp.float32)


def matmul_tf32(a, b):
    return _dot(tf32_rna(a), tf32_rna(b)).astype(onp.float32)


def matmul_f64(a, b):
    return a @ b


def attention(q, k, v, matmul):
    """Causal attention with the kernel's structure: q scaled before the
    product, masked scores at -1e30, p re-masked to 0, out = (p v) / l,
    lse = m + log(l). fp32 between the products unless the inputs are
    float64."""
    dt = q.dtype
    s_len = q.shape[-2]
    qs = (q * dt.type(1.0 / math.sqrt(q.shape[-1]))).astype(dt)
    s = matmul(qs, onp.swapaxes(k, -1, -2))
    mask = onp.tril(onp.ones((s_len, s_len), bool))
    s = onp.where(mask, s, dt.type(-1e30)).astype(dt)
    m = s.max(-1, keepdims=True)
    p = onp.where(mask, onp.exp(s - m), 0).astype(dt)
    l = p.sum(-1, keepdims=True, dtype=dt)
    return (matmul(p, v) / l).astype(dt), (m + onp.log(l))[..., 0]


@pytest.fixture(scope="module")
def inputs():
    rng = onp.random.RandomState(0)
    return [(rng.standard_normal((1, 2, 256, 64)) * 0.5).astype("f4")
            for _ in range(3)]


def test_tf32_rounding_ties_away_from_zero():
    one_ulp = onp.float32(2.0 ** -10)          # TF32's ulp at 1
    tie = onp.float32(1.0 + 2.0 ** -11)
    assert tf32_rna(tie) == onp.float32(1.0) + one_ulp
    assert tf32_rna(-tie) == -(onp.float32(1.0) + one_ulp)
    below = onp.nextafter(tie, onp.float32(0))
    assert tf32_rna(below) == onp.float32(1.0)
    # rounding is not truncation: 1 + 3 * 2^-12 rounds up to 1 + 2^-10
    up = onp.float32(1.0 + 3 * 2.0 ** -12)
    assert tf32_rna(up) == onp.float32(1.0) + one_ulp
    assert tf32_trunc(up) == onp.float32(1.0)
    # the split recovers x to about 22 bits
    for x in (onp.float32(math.pi), up, onp.float32(-0.1)):
        big, small = split(x)
        assert abs(float(big) + float(small) - float(x)) <= \
            2.0 ** -21 * abs(float(x))


def test_3xtf32_attention_within_the_kernel_gates(inputs):
    q, k, v = inputs
    ref_o, ref_l = attention(*(t.astype(onp.float64) for t in inputs),
                             matmul_f64)
    out, lse = attention(q, k, v, matmul_3xtf32)
    err_o = float(onp.abs(out - ref_o).max())
    err_l = float(onp.abs(lse - ref_l).max())
    print(f"3xTF32: out {err_o:.3g}, lse {err_l:.3g} against float64")
    assert err_o <= OUT_TOL and err_l <= LSE_TOL
    # and against the plain version the kernel is held to on the card
    plain, plain_lse = tat._blockwise_fwd(
        *(torch.from_numpy(t) for t in inputs), True, 1.0 / math.sqrt(64))
    assert float(onp.abs(out - plain.numpy()).max()) <= OUT_TOL
    assert float(onp.abs(lse - plain_lse.numpy()).max()) <= LSE_TOL


def test_single_tf32_misses_the_output_gate(inputs):
    """The record: one TF32 product per fp32 one keeps ~10 bits, and the
    output then lands far outside 2e-5."""
    q, k, v = inputs
    ref_o, ref_l = attention(*(t.astype(onp.float64) for t in inputs),
                             matmul_f64)
    out, lse = attention(q, k, v, matmul_tf32)
    err_o = float(onp.abs(out - ref_o).max())
    err_l = float(onp.abs(lse - ref_l).max())
    print(f"single TF32: out {err_o:.3g}, lse {err_l:.3g} against float64")
    assert err_o > 10 * OUT_TOL
