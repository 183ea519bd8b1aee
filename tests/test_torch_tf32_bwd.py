"""Why K1-bwd's fp32 instance (csrc/flash_attention_bwd.cu,
``flash_bwd_{dq,dkv}_tc_kernel``) splits every operand for the TF32
tensor cores (3xTF32), P and dS included, shown in numpy on the CPU.

The kernel's arithmetic, emulated as ``tests/test_torch_tf32_split.py``
emulates K1's: each fp32 operand x is rounded to TF32 as
``cvt.rna.tf32.f32`` rounds (``big``), ``small = x - big`` reaches the
tensor core truncated to TF32, a product is ``small * big + big * small
+ big * big`` with exact products summed in float64 and rounded to fp32.
S = Q K^T and dP = dO V^T so; P = exp2(s * scale * log2(e) - lse *
log2(e)) where the pair is visible (else 0 by a select), ``delta =
sum(dO * out)``, dS = P (dP - delta) scale in fp32; then dQ = dS K,
dK = dS^T Q and dV = P^T dO with P and dS split as the A operands. The
forward's out and lse come from the port's fp32 plain version, as on
the card. The result is held to ``jax.vjp`` of the JAX package's
``flash_attention`` (its ``_flash_bwd``) in float64 at
``chip_smoke.py``'s gate ``BWD_TOL[""]``: 1e-4 x max(1, max|ref|) per
gradient, and 1e-4 x max|ref| in the small-dO case (dO x 2^-12). The
same computation with single TF32 products (one rounded operand pair a
product) is the record of why the kernel splits: it misses the gate.
"""
import math

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.ops import attention as jat
from mxnet_tpu_torch.ops import attention as tat

from test_torch_tf32_split import matmul_3xtf32, matmul_tf32

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: chip_smoke.py's BWD_TOL[""] and its small-dO case's scale of dO
BWD_TOL = 1e-4
SMALL_DO = 2.0 ** -12
LOG2E = 1.4426950408889634

#: (Sq, Sk, causal, kv_len) at B = 1, H = 2, D = 64
CASES = {
    "causal": (128, 128, True, None),
    "noncausal": (128, 128, False, None),
    "causal_kv_len_below_sq": (128, 128, True, 96),
}


def _inputs(sq, sk, seed, d=64):
    rng = onp.random.RandomState(seed)
    return [(rng.standard_normal(s) * 0.5).astype("f4")
            for s in ((1, 2, sq, d), (1, 2, sk, d), (1, 2, sk, d),
                      (1, 2, sq, d))]


def _kernel_bwd(q, k, v, do, causal, kv_len, matmul):
    """The kernel's arithmetic with ``matmul`` for every product."""
    sq, d = q.shape[-2:]
    kl = kv_len or k.shape[-2]
    scale = onp.float32(1.0 / math.sqrt(d))
    out, lse = tat.flash_attention_fwd(*(torch.from_numpy(t)
                                         for t in (q, k, v)),
                                       causal, float(scale), kl)
    out, lse = out.numpy(), lse.numpy()
    k, v = k[..., :kl, :], v[..., :kl, :]          # never read past kv_len
    row = onp.arange(sq)[:, None]
    col = onp.arange(kl)[None, :]
    valid = col <= row + (kl - sq) if causal else onp.ones((sq, kl), bool)
    t = onp.swapaxes
    s = matmul(q, t(k, -1, -2))
    arg = (s * onp.float32(scale * LOG2E)
           - lse[..., None] * onp.float32(LOG2E)).astype("f4")
    p = onp.where(valid, onp.exp2(onp.where(valid, arg, 0)), 0) \
        .astype("f4")
    delta = (do * out).sum(-1, dtype="f4")
    dp = matmul(do, t(v, -1, -2))
    ds = (p * (dp - delta[..., None]) * scale).astype("f4")
    dq = matmul(ds, k)
    dk = matmul(t(ds, -1, -2), q)
    dv = matmul(t(p, -1, -2), do)
    return dq, dk, dv


def _reference(arrs, causal, kv_len):
    """float64 ``jax.vjp`` of the JAX package's flash attention: dq and
    dk, dv over the first kv_len keys (past it the reference's are 0)."""
    with jax.enable_x64(True):
        q, k, v, do = (jnp.asarray(a.astype("f8")) for a in arrs)
        _, vjp = jax.vjp(lambda q, k, v: jat.flash_attention(
            q, k, v, causal, None, kv_len), q, k, v)
        dq, dk, dv = (onp.asarray(g) for g in vjp(do))
    kl = kv_len or dk.shape[-2]
    assert not dk[..., kl:, :].any() and not dv[..., kl:, :].any()
    return dq, dk[..., :kl, :], dv[..., :kl, :]


def _errors(got, ref, rel):
    return {name: float(onp.abs(g - r).max())
            / (float(onp.abs(r).max()) if rel
               else max(1.0, float(onp.abs(r).max())))
            for name, g, r in zip(("dq", "dk", "dv"), got, ref)}


@pytest.fixture(scope="module")
def references():
    """The float64 reference of every case and of the small-dO case."""
    out = {}
    for name, (sq, sk, causal, kv_len) in CASES.items():
        arrs = _inputs(sq, sk, seed=30)
        out[name] = arrs, _reference(arrs, causal, kv_len)
    arrs = _inputs(128, 128, seed=31)
    arrs[3] = (arrs[3] * onp.float32(SMALL_DO)).astype("f4")
    out["small_do"] = arrs, _reference(arrs, True, None)
    return out


@pytest.mark.parametrize("case", list(CASES) + ["small_do"])
def test_3xtf32_backward_within_the_kernel_gate(references, case):
    arrs, ref = references[case]
    _, _, causal, kv_len = CASES.get(case, (0, 0, True, None))
    got = _kernel_bwd(*arrs, causal, kv_len, matmul_3xtf32)
    err = _errors(got, ref, rel=case == "small_do")
    print(f"3xTF32 {case}: {err}")
    assert max(err.values()) <= BWD_TOL


@pytest.mark.parametrize("case", ["causal", "small_do"])
def test_single_tf32_backward_misses_the_gate(references, case):
    """The record: single TF32 products (P and dS rounded once too) land
    outside the fp32 contract."""
    arrs, ref = references[case]
    got = _kernel_bwd(*arrs, True, None, matmul_tf32)
    err = _errors(got, ref, rel=case == "small_do")
    print(f"single TF32 {case}: {err}")
    assert max(err.values()) > 2 * BWD_TOL
