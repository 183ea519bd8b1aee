"""The backward of the port's flash attention against the JAX package.

``mxnet_tpu_torch.ops.attention.flash_attention`` is differentiable
through ``_FlashAttention``: on the CPU its backward is the plain
blockwise ``_flash_bwd`` (on the card, K1-bwd, which ``chip_smoke.py``
holds to it there). Here the port's gradients are held to ``jax.vjp``
of ``mxnet_tpu.ops.attention.flash_attention`` (the reference's
``custom_vjp``, whose backward is its own blockwise ``_flash_bwd``) on
the same seeded numpy inputs: causal and not, ``kv_len`` below the key
buffer, causal ``kv_len`` below the query length (rows that see no key
get zero gradients in both), sequences that are not a multiple of the
512-row block, in fp32 and bf16 (and two of them in float16).

Tolerances, with the largest gap measured over these cases (relative
to max(1, max|ref|)): fp32 within 1e-5 (measured 1.6e-7; the two sum in
different orders); bf16 within 2^-7 (measured 9.8e-4, one bf16 step of
a gradient below 1 in magnitude: both round the scores to bf16 and
compute the rest in fp32, and each gradient is rounded once to bf16);
float16 within 2^-7 too (measured 3.3e-4).
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import attention as jat

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import attention as tat

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -7}

#: (B, H, Sq, Sk, D, causal, kv_len)
CASES = {
    "causal": (1, 2, 100, 100, 16, True, None),
    "noncausal": (1, 2, 100, 100, 16, False, None),
    "kv_len_below_sk": (2, 2, 40, 96, 32, False, 70),
    "causal_kv_len_below_sk": (1, 2, 50, 96, 16, True, 77),
    "causal_unseen_rows": (1, 2, 70, 96, 16, True, 40),
    "not_a_block_multiple": (1, 1, 600, 700, 16, True, 650),
}


def _inputs(b, h, sq, sk, d, seed):
    rng = onp.random.RandomState(seed)
    return [(rng.standard_normal(s) * 0.5).astype("f4")
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                      (b, h, sq, d))]


def _reference(arrs, causal, kv_len, dtype):
    jdt = getattr(jnp, dtype)
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in arrs)
    out, vjp = jax.vjp(
        lambda q, k, v: jat.flash_attention(q, k, v, causal, None, kv_len),
        q, k, v)
    return (onp.asarray(out.astype(jnp.float32)),
            [onp.asarray(g.astype(jnp.float32)) for g in vjp(do)])


def _port(arrs, causal, kv_len, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt).requires_grad_(True)
               for a in arrs[:3])
    out = tat.flash_attention(q, k, v, causal, None, kv_len)
    out.backward(torch.from_numpy(arrs[3]).to(tdt))
    return out, [t.grad for t in (q, k, v)]


@pytest.mark.parametrize("case,dtype", [
    (c, dt) for c in CASES for dt in ("float32", "bfloat16")] + [
    ("causal", "float16"), ("kv_len_below_sk", "float16")])
def test_backward_matches_reference_vjp(case, dtype):
    b, h, sq, sk, d, causal, kv_len = CASES[case]
    arrs = _inputs(b, h, sq, sk, d, seed=len(case))
    ref_out, ref = _reference(arrs, causal, kv_len, dtype)
    out, grads = _port(arrs, causal, kv_len, dtype)
    onp.testing.assert_allclose(out.detach().float().numpy(), ref_out,
                                atol=TOL[dtype], rtol=0)
    for name, g, r in zip("qkv", grads, ref):
        assert g.dtype == getattr(torch, dtype), name
        scale = max(1.0, float(onp.abs(r).max()))
        err = float(onp.abs(g.float().numpy() - r).max())
        assert err <= TOL[dtype] * scale, (case, dtype, name, err / scale)
    if kv_len is not None and kv_len < sk:
        # keys at or past kv_len: exact zeros, in the port and the
        # reference alike
        for g, r in zip(grads[1:], ref[1:]):
            assert bool((g[:, :, kv_len:] == 0).all())
            assert not r[:, :, kv_len:].any()


def test_unseen_rows_get_zero_gradients():
    """Causal rows that see no key (kv_len < Sq) come out of the forward
    as the reference's mean of V, and get zero dq (p = 0 on every key)."""
    b, h, sq, sk, d, causal, kv_len = CASES["causal_unseen_rows"]
    arrs = _inputs(b, h, sq, sk, d, seed=3)
    _, (dq, _, _) = _port(arrs, causal, kv_len, "float32")
    unseen = sq - kv_len
    assert bool((dq[:, :, :unseen] == 0).all())
    assert bool((dq[:, :, unseen:] != 0).any())


def test_no_graph_without_grad_and_no_kernel_on_cpu():
    """Without grad mode (every serving call) flash_attention saves
    nothing and builds no graph; on the CPU no kernel is launched."""
    arrs = _inputs(1, 2, 33, 33, 16, seed=5)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    tat.reset_launch_counts()
    with torch.no_grad():
        out = tat.flash_attention(q, k, v, True)
    assert out.grad_fn is None and not out.requires_grad
    out = tat.flash_attention(q, k, v, True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.sum().backward()
    assert not any(tat.launch_counts().values())


def test_flash_attention_bwd_public_matches_autograd():
    """``flash_attention_bwd`` from the forward's own (out, lse) is what
    autograd applies."""
    arrs = _inputs(1, 2, 45, 60, 32, seed=7)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out, lse = tat.flash_attention_fwd(q, k, v, True, None, 50)
    want = tat.flash_attention_bwd(q, k, v, out, lse, do, True, None, 50)
    _, got = _port(arrs, True, 50, "float32")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_npx_flash_attention_grads_match_reference():
    """``npx.flash_attention`` on NDArrays under ``record()``: the
    gradients reach ``.grad`` through ``backward``, as the JAX
    package's do."""
    arrs = _inputs(1, 2, 40, 64, 16, seed=11)
    grads = {}
    for mod, ctx in ((jmx, None), (tmx, tmx.cpu())):
        with (ctx if ctx is not None else jax.default_device(
                jax.devices("cpu")[0])):
            q, k, v, do = (mod.np.array(a) for a in arrs)
            for t in (q, k, v):
                t.attach_grad()
            with mod.autograd.record():
                out = mod.npx.flash_attention(q, k, v, causal=True,
                                              kv_len=50)
            out.backward(do)
            grads[mod.__name__] = [t.grad.asnumpy() for t in (q, k, v)]
    for g, r in zip(grads["mxnet_tpu_torch"], grads["mxnet_tpu"]):
        scale = max(1.0, float(onp.abs(r).max()))
        assert float(onp.abs(g - r).max()) <= 1e-5 * scale
