"""The port's attention ops (mxnet_tpu_torch.ops.attention) against the
JAX package's, on the same numpy inputs.

On the CPU the port's ops take their plain PyTorch versions — the
functions its CUDA kernels are held to on the card by chip_smoke.py.
Here they are held to the JAX jnp paths and, where the JAX build can run
Pallas in interpret mode, to the TPU kernels themselves. Tolerance
rtol=2e-4, atol=2e-5: the JAX attention tests' own (fp32, different
summation order).
"""
import math

import numpy as onp
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jat
from mxnet_tpu_torch.ops import attention as tat

TOL = dict(rtol=2e-4, atol=2e-5)


def _mk(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype("float32")


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


# (id, sq, sk, causal, kv_len): the cases of tests/test_attention.py —
# ragged lengths, sq != sk (end-aligned causal offset) and kv_len on a
# longer cache buffer
FLASH_CASES = [
    ("ragged_causal", 200, 200, True, None),
    ("ragged_full", 77, 77, False, None),
    ("decode_shape", 1, 200, True, None),
    ("kv_len_16_70", 16, 96, True, 70),
    ("kv_len_70_70", 70, 96, True, 70),
    ("kv_len_16_16", 16, 96, True, 16),
    ("kv_len_1_33", 1, 96, True, 33),
]


def _flash_inputs(sq, sk, seed=1):
    rng = onp.random.RandomState(seed)
    return _mk(rng, 2, 2, sq, 32), _mk(rng, 2, 2, sk, 32), \
        _mk(rng, 2, 2, sk, 32)


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_forward_matches_jax(case):
    _, sq, sk, causal, kv_len = case
    q, k, v = _flash_inputs(sq, sk)
    out, lse = tat.flash_attention_fwd(_t(q), _t(k), _t(v), causal, None,
                                       kv_len)
    ref, res = jat._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, None, kv_len)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(res[4]), **TOL)
    # the public op returns the same output
    onp.testing.assert_array_equal(
        tat.flash_attention(_t(q), _t(k), _t(v), causal, None,
                            kv_len).numpy(), out.numpy())


@pytest.mark.requires_pallas
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_forward_matches_pallas_kernel(case):
    _, sq, sk, causal, kv_len = case
    q, k, v = _flash_inputs(sq, sk)
    out, lse = tat.flash_attention_fwd(_t(q), _t(k), _t(v), causal, None,
                                       kv_len)
    pal, pal_lse = jat.flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=kv_len, block_q=32, block_k=32, interpret=True)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(pal), **TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(pal_lse), **TOL)


def test_mha_reference_matches_jax():
    q, k, v = _flash_inputs(24, 40, seed=2)
    for causal in (False, True):
        onp.testing.assert_allclose(
            tat.mha_reference(_t(q), _t(k), _t(v), causal=causal).numpy(),
            onp.asarray(jat.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal)),
            **TOL)


def test_flash_kv_len_validation():
    q, k, v = (_t(a) for a in _flash_inputs(4, 96))
    for bad in (0, 97):
        with pytest.raises(ValueError, match="out of range"):
            tat.flash_attention(q, k, v, True, None, bad)


def test_flash_fully_masked_rows_return_zeros():
    """A causal query row that sees no key (kv_len < sq, rows with
    r + kv_len - sq < 0) gets the reference's value: its blockwise path
    does not re-mask after the exp, so such a row is the sum of V over
    the zero-padded buffer divided by the padded length, with lse =
    NEG_INF. The port's wrapper fills those rows the same way on both
    paths; every row equals the JAX package's ``_flash_fwd``."""
    q, k, v = _flash_inputs(8, 8, seed=3)
    out, lse = tat.flash_attention_fwd(_t(q), _t(k), _t(v), True, None, 4)
    ref, res = jat._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), True, None, 4)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(res[4]), **TOL)
    assert (lse[:, :, :4] == tat.NEG_INF).all()
    assert out[:, :, :4].abs().max().item() > 0.0


def _decode_inputs(sq, seed=4):
    rng = onp.random.RandomState(seed)
    b, h, s, d = 4, 2, 200, 32
    lengths = onp.asarray([0, 1, 77, 200], "int32")
    q = _mk(rng, b, h, sq, d)
    k, v = _mk(rng, b, h, s, d), _mk(rng, b, h, s, d)
    live = (onp.arange(s)[None, :] < lengths[:, None])[:, None, :, None]
    kz, vz = onp.where(live, k, 0.0), onp.where(live, v, 0.0)
    kn, vn = onp.where(live, k, onp.nan), onp.where(live, v, onp.nan)
    return q, kz, vz, kn.astype("f4"), vn.astype("f4"), lengths


@pytest.mark.parametrize("sq", [1, 3])
def test_decode_matches_jax_with_garbage_past_length(sq):
    """NaN garbage past each slot's length never reaches the port's
    output; an empty slot returns zeros; the rest equals the JAX jnp
    path run on the same cache with the garbage rows zeroed (the jnp
    path itself has no V-overhang guard: 0 * NaN would poison it)."""
    q, kz, vz, kn, vn, lengths = _decode_inputs(sq)
    out = tat.decode_attention(_t(q), _t(kn), _t(vn), _t(lengths)).numpy()
    assert onp.isfinite(out).all()
    assert onp.abs(out[0]).max() == 0.0
    ref = jat.decode_attention(jnp.asarray(q), jnp.asarray(kz),
                               jnp.asarray(vz), jnp.asarray(lengths))
    onp.testing.assert_allclose(out, onp.asarray(ref), **TOL)


@pytest.mark.requires_pallas
@pytest.mark.parametrize("sq", [1, 3])
def test_decode_matches_pallas_kernel_with_garbage(sq):
    q, _kz, _vz, kn, vn, lengths = _decode_inputs(sq)
    out = tat.decode_attention(_t(q), _t(kn), _t(vn), _t(lengths)).numpy()
    pal = jat.decode_attention_pallas(jnp.asarray(q), jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(lengths),
                                      block_k=64, interpret=True)
    onp.testing.assert_allclose(out, onp.asarray(pal), **TOL)


def test_decode_rows_match_sliced_reference():
    """Each slot equals plain attention over its valid prefix."""
    q, kz, vz, _kn, _vn, lengths = _decode_inputs(1, seed=5)
    out = tat.decode_attention(_t(q), _t(kz), _t(vz), lengths).numpy()
    for i in range(1, 4):
        ln = int(lengths[i])
        ref = tat.mha_reference(_t(q[i:i + 1]), _t(kz[i:i + 1, :, :ln]),
                                _t(vz[i:i + 1, :, :ln])).numpy()
        onp.testing.assert_allclose(out[i:i + 1], ref, **TOL)


def test_kernel_layout_checks():
    """The CUDA wrappers take strided views whose rows are contiguous
    (the head split's transpose) and refuse anything they would have to
    copy. The check itself runs on any tensor."""
    x = torch.zeros(1, 5, 2, 8).transpose(1, 2)       # (1, 2, 5, 8) view
    assert tat._kernel_strides("t", x) == x.stride()[:-1]
    with pytest.raises(ValueError, match="contiguous"):
        tat._kernel_strides("t", torch.zeros(1, 2, 8, 5).transpose(2, 3))
    with pytest.raises(ValueError, match="16-byte"):
        tat._kernel_strides("t", torch.zeros(1, 2, 5, 6))
    assert math.isclose(tat.NEG_INF, jat.NEG_INF)


# -- paged decode attention (K3's plain version) -------------------------
PS, P_MAX, N_PAGES = 8, 8, 40
PAGED_LENGTHS = [0, 1, PS - 1, PS, PS + 1, P_MAX * PS]


def _paged_inputs(sq, seed=6, garbage=onp.nan):
    """A pool whose slots' pages sit at shuffled places, with
    ``garbage`` in the scrap page 0, in every unreferenced page and in
    every row at or past a slot's length. Returns q, the garbage pools,
    the same pools with the garbage zeroed, the table and lengths."""
    rng = onp.random.RandomState(seed)
    b, h, d = len(PAGED_LENGTHS), 2, 32
    perm = rng.permutation(onp.arange(1, N_PAGES))
    table = onp.zeros((b, P_MAX), "i4")
    at = 0
    for i, n in enumerate(PAGED_LENGTHS):
        need = -(-n // PS)
        table[i, :need] = perm[at:at + need]
        at += need
    kp = onp.full((N_PAGES, h, PS, d), garbage, "f4")
    vp = onp.full((N_PAGES, h, PS, d), garbage, "f4")
    for i, n in enumerate(PAGED_LENGTHS):
        for t in range(n):
            kp[table[i, t // PS], :, t % PS] = _mk(rng, h, d)
            vp[table[i, t // PS], :, t % PS] = _mk(rng, h, d)
    q = _mk(rng, b, h, sq, d)
    lengths = onp.asarray(PAGED_LENGTHS, "i4")
    return q, kp, vp, onp.nan_to_num(kp), onp.nan_to_num(vp), table, lengths


def test_gather_pages_matches_jax():
    _q, _kn, _vn, kz, _vz, table, _ln = _paged_inputs(1)
    onp.testing.assert_array_equal(
        tat.gather_pages(_t(kz), _t(table)).numpy(),
        onp.asarray(jat.gather_pages(jnp.asarray(kz), jnp.asarray(table))))


@pytest.mark.parametrize("sq", [1, 3])
def test_paged_decode_matches_jax_with_garbage(sq):
    """Shuffled pages, NaN in the scrap page, in unreferenced pages and
    past every length: the port's output is finite, a len-0 row is
    zero, and every row equals the JAX jnp path run on the same pool
    with the garbage zeroed (the jnp path has no V-overhang guard)."""
    q, kn, vn, kz, vz, table, lengths = _paged_inputs(sq)
    out = tat.paged_decode_attention(_t(q), _t(kn), _t(vn), _t(table),
                                     _t(lengths)).numpy()
    assert onp.isfinite(out).all()
    assert onp.abs(out[0]).max() == 0.0
    ref = jat.paged_decode_attention(jnp.asarray(q), jnp.asarray(kz),
                                     jnp.asarray(vz), jnp.asarray(table),
                                     jnp.asarray(lengths))
    onp.testing.assert_allclose(out, onp.asarray(ref), **TOL)
    # the dense op over the gathered view is the same function
    dense = tat.decode_attention(_t(q), tat.gather_pages(_t(kn), _t(table)),
                                 tat.gather_pages(_t(vn), _t(table)),
                                 _t(lengths)).numpy()
    onp.testing.assert_array_equal(out, dense)


@pytest.mark.requires_pallas
@pytest.mark.parametrize("sq", [1, 3])
def test_paged_decode_matches_pallas_kernel_with_garbage(sq):
    q, kn, vn, _kz, _vz, table, lengths = _paged_inputs(sq)
    out = tat.paged_decode_attention(_t(q), _t(kn), _t(vn), _t(table),
                                     _t(lengths)).numpy()
    pal = jat.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    onp.testing.assert_allclose(out, onp.asarray(pal), **TOL)


def test_paged_decode_peek_row():
    """The prefix-hit peek: one slot, its own (1, P_max) table row."""
    q, kn, vn, kz, vz, table, lengths = _paged_inputs(1, seed=7)
    out = tat.paged_decode_attention(_t(q[4:5]), _t(kn), _t(vn),
                                     _t(table[4:5]), _t(lengths[4:5]))
    ref = jat.paged_decode_attention(jnp.asarray(q[4:5]), jnp.asarray(kz),
                                     jnp.asarray(vz), jnp.asarray(table[4:5]),
                                     jnp.asarray(lengths[4:5]))
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)


@pytest.mark.parametrize("start", ["scalar", "rows"])
def test_chunked_prefill_attention_matches_jax(start):
    rng = onp.random.RandomState(8)
    b, h, c, s, d = 3, 2, 8, 40, 16
    q, k, v = _mk(rng, b, h, c, d), _mk(rng, b, h, s, d), _mk(rng, b, h, s, d)
    st = onp.asarray(16, "i4") if start == "scalar" \
        else onp.asarray([0, 8, 32], "i4")
    out = tat.chunked_prefill_attention(_t(q), _t(k), _t(v), _t(st))
    ref = jat.chunked_prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(st))
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)
    # a plain int start is the scalar case
    if start == "scalar":
        onp.testing.assert_array_equal(
            tat.chunked_prefill_attention(_t(q), _t(k), _t(v), 16).numpy(),
            out.numpy())


def test_paged_kernel_wrapper_checks():
    """K3's wrapper refuses what the kernel does not take, before any
    build or launch (the checks run on any tensor)."""
    q, kn, vn, _kz, _vz, table, lengths = (_t(a) for a in _paged_inputs(1))
    with pytest.raises(ValueError, match="contiguous"):
        tat._paged_decode_cuda(q, kn.transpose(2, 3).contiguous()
                               .transpose(2, 3), vn, table, lengths, 0.1)
    with pytest.raises(ValueError, match="int32"):
        tat._paged_decode_cuda(q, kn, vn, table.long(), lengths, 0.1)
    with pytest.raises(ValueError, match="int32"):
        tat._paged_decode_cuda(q, kn, vn, table, lengths[:3], 0.1)
    with pytest.raises(ValueError, match="pool layout"):
        tat._paged_decode_cuda(q, kn[:, :1], vn[:, :1], table, lengths, 0.1)
    with pytest.raises(TypeError, match="float32"):
        tat._paged_decode_cuda(q, kn.double(), vn, table, lengths, 0.1)


def test_int8_pool_is_a_later_slice():
    """The int8 pool, a later slice when this test was written, is
    served now: an int8 copy of the pool with per-page scales gives the
    JAX jnp path's output (tests/test_torch_kvquant.py holds it in
    full)."""
    q, _kn, _vn, kz, vz, table, lengths = _paged_inputs(1)
    ks = onp.maximum(onp.abs(kz).max(axis=(2, 3)), 1e-12) / 127.0
    vs = onp.maximum(onp.abs(vz).max(axis=(2, 3)), 1e-12) / 127.0
    kq = onp.round(kz / ks[:, :, None, None]).astype("i1")
    vq = onp.round(vz / vs[:, :, None, None]).astype("i1")
    ks, vs = ks.astype("f4"), vs.astype("f4")
    out = tat.paged_decode_attention(_t(q), _t(kq), _t(vq), _t(table),
                                     _t(lengths), k_scale=_t(ks),
                                     v_scale=_t(vs))
    ref = jat.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
        jnp.asarray(lengths), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)
    onp.testing.assert_array_equal(
        tat.expand_page_scales(_t(ks), _t(table), PS).numpy(),
        onp.asarray(jat.expand_page_scales(jnp.asarray(ks),
                                           jnp.asarray(table), PS)))
