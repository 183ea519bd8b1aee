"""The port's weight-only int8 path (mxnet_tpu_torch.ops.quantized and
GPTModel.quantize_params) against the JAX package's, on the same numpy
inputs and the same gpt_small weights.

``quantize_channelwise`` and the model's int8 tables must be BITWISE
the reference's (fp32 division, round half to even, clip, eps floor).
``dequant_matmul``'s plain version — the function K4 is held to on the
card — is held here to the JAX blocked jnp path and, where the JAX
build runs Pallas in interpret mode, to the TPU kernel, at the
attention tests' tolerance (rtol=2e-4, atol=2e-5: fp32, another
summation order). Generation logits of the quantized model are held to
the JAX int8 model's at the model tests' tolerance (rtol=2e-3,
atol=2e-4).
"""
import numpy as onp
import pytest
import torch
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.ops import quantized as jqz
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import quantized as tqz

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
#: gpt_small's defaults: vocab 1000, 64 units, 2 layers, 4 heads
VOCAB, SLOTS, SMAX = 1000, 4, 64


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def _weights(rng, n, k, zero_row=None):
    w = (rng.randn(n, k) * 0.05).astype("f4")
    if zero_row is not None:
        w[zero_row] = 0.0
    return w


@pytest.mark.parametrize("shape,axis", [((48, 32), 0), ((1024, 64), 0),
                                        ((16, 40), 1)],
                         ids=["small", "two_blocks", "axis1"])
def test_quantize_channelwise_bitwise_equal_to_jax(shape, axis):
    """Tables and scales bitwise equal, an all-zero channel included
    (scale eps/127, int8 zeros, dequantizes to exact zeros)."""
    rng = onp.random.RandomState(0)
    w = _weights(rng, *shape)
    if axis == 0:
        w[3] = 0.0
    else:
        w[:, 3] = 0.0
    w[1, 1] = 0.5 * (onp.abs(w).max() / 127.0) * 3   # a .5 rounding case
    wq, sc = tqz.quantize_channelwise(_t(w), axis=axis)
    jwq, jsc = jqz.quantize_channelwise(jnp.asarray(w), axis=axis)
    assert wq.dtype == torch.int8 and sc.dtype == torch.float32
    onp.testing.assert_array_equal(wq.numpy(), onp.asarray(jwq))
    onp.testing.assert_array_equal(sc.numpy(), onp.asarray(jsc))
    zero = wq[3] if axis == 0 else wq[:, 3]
    assert zero.abs().max().item() == 0
    assert sc[3].item() == onp.float32(onp.float32(1e-12) / 127.0)


@pytest.mark.parametrize("n,k,lead,block", [
    (48, 32, (5,), 512),          # one block: the whole N
    (1024, 64, (2, 3), 512),      # two 512-channel blocks, leading dims
    (96, 64, (7,), 32),           # three blocks of 32
    (80, 48, (1, 1), 512),        # N not a multiple of the block
], ids=["one_block", "two_blocks_lead", "block32", "uneven"])
def test_dequant_matmul_matches_jax(n, k, lead, block):
    rng = onp.random.RandomState(1)
    wq, sc = tqz.quantize_channelwise(_t(_weights(rng, n, k, zero_row=2)))
    x = (rng.randn(*lead, k) * 0.5).astype("f4")
    out = tqz.dequant_matmul(_t(x), wq, sc, block_n=block)
    ref = jqz.dequant_matmul(jnp.asarray(x), jnp.asarray(wq.numpy()),
                             jnp.asarray(sc.numpy()), block_n=block)
    assert out.shape == (*lead, n)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)
    assert out[..., 2].abs().max().item() == 0.0
    # blocked and unblocked plain versions agree
    onp.testing.assert_allclose(
        out.numpy(), tqz.dequant_matmul(_t(x), wq, sc, block_n=n).numpy(),
        **TOL)


@pytest.mark.requires_pallas
@pytest.mark.parametrize("n,block", [(1024, 512), (96, 32)],
                         ids=["two_blocks", "block32"])
def test_dequant_matmul_matches_pallas_kernel(n, block):
    rng = onp.random.RandomState(2)
    k = 64
    wq, sc = tqz.quantize_channelwise(_t(_weights(rng, n, k, zero_row=5)))
    x = (rng.randn(8, k) * 0.5).astype("f4")
    out = tqz.dequant_matmul(_t(x), wq, sc, block_n=block)
    pal = jqz.dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(wq.numpy()),
                                    jnp.asarray(sc.numpy()), block_n=block,
                                    interpret=True)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(pal), **TOL)


#: K4's cases on the card: M = 1 (peek), M <= 8 (decode: the GEMV
#: instance), M = 32 (a prefill chunk: the tiled instance)
BIAS_MS = (1, 8, 32)


@pytest.mark.parametrize("with_bias", [False, True], ids=["none", "bias"])
@pytest.mark.parametrize("m", BIAS_MS)
def test_dequant_matmul_bias_matches_jax(m, with_bias):
    """``dequant_matmul(..., bias=b)`` equals the reference's ``_proj``
    composition ``dequant_matmul(x, wq, sc) + b`` (bitwise: the same
    blocked product, then the same fp32 add); ``bias=None`` is the bare
    product."""
    rng = onp.random.RandomState(7)
    n, k = 96, 64
    wq, sc = tqz.quantize_channelwise(_t(_weights(rng, n, k, zero_row=3)))
    x = (rng.randn(m, k) * 0.5).astype("f4")
    b = (rng.randn(n) * 0.1).astype("f4") if with_bias else None
    out = tqz.dequant_matmul(_t(x), wq, sc, block_n=32,
                             bias=None if b is None else _t(b))
    ref = jqz.dequant_matmul(jnp.asarray(x), jnp.asarray(wq.numpy()),
                             jnp.asarray(sc.numpy()), block_n=32)
    if b is not None:
        ref = ref + jnp.asarray(b)
    assert out.shape == (m, n)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref), **TOL)
    plain = tqz.dequant_matmul(_t(x), wq, sc, block_n=32).numpy()
    if b is not None:
        onp.testing.assert_array_equal(out.numpy(), plain + b)
    else:
        onp.testing.assert_array_equal(out.numpy(), plain)


@pytest.mark.requires_pallas
@pytest.mark.parametrize("m", BIAS_MS)
def test_dequant_matmul_bias_matches_pallas_kernel(m):
    rng = onp.random.RandomState(8)
    n, k = 96, 64
    wq, sc = tqz.quantize_channelwise(_t(_weights(rng, n, k, zero_row=1)))
    x = (rng.randn(m, k) * 0.5).astype("f4")
    b = (rng.randn(n) * 0.1).astype("f4")
    out = tqz.dequant_matmul(_t(x), wq, sc, block_n=32, bias=_t(b))
    pal = jqz.dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(wq.numpy()),
                                    jnp.asarray(sc.numpy()), block_n=32,
                                    interpret=True) + jnp.asarray(b)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(pal), **TOL)


def test_kernel_wrapper_checks_bias():
    """K4's wrapper refuses a bias the epilogue cannot read, before any
    build or launch."""
    wq, sc = tqz.quantize_channelwise(torch.ones(8, 16))
    x = torch.ones(2, 16)
    with pytest.raises(ValueError, match="bias shape"):
        tqz._dequant_matmul_cuda(x, wq, sc, torch.ones(4))
    with pytest.raises(TypeError, match="float32"):
        tqz._dequant_matmul_cuda(x, wq, sc, torch.ones(8).double())
    with pytest.raises(ValueError, match="contiguous"):
        tqz._dequant_matmul_cuda(x, wq, sc, torch.ones(8, 2)[:, 0])


def test_dequant_matmul_shape_errors():
    wq, sc = tqz.quantize_channelwise(torch.ones(8, 16))
    with pytest.raises(ValueError, match="features"):
        tqz.dequant_matmul(torch.ones(2, 12), wq, sc)
    with pytest.raises(ValueError, match="scales shape"):
        tqz.dequant_matmul(torch.ones(2, 16), wq, sc[:4])
    with pytest.raises(ValueError, match="bias shape"):
        tqz.dequant_matmul(torch.ones(2, 16), wq, sc, bias=torch.ones(1))


def test_kernel_wrapper_checks():
    """K4's wrapper refuses what the kernel does not take, before any
    build or launch (the checks run on any tensor)."""
    wq, sc = tqz.quantize_channelwise(torch.ones(8, 16))
    x = torch.ones(2, 16)
    with pytest.raises(TypeError, match="int8"):
        tqz._dequant_matmul_cuda(x, wq.float(), sc)
    with pytest.raises(TypeError, match="float32"):
        tqz._dequant_matmul_cuda(x.double(), wq, sc)
    with pytest.raises(ValueError, match="contiguous"):
        tqz._dequant_matmul_cuda(torch.ones(16, 2).T, wq, sc)
    wq8, sc8 = tqz.quantize_channelwise(torch.ones(8, 8))
    with pytest.raises(ValueError, match="multiple of 16"):
        tqz._dequant_matmul_cuda(torch.ones(2, 8), wq8, sc8)


# -- the quantized model ----------------------------------------------
@pytest.fixture(scope="module")
def pair():
    onp.random.seed(1234)
    mx.np.random.seed(1234)
    jnet = jgpt.gpt_small()
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tgpt.gpt_small(device="cpu")
    tgpt.load_jax_params(tnet, params)
    jnet.quantize_params()
    tnet.quantize_params()
    return jnet, tnet


def test_quantize_params_tables_bitwise_equal_to_jax(pair):
    """From the same fp32 weights, every projection of every layer gets
    int8 tables and scales bitwise equal to the JAX model's."""
    jnet, tnet = pair
    assert tnet.quantized and jnet.quantized
    assert len(tnet._quant) == len(jnet._quant) == 2
    for jtab, ttab in zip(jnet._quant, tnet._quant):
        assert sorted(ttab) == sorted(jtab) == sorted(
            tgpt._QUANTIZED_PROJECTIONS)
        for name, (jwq, jsc) in jtab.items():
            twq, tsc = ttab[name]
            onp.testing.assert_array_equal(twq.numpy(), onp.asarray(jwq))
            onp.testing.assert_array_equal(tsc.numpy(), onp.asarray(jsc))
    assert tnet.quantized_param_stats() == jnet.quantized_param_stats()


def test_quantized_generation_logits_match_jax(pair):
    """Prefill and decode through the int8 projections agree with the
    JAX int8 model; the plain forward stays fp32 in both packages."""
    jnet, tnet = pair
    rng = onp.random.RandomState(3)
    padded = onp.zeros((2, 16), "i4")
    padded[0, :11] = rng.randint(0, VOCAB, 11)
    padded[1, :5] = rng.randint(0, VOCAB, 5)
    jc, tc = jnet.init_cache(SLOTS, SMAX), tnet.init_cache(SLOTS, SMAX)
    jl, jc = jnet.prefill(padded, [11, 5], jc, slots=[1, 3])
    tl, tc = tnet.prefill(padded, [11, 5], tc, slots=[1, 3])
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **MODEL_TOL)
    for _ in range(4):
        toks = rng.randint(0, VOCAB, SLOTS).astype("i4")
        jl, jc = jnet.decode_step(toks, jc)
        tl, tc = tnet.decode_step(toks, tc)
        onp.testing.assert_allclose(tl.numpy()[[1, 3]],
                                    onp.asarray(jl)[[1, 3]], **MODEL_TOL)
    # the int8 path really differs from fp32 (the rounding is visible)
    fp32 = tgpt.gpt_small(device="cpu")
    tgpt.load_jax_params(fp32, {k: p._read().numpy() for k, p in
                                tnet.collect_params().items()})
    fl, _ = fp32.prefill(padded, [11, 5], fp32.init_cache(SLOTS, SMAX),
                         slots=[1, 3])
    tl, _ = tnet.prefill(padded, [11, 5], tnet.init_cache(SLOTS, SMAX),
                         slots=[1, 3])
    assert (fl - tl).abs().max().item() > 1e-6
    toks = padded[:1, :11]
    onp.testing.assert_allclose(tnet(toks).numpy(),
                                jnet(mx.np.array(toks)).asnumpy(),
                                **MODEL_TOL)
    onp.testing.assert_array_equal(tnet(toks).numpy(), fp32(toks).numpy())
    assert all(blk._qbind is None for blk in tnet._blocks())


def test_quantize_params_validation(pair):
    _, tnet = pair
    with pytest.raises(ValueError, match="quantizable"):
        tnet.quantize_params(include=("ln1",))


#: chip_smoke.py's K4 gate: within 2e-5 x max|ref| of the plain version
DEQUANT_REL_TOL = 2e-5


def _tile_kernel_product(x, wq, sc, b, split):
    """K4's tile route (csrc/dequant_matmul.cu ``dequant_tile_kernel``)
    in numpy: the int8 weight is exact in TF32, x is split as
    ``tests/test_torch_tf32_split.py`` splits (``big`` rounded as
    ``cvt.rna`` rounds, ``small`` truncated to TF32 by the core), the two
    products ``big * w + small * w`` are exact and summed in float64,
    rounded to fp32, then scaled per channel and the bias added.
    ``split=False``: x rounded to TF32 once (single TF32)."""
    from test_torch_tf32_split import split as tf32_split, tf32_rna
    w = wq.numpy().astype("f8").T
    if split:
        big, small = tf32_split(x)
        acc = big.astype("f8") @ w + small.astype("f8") @ w
    else:
        acc = tf32_rna(x).astype("f8") @ w
    return acc.astype("f4") * sc.numpy() + b


@pytest.mark.parametrize("m", [9, 33, 40])
def test_tile_kernel_split_within_the_kernel_gate(m):
    """The tile route's two-term split of x at the M it serves (a prefill
    chunk's tail, the dense prefill's tail, the speculative verify) is
    within chip_smoke.py's gate of the JAX package's ``dequant_matmul``
    plus the Dense's bias; x rounded to TF32 once misses it."""
    rng = onp.random.RandomState(9)
    n, k = 64, 768
    wq, sc = tqz.quantize_channelwise(_t(_weights(rng, n, k, zero_row=5)))
    x = (rng.randn(m, k) * 0.5).astype("f4")
    b = (rng.randn(n) * 0.1).astype("f4")
    ref = onp.asarray(jqz.dequant_matmul(
        jnp.asarray(x), jnp.asarray(wq.numpy()), jnp.asarray(sc.numpy()))
        + jnp.asarray(b))
    scale = float(onp.abs(ref).max())
    err = float(onp.abs(_tile_kernel_product(x, wq, sc, b, True)
                        - ref).max()) / scale
    single = float(onp.abs(_tile_kernel_product(x, wq, sc, b, False)
                           - ref).max()) / scale
    print(f"M={m}: two-term {err:.3g}, single TF32 {single:.3g} x max|ref|")
    assert err <= DEQUANT_REL_TOL
    assert single > 2 * DEQUANT_REL_TOL


@pytest.mark.parametrize("m,counter", [
    (1, "dequant_matmul"), (8, "dequant_matmul"),
    (9, "dequant_matmul_m32"), (32, "dequant_matmul_m32"),
    (33, "dequant_matmul_m64"), (40, "dequant_matmul_m64"),
    (512, "dequant_matmul_m64")])
def test_launch_counter_follows_the_route(m, counter):
    """K4's wrapper counts a launch under the kernel the C entry point
    runs for its M: the GEMV up to csrc's kGemvRows, the tile kernel
    above (chip_smoke.py's kernels line has a row for each counter)."""
    import re
    from mxnet_tpu_torch import _build
    src = (_build.CSRC / "dequant_matmul.cu").read_text()
    gemv = int(re.search(r"constexpr int kGemvRows = (\d+);", src).group(1))
    assert tqz._GEMV_ROWS == gemv
    assert tqz._counter(m) == counter
    assert set(tqz.launch_counts()) == {"dequant_matmul",
                                        "dequant_matmul_m32",
                                        "dequant_matmul_m64"}
