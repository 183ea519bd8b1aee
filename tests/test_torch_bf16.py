"""bf16 compute in the port (ROADMAP.md queue 1, item 10) against the
JAX package, on the CPU.

- The plain versions of K1, K2 and K3 on bf16 inputs: against the JAX
  package's jnp path (which rounds the scores and P to bf16, as the
  port's plain versions do) within 2^-6 of the output's magnitude, and
  their fp32 form on the widened inputs, rounded to bf16, against the
  Pallas kernels run with ``interpret=True`` on the bf16 inputs within
  2^-8 of it: the Pallas bodies widen to fp32 and round once at the
  end, so the two differ by fp32 rounding before one bf16 rounding (one
  bf16 step, 2^-8 of the magnitude, at most), while the jnp path rounds
  at two more places.
- The dtype of every intermediate of a generation step (q, the cache,
  attention's output, the block's output; the prefill's attention
  operands) equals the JAX model's, in fp32, bf16, bf16 with int8
  weights and bf16 with an int8 KV cache.
- The bf16 model's logits against the JAX bf16 model's, teacher-forced:
  within 2^-4 (the two frameworks round bf16 at other places — torch's
  CPU GEMM rounds a Dense once with its bias, jnp twice — one bf16 step,
  2^-7 at a logit of 1-2, at each of them, compounded over the layers:
  the widest gap measured here is 0.031); the reference's own bf16
  contract (0.25, >= 90 % agreement) between the port's bf16 and fp32
  models; ``cast_compute_params(None)`` gives the fp32 logits back
  bitwise; ``GPTModel(dtype="bfloat16")`` against the JAX bf16 model.
- K4's wrapper widens a bf16 x and bias exactly.
- The engine's ``compute_dtype``: its precision string, the bf16 cache
  default, the rollover's re-cast.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.ops import attention as jat
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import attention as tat
from mxnet_tpu_torch.ops import quantized as tqz
from mxnet_tpu_torch.serving import GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, SLOTS, SMAX = 97, 4, 64
#: the port's bf16 logits vs the JAX package's (see the docstring)
LOGIT_TOL_BF16 = 2.0 ** -4
#: the reference's bf16 contract (tests/test_multitick.py)
BF16_TOL, BF16_AGREE = 0.25, 0.9

def _params(seed=1234, dtype="float32"):
    onp.random.seed(seed)
    mx.np.random.seed(seed)
    net = jgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                         num_heads=4, max_length=128, dtype=dtype)
    net.initialize(mx.init.Xavier())
    net._gen_params()
    return net, {k: p.data().asnumpy() for k, p in
                 net.collect_params().items()}


def _port(params, dtype="float32"):
    tnet = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                          num_heads=4, max_length=128, device="cpu",
                          dtype=dtype)
    return tgpt.load_jax_params(tnet, params)


def _pair(dtype="float32"):
    jnet, params = _params(dtype=dtype)
    return jnet, _port(params, dtype)


@pytest.fixture(scope="module")
def jax_bf16():
    """``_pair()``'s JAX model cast once to bf16, which the bf16 and the
    bf16 + int8 KV logits cases both use (it compiles once), and its
    fp32 parameters, from which a test builds its own port model."""
    jnet, params = _params()
    jnet.cast_compute_params("bfloat16")
    return jnet, params


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return onp.asarray(jnp.asarray(x, jnp.float32))


def _bf(rng, *shape):
    """numpy-seeded values, rounded to bf16, as (torch, jax) arrays."""
    a = (rng.standard_normal(shape) * 0.5).astype("f4")
    t = torch.from_numpy(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# -- K1, K2, K3: the plain bf16 versions ---------------------------------

def _check(port, ref, rel):
    port, ref = _np(port), _np(ref)
    assert onp.isfinite(port).all()
    tol = rel * max(1.0, onp.abs(ref).max())
    assert onp.abs(port - ref).max() <= tol, (onp.abs(port - ref).max(), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_plain_against_jnp_and_pallas(causal):
    rng = onp.random.RandomState(0)
    (q, jq), (k, jk), (v, jv) = (_bf(rng, 1, 2, 256, 64) for _ in range(3))
    scale = 0.125
    out, lse = tat.flash_attention_fwd(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = jat._blockwise_fwd(jq, jk, jv, causal, scale)
    _check(out, ref, 2.0 ** -6)
    wide, wide_lse = tat._blockwise_fwd(q.float(), k.float(), v.float(),
                                        causal, scale)
    pal, pal_lse = jat.flash_attention_pallas(jq, jk, jv, causal=causal,
                                              interpret=True)
    assert pal.dtype == jnp.bfloat16
    _check(wide.bfloat16(), pal, 2.0 ** -8)
    onp.testing.assert_allclose(_np(wide_lse), _np(pal_lse), atol=1e-4)


def _lengths():
    return onp.array([0, 77, 200, 256], "i4")


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_decode_bf16_plain_against_jnp_and_pallas(q_dtype):
    """A bf16 cache with a bf16 q (the bf16 model) and with an fp32 q
    (int8 projections over a bf16 cache): the result is bf16 either
    way, as jnp gives it."""
    rng = onp.random.RandomState(1)
    (q, jq), (k, jk), (v, jv) = (_bf(rng, *s) for s in
                                 ((4, 2, 1, 64), (4, 2, 256, 64),
                                  (4, 2, 256, 64)))
    if q_dtype == "float32":
        q, jq = q.float(), jq.astype(jnp.float32)
    lens = _lengths()
    out = tat.decode_attention(q, k, v, torch.from_numpy(lens))
    ref = jat.decode_attention(jq, jk, jv, jnp.asarray(lens))
    assert str(out.dtype).endswith(str(ref.dtype)) and \
        out.dtype == torch.bfloat16
    _check(out, ref, 2.0 ** -6)
    assert not out[0].float().abs().max()
    wide = tat._decode_fwd_torch(q.float(), k.float(), v.float(),
                                 torch.from_numpy(lens), 0.125)
    pal = jat.decode_attention_pallas(jq.astype(jnp.bfloat16), jk, jv,
                                      jnp.asarray(lens), interpret=True)
    _check(wide.bfloat16(), pal, 2.0 ** -8)


def test_decode_int8_cache_with_bf16_q():
    """bf16 compute over an int8 cache: the dequantized K/V are fp32, so
    the scores and the result are fp32 (jnp's promotion)."""
    rng = onp.random.RandomState(2)
    (q, jq) = _bf(rng, 4, 2, 1, 64)
    kq = rng.randint(-127, 128, (4, 2, 256, 64)).astype("i1")
    vq = rng.randint(-127, 128, (4, 2, 256, 64)).astype("i1")
    ks = (rng.random_sample((4, 2)) * 0.02).astype("f4")
    vs = (rng.random_sample((4, 2)) * 0.02).astype("f4")
    lens = _lengths()
    out = tat.decode_attention(q, torch.from_numpy(kq), torch.from_numpy(vq),
                               torch.from_numpy(lens),
                               k_scale=torch.from_numpy(ks),
                               v_scale=torch.from_numpy(vs))
    ref = jat.decode_attention(jq, jnp.asarray(kq), jnp.asarray(vq),
                               jnp.asarray(lens), k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _check(out, ref, 2.0 ** -6)


def test_paged_decode_bf16_plain_against_jnp_and_pallas():
    rng = onp.random.RandomState(3)
    b, h, ps, d, p_max, n_pages = 4, 2, 16, 64, 16, 40
    lens = _lengths()
    table = onp.zeros((b, p_max), "i4")
    perm = rng.permutation(onp.arange(1, n_pages))
    at = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // ps)
        table[i, :need] = perm[at:at + need]
        at += need
    (q, jq), (kp, jkp), (vp, jvp) = (_bf(rng, *s) for s in
                                     ((b, h, 1, d), (n_pages, h, ps, d),
                                      (n_pages, h, ps, d)))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    out = tat.paged_decode_attention(q, kp, vp, tt, tl)
    ref = jat.paged_decode_attention(jq, jkp, jvp, jnp.asarray(table),
                                     jnp.asarray(lens))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _check(out, ref, 2.0 ** -6)
    wide = tat._decode_fwd_torch(q.float(),
                                 tat.gather_pages(kp, tt).float(),
                                 tat.gather_pages(vp, tt).float(), tl, 0.125)
    pal = jat.paged_decode_attention_pallas(jq, jkp, jvp, jnp.asarray(table),
                                            jnp.asarray(lens),
                                            interpret=True)
    _check(wide.bfloat16(), pal, 2.0 ** -8)


def test_dequant_matmul_widens_bf16_x_and_bias():
    """K4 computes in fp32 from a bf16 x and bias (the reference casts x
    to fp32 and adds the bf16 bias to the fp32 product): the same bits
    as the fp32 computation on the widened operands."""
    rng = onp.random.RandomState(4)
    w = torch.from_numpy((rng.standard_normal((96, 64)) * 0.1).astype("f4"))
    wq, sc = tqz.quantize_channelwise(w)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype("f4"))
    bias = torch.from_numpy(rng.standard_normal(96).astype("f4")).bfloat16()
    out = tqz.dequant_matmul(x.bfloat16(), wq, sc, bias=bias)
    ref = tqz.dequant_matmul(x.bfloat16().float(), wq, sc,
                             bias=bias.float())
    assert out.dtype == torch.float32
    assert torch.equal(out, ref)


# -- the model ------------------------------------------------------------

def _prompts(seed=7):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype("i4") for n in (5, 9, 13, 7)]


def _run(net, prompts, forced=None, steps=10, cache_dtype=None):
    """Prefill every prompt into its slot, then ``steps`` decode steps,
    greedy or teacher-forced on ``forced``; returns the stacked fp32
    decode logits and the prefill argmaxes."""
    cache = net.init_cache(len(prompts), SMAX, dtype=cache_dtype)
    firsts = []
    for b, p in enumerate(prompts):
        pad = onp.zeros((1, 16), "i4")
        pad[0, :p.size] = p
        lg, cache = net.prefill(pad, [p.size], cache, slots=[b])
        firsts.append(int(_np(lg)[0].argmax()))
    lasts = onp.asarray(firsts, "i4")
    logs = []
    for t in range(steps):
        lg, cache = net.decode_step(lasts if forced is None else forced[t],
                                    cache)
        arr = _np(lg)
        assert arr.dtype == onp.float32
        logs.append(arr.copy())
        lasts = arr.argmax(axis=1).astype("i4")
    return onp.stack(logs), onp.asarray(firsts, "i4")


def _forced(ref, f0):
    return [f0] + [ref[t].argmax(axis=1).astype("i4") for t in range(9)]


@pytest.mark.parametrize("quant,kv", [(False, None), (True, None),
                                      (False, "int8")],
                         ids=["bf16", "bf16+int8_weights", "bf16+int8_kv"])
def test_bf16_logits_track_the_jax_bf16_model(jax_bf16, quant, kv):
    """Teacher-forced on the fp32 model's greedy stream, the port's bf16
    logits against the JAX bf16 model's, within LOGIT_TOL_BF16 (int8
    weights arm the tables: that case casts a pair of its own)."""
    jnet, params = _params() if quant else jax_bf16
    tnet = _port(params)
    prompts = _prompts()
    ref, f0 = _run(tnet, prompts)
    forced = _forced(ref, f0)
    for net in (jnet, tnet) if quant else (tnet,):
        if quant:
            net.quantize_params()
        net.cast_compute_params("bfloat16")
    assert jnet.compute_dtype == tnet.compute_dtype == "bfloat16"
    got, _ = _run(tnet, prompts, forced, cache_dtype=kv)
    want, _ = _run(jnet, prompts, forced, cache_dtype=kv)
    assert onp.abs(got - want).max() <= LOGIT_TOL_BF16


def test_bf16_model_teacher_forced_bounded_divergence(jax_bf16):
    """The reference's bf16 contract in the port: bf16 tracks fp32
    within 0.25 under teacher forcing and agrees on >= 90 % of the
    greedy tokens; the masters stay fp32, and disarming gives the fp32
    logits back bitwise (the plain ``forward`` reads the masters even
    while armed)."""
    tnet = _port(jax_bf16[1])
    prompts = _prompts()
    ref, f0 = _run(tnet, prompts)
    fwd = tnet(prompts[0][None])
    tnet.cast_compute_params("bfloat16")
    assert tnet.compute_dtype == "bfloat16"
    assert torch.equal(tnet(prompts[0][None]), fwd)
    assert {str(p.data().dtype) for p in tnet.collect_params().values()} \
        == {"torch.float32"}
    got, _ = _run(tnet, prompts, _forced(ref, f0))
    assert onp.abs(ref - got).max() < BF16_TOL
    assert (ref.argmax(-1) == got.argmax(-1)).mean() >= BF16_AGREE
    tnet.cast_compute_params(None)
    assert tnet.compute_dtype == "float32"
    back, _ = _run(tnet, prompts)
    onp.testing.assert_array_equal(ref, back)


def test_bf16_parameters_model_against_jax():
    """``GPTModel(dtype="bfloat16")``: bf16 parameters (LayerNorms fp32,
    as in the reference), a bf16 cache by default, and logits within
    LOGIT_TOL_BF16 of the JAX bf16 model's on the same weights."""
    jnet, tnet = _pair(dtype="bfloat16")
    assert tnet.layers[0].q_proj.weight.data().dtype == torch.bfloat16
    assert tnet.layers[0].ln1.gamma.data().dtype == torch.float32
    assert tnet.init_cache(2, 16)["k"][0].dtype == torch.bfloat16
    prompts = _prompts(seed=8)
    got, f0 = _run(tnet, prompts)
    want, _ = _run(jnet, prompts, _forced(got, f0))
    assert onp.abs(got - want).max() <= LOGIT_TOL_BF16


# -- the dtype flow, tensor by tensor --------------------------------------

def _name(dt):
    return str(dt).replace("torch.", "")


def _record(monkeypatch, gpt_mod, att_mod, log):
    """Record the dtypes a generation step's tensors carry: the prefill
    attention's operands and output, the decode attention's q, cache and
    output, and each block's decode output."""
    flash, dec = att_mod.flash_attention, att_mod.decode_attention
    blk_decode = gpt_mod.GPTBlock.decode

    def flash_rec(q, k, v, *a, **kw):
        out = flash(q, k, v, *a, **kw)
        log.append(("prefill q/k/v/out", tuple(
            _name(t.dtype) for t in (q, k, v, out))))
        return out

    def dec_rec(q, k, v, *a, **kw):
        out = dec(q, k, v, *a, **kw)
        log.append(("decode q/cache/out", tuple(
            _name(t.dtype) for t in (q, k, out))))
        return out

    def blk_rec(self, *a, **kw):
        res = blk_decode(self, *a, **kw)
        x = res[0]
        log.append(("block out", _name(getattr(x, "_data", x).dtype)))
        return res
    monkeypatch.setattr(att_mod, "flash_attention", flash_rec)
    monkeypatch.setattr(att_mod, "decode_attention", dec_rec)
    monkeypatch.setattr(gpt_mod.GPTBlock, "decode", blk_rec)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "bf16+int8_weights",
                                  "bf16+int8_kv"])
def test_dtype_flow_matches_jax(monkeypatch, mode):
    """Every recorded intermediate has the JAX model's dtype: with int8
    weights q/k/v reach attention as fp32 over a bf16 cache and the
    residual stream turns fp32 after the first block; over an int8
    cache the attention output is fp32."""
    jnet, tnet = _pair()
    cache_dtype = {"bf16": "bfloat16", "bf16+int8_weights": "bfloat16",
                   "bf16+int8_kv": "int8"}.get(mode)
    logs = {}
    for tag, net, gpt_mod, att_mod in (("jax", jnet, jgpt, jat),
                                       ("port", tnet, tgpt, tat)):
        if "int8_weights" in mode:
            net.quantize_params()
        if mode != "fp32":
            net.cast_compute_params("bfloat16")
        log = logs[tag] = []
        with monkeypatch.context() as m:
            _record(m, gpt_mod, att_mod, log)
            cache = net.init_cache(2, 32, dtype=cache_dtype)
            pad = onp.zeros((1, 8), "i4")
            pad[0, :5] = [3, 1, 4, 1, 5]
            _, cache = net.prefill(pad, [5], cache, slots=[0])
            _, cache = net.decode_step(onp.array([7, 2], "i4"), cache)
        log.append(("cache", _name(cache["k"][0].dtype)))
    assert logs["port"] == logs["jax"]
    assert len(logs["port"]) == 2 + 2 * 2 + 1


# -- the engine -----------------------------------------------------------

def test_engine_bf16_precision_cache_and_rollover(jax_bf16):
    """``compute_dtype="bfloat16"`` arms the model's bf16 copies and
    defaults the cache to bf16 (int8 KV composes); ``precision`` names
    it; ``load_weights`` re-casts inside the swap, so the engine then
    serves what a fresh bf16 engine on the new weights serves."""
    tnet, donor = _port(jax_bf16[1]), _port(jax_bf16[1])
    donor.initialize(seed=5)
    eng = GenerationEngine(tnet, max_slots=2, max_length=SMAX,
                           max_new_tokens=6, compute_dtype="bfloat16",
                           device="cpu")
    assert eng.precision == "bf16" and tnet.compute_dtype == "bfloat16"
    assert eng._cache["k"][0].dtype == torch.bfloat16
    p = onp.array([5, 9, 2, 7], "i4")
    eng.load_weights({k: v.data() for k, v in
                      donor.collect_params().items()})
    got = eng.generate(p, timeout=60).tokens
    eng.close()
    fresh = GenerationEngine(donor, max_slots=2, max_length=SMAX,
                             max_new_tokens=6, compute_dtype="bfloat16",
                             device="cpu")
    assert fresh.generate(p, timeout=60).tokens == got
    fresh.close()
    kv8 = GenerationEngine(donor, max_slots=2, max_length=SMAX,
                           compute_dtype="bfloat16", kv_dtype="int8",
                           quantize="int8_weights", device="cpu")
    assert kv8.precision == "bf16+int8_weights+int8_kv"
    assert kv8._cache["k"][0].dtype == torch.int8
    kv8.close()
