"""float16 serving in the port (ROADMAP.md queue 1, item 10b) against the
JAX package, on the CPU.

- The plain float16 versions of K1, K2 (a float16 and an fp32 q) and K3:
  they widen q, K and V to fp32, compute in fp32 and round the output to
  float16, as the reference's dtype-generic Pallas kernels do. Against
  those kernels run with ``interpret=True`` on the same float16 inputs
  they agree within 2^-10 of the output's magnitude (one float16 step:
  the two differ by fp32 rounding before one float16 rounding); against
  the JAX package's jnp path, which rounds the scores and P to float16
  as well, within 2^-8.
- The dtype of every intermediate of a generation step equals the JAX
  model's: a float16 model, fp32 compute over a float16 cache, and
  ``cast_compute_params("float16")``.
- A float16 ``GPTModel``'s prefill and decode logits against the JAX
  float16 model's on the same weights, teacher-forced, within 2^-7: the
  two frameworks round float16 at other places (a Dense with its bias
  once or twice), one float16 step (2^-10 at a logit of 1-2) at each,
  compounded over the layers; the widest gap measured here is 0.0029.
- The engine at ``cache_dtype="float16"`` (dense and paged) and on a
  float16 model is token-identical to the JAX engine on the same
  weights; ``compute_dtype="float16"`` is the reference's ValueError.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.ops import attention as jat
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import attention as tat
from mxnet_tpu_torch.serving import GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, SLOTS, SMAX = 97, 4, 64
#: one float16 step of the output's magnitude (against Pallas), and the
#: jnp path's two extra roundings
F16_STEP, F16_JNP = 2.0 ** -10, 2.0 ** -8
#: the port's float16 logits vs the JAX package's (see the docstring)
LOGIT_TOL_F16 = 2.0 ** -7

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
def f16_pair():
    """The float16 pair the model test and the float16-model engine test
    share: neither arms nor casts it, and its JAX model compiles once."""
    return _pair(dtype="float16")


@pytest.fixture(scope="module")
def fp32_pair():
    """The fp32 pair the float16-cache engine tests and the refusal test
    share (they neither arm nor cast it)."""
    return _pair()


@pytest.fixture(scope="module")
def jax_f16_compute():
    """The JAX model the two float16-compute cases cast identically
    (``_pair()``'s, cast once to float16), and its parameters."""
    jnet, params = _params()
    jnet.cast_compute_params("float16")
    return jnet, params


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return onp.asarray(jnp.asarray(x, jnp.float32))


def _f16(rng, *shape):
    """numpy-seeded float16 values as (torch, jax) arrays."""
    a = (rng.standard_normal(shape) * 0.5).astype("f2")
    return torch.from_numpy(a), jnp.asarray(a)


def _check(port, ref, rel):
    port, ref = _np(port), _np(ref)
    assert onp.isfinite(port).all()
    tol = rel * max(1.0, onp.abs(ref).max())
    assert onp.abs(port - ref).max() <= tol, (onp.abs(port - ref).max(), tol)


# -- K1, K2, K3: the plain float16 versions --------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_f16_plain_against_pallas_and_jnp(causal):
    rng = onp.random.RandomState(0)
    (q, jq), (k, jk), (v, jv) = (_f16(rng, 1, 2, 256, 64) for _ in range(3))
    out, lse = tat.flash_attention_fwd(q, k, v, causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    pal, pal_lse = jat.flash_attention_pallas(jq, jk, jv, causal=causal,
                                              interpret=True)
    assert pal.dtype == jnp.float16
    _check(out, pal, F16_STEP)
    onp.testing.assert_allclose(_np(lse), _np(pal_lse), atol=1e-4)
    ref, _ = jat._blockwise_fwd(jq, jk, jv, causal, 0.125)
    _check(out, ref, F16_JNP)


def _lengths():
    return onp.array([0, 77, 200, 256], "i4")


@pytest.mark.parametrize("q_dtype", ["float16", "float32"])
def test_decode_f16_plain_against_pallas_and_jnp(q_dtype):
    """A float16 cache with a float16 q (the float16 model) and with an
    fp32 q (an fp32 model over a float16 cache): a float16 result either
    way, as jnp gives it."""
    rng = onp.random.RandomState(1)
    (q, jq), (k, jk), (v, jv) = (_f16(rng, *s) for s in
                                 ((4, 2, 1, 64), (4, 2, 256, 64),
                                  (4, 2, 256, 64)))
    if q_dtype == "float32":
        q, jq = q.float(), jq.astype(jnp.float32)
    lens = _lengths()
    out = tat.decode_attention(q, k, v, torch.from_numpy(lens))
    ref = jat.decode_attention(jq, jk, jv, jnp.asarray(lens))
    assert out.dtype == torch.float16 and ref.dtype == jnp.float16
    assert not out[0].float().abs().max()
    _check(out, ref, F16_JNP)
    pal = jat.decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                      interpret=True)
    _check(out, pal, F16_STEP)


def test_paged_decode_f16_plain_against_pallas_and_jnp():
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
    (q, jq), (kp, jkp), (vp, jvp) = (_f16(rng, *s) for s in
                                     ((b, h, 1, d), (n_pages, h, ps, d),
                                      (n_pages, h, ps, d)))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    out = tat.paged_decode_attention(q, kp, vp, tt, tl)
    ref = jat.paged_decode_attention(jq, jkp, jvp, jnp.asarray(table),
                                     jnp.asarray(lens))
    assert out.dtype == torch.float16 and ref.dtype == jnp.float16
    _check(out, ref, F16_JNP)
    pal = jat.paged_decode_attention_pallas(jq, jkp, jvp, jnp.asarray(table),
                                            jnp.asarray(lens),
                                            interpret=True)
    _check(out, pal, F16_STEP)


# -- the model -------------------------------------------------------------

def _prompts(seed=7):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype("i4") for n in (5, 9, 13, 7)]


def _run(net, prompts, forced=None, steps=10, cache_dtype=None):
    """Prefill every prompt into its slot, then ``steps`` decode steps,
    greedy or teacher-forced on ``forced``; returns the stacked fp32
    decode logits, the prefill logits and the prefill argmaxes."""
    cache = net.init_cache(len(prompts), SMAX, dtype=cache_dtype)
    firsts, pre = [], []
    for b, p in enumerate(prompts):
        pad = onp.zeros((1, 16), "i4")
        pad[0, :p.size] = p
        lg, cache = net.prefill(pad, [p.size], cache, slots=[b])
        pre.append(_np(lg)[0])
        firsts.append(int(pre[-1].argmax()))
    lasts = onp.asarray(firsts, "i4")
    logs = []
    for t in range(steps):
        lg, cache = net.decode_step(lasts if forced is None else forced[t],
                                    cache)
        arr = _np(lg)
        assert arr.dtype == onp.float32
        logs.append(arr.copy())
        lasts = arr.argmax(axis=1).astype("i4")
    return onp.stack(logs), onp.stack(pre), onp.asarray(firsts, "i4")


def _forced(ref, f0):
    return [f0] + [ref[t].argmax(axis=1).astype("i4") for t in range(9)]


def test_f16_model_logits_against_jax(f16_pair):
    """``GPTModel(dtype="float16")``: float16 parameters (LayerNorms
    fp32), a float16 cache by default, and prefill and teacher-forced
    decode logits within LOGIT_TOL_F16 of the JAX float16 model's."""
    jnet, tnet = f16_pair
    assert tnet.layers[0].q_proj.weight.data().dtype == torch.float16
    assert tnet.layers[0].ln1.gamma.data().dtype == torch.float32
    assert tnet.init_cache(2, 16)["k"][0].dtype == torch.float16
    prompts = _prompts(seed=8)
    got, gpre, f0 = _run(tnet, prompts)
    want, wpre, _ = _run(jnet, prompts, _forced(got, f0))
    assert onp.abs(gpre - wpre).max() <= LOGIT_TOL_F16
    assert onp.abs(got - want).max() <= LOGIT_TOL_F16


@pytest.mark.parametrize("cache", [None, "float16"],
                         ids=["f16-compute", "f16-compute+f16-cache"])
def test_f16_compute_logits_against_jax(jax_f16_compute, cache):
    """``cast_compute_params("float16")`` (which the reference's model
    takes and its engine refuses): teacher-forced logits within
    LOGIT_TOL_F16 of the JAX model's under the same cast; disarming
    gives the fp32 logits back bitwise."""
    jnet, params = jax_f16_compute
    tnet = _port(params)
    prompts = _prompts()
    ref, _, f0 = _run(tnet, prompts)
    forced = _forced(ref, f0)
    tnet.cast_compute_params("float16")
    assert tnet.compute_dtype == "float16"
    got, gpre, _ = _run(tnet, prompts, forced, cache_dtype=cache)
    want, wpre, _ = _run(jnet, prompts, forced, cache_dtype=cache)
    assert onp.abs(gpre - wpre).max() <= LOGIT_TOL_F16
    assert onp.abs(got - want).max() <= LOGIT_TOL_F16
    tnet.cast_compute_params(None)
    onp.testing.assert_array_equal(_run(tnet, prompts)[0], ref)


def _name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("mode", ["f16-model", "fp32+f16-cache",
                                  "f16-compute"])
def test_f16_dtype_flow_matches_jax(monkeypatch, mode):
    """The prefill attention's operands and output, the decode
    attention's q, cache and output, and each block's output carry the
    JAX model's dtypes."""
    jnet, tnet = _pair(dtype="float16" if mode == "f16-model"
                       else "float32")
    cache_dtype = "float16" if mode == "fp32+f16-cache" else None
    logs = {}
    for tag, net, gpt_mod, att_mod in (("jax", jnet, jgpt, jat),
                                       ("port", tnet, tgpt, tat)):
        if mode == "f16-compute":
            net.cast_compute_params("float16")
        log = logs[tag] = []
        flash, dec = att_mod.flash_attention, att_mod.decode_attention
        blk_decode = gpt_mod.GPTBlock.decode

        def flash_rec(q, k, v, *a, _f=flash, _log=log, **kw):
            out = _f(q, k, v, *a, **kw)
            _log.append(("prefill", tuple(_name(t.dtype)
                                          for t in (q, k, v, out))))
            return out

        def dec_rec(q, k, v, *a, _f=dec, _log=log, **kw):
            out = _f(q, k, v, *a, **kw)
            _log.append(("decode", tuple(_name(t.dtype)
                                         for t in (q, k, out))))
            return out

        def blk_rec(self, *a, _f=blk_decode, _log=log, **kw):
            res = _f(self, *a, **kw)
            _log.append(("block", _name(getattr(res[0], "_data",
                                                res[0]).dtype)))
            return res
        with monkeypatch.context() as m:
            m.setattr(att_mod, "flash_attention", flash_rec)
            m.setattr(att_mod, "decode_attention", dec_rec)
            m.setattr(gpt_mod.GPTBlock, "decode", blk_rec)
            cache = net.init_cache(2, 32, dtype=cache_dtype)
            pad = onp.zeros((1, 8), "i4")
            pad[0, :5] = [3, 1, 4, 1, 5]
            _, cache = net.prefill(pad, [5], cache, slots=[0])
            _, cache = net.decode_step(onp.array([7, 2], "i4"), cache)
        log.append(("cache", _name(cache["k"][0].dtype)))
    assert logs["port"] == logs["jax"]
    # a cast model's cache defaults to its parameters' type, fp32
    assert logs["port"][-1] == ("cache", "float32" if mode == "f16-compute"
                                else "float16")


# -- the engine ------------------------------------------------------------

ENGINES = [
    ("dense-f16-cache", "float32", dict(cache_dtype="float16")),
    ("paged-f16-cache", "float32", dict(cache_dtype="float16", paged=True,
                                        page_size=8)),
    ("f16-model", "float16", {}),
]


@pytest.mark.parametrize("dtype,kw", [e[1:] for e in ENGINES],
                         ids=[e[0] for e in ENGINES])
def test_f16_engine_token_identity_with_jax(f16_pair, fp32_pair, dtype, kw):
    jnet, tnet = f16_pair if dtype == "float16" else fp32_pair
    prompts = _prompts(seed=9)
    streams = []
    for Engine, net, extra in ((JaxEngine, jnet, {}),
                               (GenerationEngine, tnet, {"device": "cpu"})):
        eng = Engine(net, max_slots=SLOTS, max_length=SMAX,
                     max_new_tokens=8, **kw, **extra)
        assert str(eng._cache["k"][0].dtype).endswith("float16")
        sub = [eng.submit(p) for p in prompts]
        streams.append([s.result(timeout=120).tokens for s in sub])
        eng.close()
    assert streams[0] == streams[1]


def test_f16_compute_dtype_refused_as_in_reference(fp32_pair):
    jnet, tnet = fp32_pair
    for Engine, net, extra in ((JaxEngine, jnet, {}),
                               (GenerationEngine, tnet, {"device": "cpu"})):
        with pytest.raises(ValueError, match="compute_dtype"):
            Engine(net, max_slots=2, compute_dtype="float16", **extra)
