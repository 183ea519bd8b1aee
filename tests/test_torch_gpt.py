"""The port's GPT model (mxnet_tpu_torch.gluon.model_zoo.gpt) against
the JAX package's on the same weights.

A JAX ``gpt_small`` is initialized from a seed, its ``collect_params()``
exported to numpy, and loaded into the port with ``load_jax_params``;
both models then see the same token inputs. Forward logits and the
prefill + decode logits must agree within rtol=2e-3, atol=2e-4 (the
bounds of tests/test_generate.py: fp32, different reduction order).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt

VOCAB, SLOTS, SMAX = 97, 4, 64
TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, exported params) on the same weights."""
    onp.random.seed(1234)
    mx.np.random.seed(1234)
    jnet = jgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                          num_heads=4, max_length=128)
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()   # materialize deferred shapes
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                          num_heads=4, max_length=128, device="cpu")
    tgpt.load_jax_params(tnet, params)
    return jnet, tnet, params


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def test_param_names_and_order_match_reference(pair):
    jnet, tnet, params = pair
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    for name, p in tnet.collect_params().items():
        assert p.shape == params[name].shape, name


def test_load_jax_params_is_strict(pair):
    _, _, params = pair
    fresh = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                           num_heads=4, max_length=128, device="cpu")
    missing = dict(params)
    missing.pop("layers.1.ffn2.bias")
    with pytest.raises(KeyError, match="missing"):
        tgpt.load_jax_params(fresh, missing)
    with pytest.raises(KeyError, match="extra"):
        tgpt.load_jax_params(fresh, {**params, "layers.2.ln1.gamma":
                                     onp.ones(32, "f4")})
    bad = dict(params)
    bad["lm_head.weight"] = onp.zeros((VOCAB, 31), "f4")
    with pytest.raises(ValueError, match="shapes differ"):
        tgpt.load_jax_params(fresh, bad)
    # nothing was written by the failed loads
    with pytest.raises(RuntimeError, match="not been initialized"):
        fresh.lm_head.weight.data()
    tgpt.load_jax_params(fresh, params)
    onp.testing.assert_array_equal(fresh.lm_head.weight.data().numpy(),
                                   params["lm_head.weight"])


def test_forward_logits_match_jax(pair):
    jnet, tnet, _ = pair
    toks = onp.random.RandomState(0).randint(0, VOCAB, (2, 19)).astype("i4")
    ref = jnet(mx.np.array(toks)).asnumpy()
    out = tnet(toks).numpy()
    assert out.shape == ref.shape == (2, 19, VOCAB)
    onp.testing.assert_allclose(out, ref, **TOL)


def test_prefill_and_decode_match_jax(pair):
    """Mixed lengths scattered into slots (tests/test_generate.py's
    cases): prefill logits, the cache lengths and every decode step's
    logits agree with the JAX model's on the same sequence of calls."""
    jnet, tnet, _ = pair
    rng = onp.random.RandomState(1)
    t1, t2 = _prompt(rng, 6), _prompt(rng, 3)
    padded = onp.zeros((2, 8), "i4")
    padded[0, :6], padded[1, :3] = t1, t2
    jc = jnet.init_cache(SLOTS, SMAX)
    tc = tnet.init_cache(SLOTS, SMAX)
    jl, jc = jnet.prefill(padded, [6, 3], jc, slots=[2, 0])
    tl, tc = tnet.prefill(padded, [6, 3], tc, slots=[2, 0])
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **TOL)
    assert tc["len"].tolist() == onp.asarray(jc["len"]).tolist() \
        == [3, 0, 6, 0]
    # a third prompt into another slot mid-stream, then decode all rows
    t3 = _prompt(rng, 11)
    p3 = onp.zeros((1, 16), "i4")
    p3[0, :11] = t3
    jl, jc = jnet.prefill(p3, [11], jc, slots=[1])
    tl, tc = tnet.prefill(p3, [11], tc, slots=[1])
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **TOL)
    for step in range(6):
        toks = rng.randint(0, VOCAB, SLOTS).astype("i4")
        jl, jc = jnet.decode_step(toks, jc)
        tl, tc = tnet.decode_step(toks, tc)
        live = [0, 1, 2]   # slot 3 never prefilled: garbage either way
        onp.testing.assert_allclose(tl.numpy()[live],
                                    onp.asarray(jl)[live], **TOL,
                                    err_msg=f"step {step}")
    assert tc["len"].tolist() == onp.asarray(jc["len"]).tolist()


def test_prefill_and_decode_match_full_forward(pair):
    """Teacher forcing inside the port: prefill + decode_step reproduce
    the port's own full causal forward at every position."""
    _, tnet, _ = pair
    toks = _prompt(onp.random.RandomState(0), 9)
    full = tnet(toks[None, :]).numpy()[0]
    cache = tnet.init_cache(SLOTS, SMAX)
    logits, cache = tnet.prefill(toks[None, :4], [4], cache, slots=[1])
    onp.testing.assert_allclose(logits.numpy()[0], full[3], **TOL)
    for t in range(4, 9):
        step = onp.zeros((SLOTS,), "i4")
        step[1] = toks[t]
        lg, cache = tnet.decode_step(step, cache)
        onp.testing.assert_allclose(lg.numpy()[1], full[t], **TOL)


def test_cache_is_updated_in_place(pair):
    """No steady-state reallocation: prefill and decode write into the
    tensors init_cache allocated and return those same tensors."""
    _, tnet, _ = pair
    cache = tnet.init_cache(SLOTS, SMAX)
    ptrs = [t.data_ptr() for t in (*cache["k"], *cache["v"], cache["len"])]
    _, c2 = tnet.prefill(onp.zeros((1, 8), "i4"), [5], cache, slots=[2])
    for _ in range(3):
        _, c2 = tnet.decode_step(onp.zeros((SLOTS,), "i4"), c2)
    assert c2 is cache
    assert [t.data_ptr() for t in (*c2["k"], *c2["v"], c2["len"])] == ptrs
    assert cache["len"].tolist() == [3, 3, 8, 3]
    k0 = cache["k"][0]
    assert k0[2, :, :8].abs().max() > 0 and k0[2, :, 8:].abs().max() == 0


def test_decode_write_clamps_at_capacity(pair):
    """A full row writes at S_max - 1 and attends [0, S_max) — the
    reference's clamped write position, never an out-of-range index."""
    _, tnet, _ = pair
    cache = tnet.init_cache(2, 8)
    _, cache = tnet.prefill(onp.ones((1, 8), "i4"), [8], cache, slots=[0])
    lg, cache = tnet.decode_step(onp.zeros((2,), "i4"), cache)
    assert torch.isfinite(lg).all()
    assert cache["len"].tolist() == [9, 1]


def test_cache_validation_and_unported_modes(pair):
    _, tnet, _ = pair
    with pytest.raises(ValueError, match="out of range"):
        tnet.init_cache(2, tnet.max_length + 1)
    cache = tnet.init_cache(2, 16)
    with pytest.raises(ValueError, match="exceeds cache"):
        tnet.prefill(onp.zeros((1, 32), "i4"), [32], cache, slots=[0])
    for dtype, item in (("int8", "8"), ("bfloat16", "10")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tnet.init_cache(2, 16, dtype=dtype)
    with pytest.raises(NotImplementedError, match="item 10"):
        tgpt.GPTModel(VOCAB, units=32, num_layers=1, num_heads=4,
                      dtype="bfloat16", device="cpu")


def test_initialize_is_seeded(pair):
    a = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=1,
                       num_heads=4, device="cpu").initialize(seed=7)
    b = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=1,
                       num_heads=4, device="cpu").initialize(seed=7)
    for (na, pa), (nb, pb) in zip(a.collect_params().items(),
                                  b.collect_params().items()):
        assert na == nb
        assert torch.equal(pa.data(), pb.data())
    assert a.layers[0].ln1.gamma.data().eq(1).all()
    assert a.layers[0].q_proj.bias.data().eq(0).all()
