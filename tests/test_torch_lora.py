"""Batched multi-tenant LoRA in the port (ROADMAP.md queue 1, item 11):
``ops/lora.py``, ``GPTModel.arm_lora``/``set_adapter``/``clear_adapter``
and the engine's ``lora_rank=``, on the CPU, against the JAX package on
the same numpy weights and adapters, at the sizes of ``tests/test_lora.py``
(vocab 64, 16 units, 2 layers, 2 heads, rank 2).

Guarantees under test, mirroring ``tests/test_lora.py`` case by case:
- the batched bank apply equals a per-row loop and the JAX function
  (1e-5), and slot 0 adds an exact zero: a base row of an armed model is
  bitwise the unarmed model's;
- bank and ``arm_lora`` validation, the engine's constructor and
  ``submit`` errors, with the reference's messages;
- adapter load, refresh and unload allocate nothing: the banks and the
  cache keep their ``data_ptr()`` (the port's form of the reference's
  zero retraces);
- an armed model's adapted logits equal the JAX model's (1e-5), and the
  unmerged path tracks merged weights (the reference's 2e-3 / 2e-4);
- multi-tenant greedy streams equal the JAX engine's token for token —
  dense, paged, int8 (``quantize="int8_weights", kv_dtype="int8"``) and
  speculative (the base draft proposes, the target verifies adapted) —
  and, under ``compute_dtype="bfloat16"``, where an adapted projection
  promotes to fp32 as jnp does;
- pinned deferred unload, capacity and freed-slot reuse, a refresh
  racing a deferred unload, the gauge excluding unload-pending adapters,
  stale factors zeroed at the next load, the base index vector cached
  per batch, and prefix reuse for base requests only.
"""
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.gpt import gpt_small as jgpt_small
from mxnet_tpu.ops import lora as jlora
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import lora as tlora
from mxnet_tpu_torch.serving import GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, SLOTS, SMAX = 64, 4, 48
UNITS, LAYERS, HEADS, RANK = 16, 2, 2, 2
PROJS = ("q_proj", "k_proj", "v_proj", "out_proj")
LOGITS = dict(rtol=1e-5, atol=1e-5)


def _jax_net(seed=1234):
    mx.np.random.seed(seed)
    onp.random.seed(seed)
    net = jgpt_small(vocab_size=VOCAB, units=UNITS, num_layers=LAYERS,
                     num_heads=HEADS, max_length=SMAX)
    net.initialize(mx.init.Xavier())
    net(mx.np.array(onp.zeros((1, 4), "i4")))   # materialize params
    return net


@pytest.fixture(scope="module")
def params():
    """The reference net's parameters (every model's weights)."""
    return {k: onp.asarray(p.data()._data)
            for k, p in _jax_net().collect_params().items()}


def _port_net(params, layers=LAYERS, units=UNITS):
    net = tgpt.gpt_small(vocab_size=VOCAB, units=units, num_layers=layers,
                         num_heads=HEADS, max_length=SMAX, device="cpu")
    return tgpt.load_jax_params(net, params)


def _adapter(seed, scale=0.4, alpha=None):
    """Seeded LoRA factors covering the default include set; returns
    (flat params dict, alpha)."""
    r = onp.random.RandomState(seed)
    ad = {}
    for li in range(LAYERS):
        for p in PROJS:
            ad[f"layers.{li}.{p}.A"] = (r.randn(UNITS, RANK) * scale) \
                .astype("f4")
            ad[f"layers.{li}.{p}.B"] = (r.randn(RANK, UNITS) * scale) \
                .astype("f4")
    return ad, (float(alpha) if alpha is not None else float(RANK))


def _engine(params, lora=True, max_adapters=3, **kw):
    return GenerationEngine(
        _port_net(params), max_slots=SLOTS, max_length=SMAX,
        max_new_tokens=6, queue_limit=64, device="cpu",
        **({"lora_rank": RANK, "max_adapters": max_adapters}
           if lora else {}), **kw)


def _prompt(rng, n=5):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def _bank_ptrs(model):
    return [t.data_ptr() for st in model._lora_stack.values()
            for t in st.values()]


# -- op level ----------------------------------------------------------

def test_batched_apply_matches_per_row_loop():
    """One bank apply over a mixed-index batch equals each row through
    its own adapter, and the JAX function on the same bank."""
    import jax.numpy as jnp
    rng = onp.random.RandomState(0)
    n, d_in, d_out, r, b, s = 4, 6, 5, 2, 5, 3
    bank, jbank = tlora.init_bank(n, d_in, d_out, r), \
        jlora.init_bank(n, d_in, d_out, r)
    for i in range(1, n):
        a, bb = rng.randn(d_in, r).astype("f4"), rng.randn(r, d_out) \
            .astype("f4")
        tlora.set_slot(bank, i, a, bb, alpha=1.5 * i)
        jbank = jlora.set_slot(jbank, i, a, bb, alpha=1.5 * i)
    x = rng.randn(b, s, d_in).astype("f4")
    y = rng.randn(b, s, d_out).astype("f4")
    idx = onp.array([0, 2, 1, 3, 2], "i4")
    got = tlora.apply(torch.from_numpy(y), torch.from_numpy(x), bank,
                      idx).numpy()
    onp.testing.assert_allclose(got, onp.asarray(jlora.apply(
        jnp.asarray(y), jnp.asarray(x), jbank, idx)), **LOGITS)
    for row in range(b):
        a = bank["A"][idx[row]].numpy()
        bb = bank["B"][idx[row]].numpy()
        sc = float(bank["scale"][idx[row]])
        onp.testing.assert_allclose(got[row], y[row] + (x[row] @ a) @ bb * sc,
                                    **LOGITS)


def test_slot0_identity_and_bank_validation():
    """Slot 0 returns the base output bitwise; writing it, an
    out-of-range slot or wrong factor shapes is rejected; a bf16 base
    output plus the fp32 delta is fp32, as jnp promotes it."""
    rng = onp.random.RandomState(1)
    bank = tlora.init_bank(3, 4, 4, 2)
    y = torch.from_numpy(rng.randn(2, 3, 4).astype("f4"))
    x = torch.from_numpy(rng.randn(2, 3, 4).astype("f4"))
    assert torch.equal(tlora.apply(y, x, bank, onp.zeros((2,), "i4")), y)
    yb = y.to(torch.bfloat16)
    out = tlora.apply(yb, x.to(torch.bfloat16), bank, onp.zeros(2, "i4"))
    assert out.dtype == torch.float32 and torch.equal(out, yb.float())
    a, b = onp.zeros((4, 2), "f4"), onp.zeros((2, 4), "f4")
    with pytest.raises(ValueError, match="slot 0"):
        tlora.set_slot(bank, 0, a, b, 1.0)
    with pytest.raises(ValueError, match="slot 0"):
        tlora.clear_slot(bank, 0)
    with pytest.raises(ValueError, match="out of range"):
        tlora.set_slot(bank, 3, a, b, 1.0)
    with pytest.raises(ValueError, match="A shape"):
        tlora.set_slot(bank, 1, onp.zeros((5, 2), "f4"), b, 1.0)
    with pytest.raises(ValueError, match="B shape"):
        tlora.set_slot(bank, 1, a, onp.zeros((2, 5), "f4"), 1.0)
    with pytest.raises(ValueError, match="rank"):
        tlora.init_bank(3, 4, 4, 0)
    with pytest.raises(ValueError, match="n_adapters"):
        tlora.init_bank(1, 4, 4, 2)


def test_bank_writes_in_place():
    """``set_slot``/``clear_slot`` write into the bank and return it:
    the tensors, their ``data_ptr()`` and their values match the JAX
    bank's after the same writes; ``bank_bytes`` counts as the
    reference's does."""
    rng = onp.random.RandomState(2)
    bank, jbank = tlora.init_bank(3, 6, 5, 2), jlora.init_bank(3, 6, 5, 2)
    ptrs = {k: v.data_ptr() for k, v in bank.items()}
    a, b = rng.randn(6, 2).astype("f4"), rng.randn(2, 5).astype("f4")
    assert tlora.set_slot(bank, 2, a, b, 3.0) is bank
    jbank = jlora.set_slot(jbank, 2, a, b, 3.0)
    assert tlora.clear_slot(bank, 1) is bank
    jbank = jlora.clear_slot(jbank, 1)
    for k in bank:
        assert bank[k].data_ptr() == ptrs[k]
        onp.testing.assert_array_equal(bank[k].numpy(),
                                       onp.asarray(jbank[k]))
    assert tlora.bank_bytes([{"q": bank}]) == jlora.bank_bytes([{"q": jbank}])


# -- model level -------------------------------------------------------

def test_armed_model_slot0_bitwise_base(params):
    """An armed model with only the reserved zero adapter gives bitwise
    the unarmed model's logits, dense and paged."""
    plain, armed = _port_net(params), _port_net(params)
    armed.arm_lora(3, rank=RANK)
    armed.set_adapter(2, _adapter(3)[0])   # another slot's tenant
    toks = onp.random.RandomState(2).randint(0, VOCAB, (1, 8)).astype("i4")
    c0, c1 = plain.init_cache(2, SMAX), armed.init_cache(2, SMAX)
    lg0, c0 = plain.prefill(toks, [6], c0, slots=[0])
    lg1, c1 = armed.prefill(toks, [6], c1, slots=[0])
    assert torch.equal(lg0, lg1)
    d0, c0 = plain.decode_step(onp.zeros((2,), "i4"), c0)
    d1, c1 = armed.decode_step(onp.zeros((2,), "i4"), c1, adapters=[0, 0])
    assert torch.equal(d0, d1)
    p0 = plain.init_paged_cache(2, 13, 8, SMAX)
    p1 = armed.init_paged_cache(2, 13, 8, SMAX)
    row = onp.arange(1, 7, dtype="i4")
    lg0, p0 = plain.prefill_paged(toks, 6, 0, row, p0, fresh=True)
    lg1, p1 = armed.prefill_paged(toks, 6, 0, row, p1, fresh=True)
    assert torch.equal(lg0, lg1)


def test_arm_lora_validation(params):
    net = _port_net(params)
    with pytest.raises(ValueError, match="rank"):
        net.arm_lora(3, rank=0)
    with pytest.raises(ValueError, match="n_adapters"):
        net.arm_lora(1, rank=RANK)
    with pytest.raises(ValueError, match="activation"):
        net.arm_lora(3, rank=RANK, include=("ffn1",))
    with pytest.raises(ValueError, match="unknown LoRA projection") as ei:
        net.arm_lora(3, rank=RANK, include=("nope",))
    assert "ffn2" in str(ei.value) and "q_proj" in str(ei.value)
    assert "'ffn1'" not in str(ei.value)
    with pytest.raises(RuntimeError, match="arm_lora"):
        net.set_adapter(1, {})
    with pytest.raises(RuntimeError, match="arm_lora"):
        net.clear_adapter(1)
    net.arm_lora(3, rank=RANK)
    ptrs = _bank_ptrs(net)
    assert net.arm_lora(3, rank=RANK) is net and _bank_ptrs(net) == ptrs
    good, _ = _adapter(0)
    for bad, what in (
            ({k: v for k, v in good.items() if k != "layers.0.q_proj.A"},
             "missing"),
            (dict(good, extra_key=onp.zeros((1,), "f4")), "unexpected"),
            (dict(good, **{"layers.1.v_proj.A":
                           onp.zeros((UNITS, RANK + 1), "f4")}), "A shape"),
            (dict(good, **{"layers.0.q_proj.A":
                           onp.full((UNITS, RANK), onp.nan, "f4")}),
             "non-finite")):
        with pytest.raises(ValueError, match=what):
            net.set_adapter(1, bad)
    # validated before any write: the bank is still all zeros
    assert all(float(t.abs().sum()) == 0 for st in net._lora_stack.values()
               for t in st.values())
    assert net.lora_bank_bytes() == LAYERS * len(PROJS) * 4 * (
        3 * UNITS * RANK * 2 + 3)
    # ffn2 takes an adapter (no fused activation)
    net2 = _port_net(params)
    net2.arm_lora(3, rank=RANK, include=("ffn2",))
    assert net2._lora[0]["ffn2"]["A"].shape == (3, 4 * UNITS, RANK)


def test_adapted_logits_match_jax(params):
    """Prefill and decode logits of an armed model under an adapter
    equal the JAX model's on the same weights and factors."""
    ad, alpha = _adapter(5, scale=0.3)
    jnet = _jax_net()
    jnet.arm_lora(3, rank=RANK)
    jnet.set_adapter(1, ad, alpha=alpha)
    tnet = _port_net(params)
    tnet.arm_lora(3, rank=RANK)
    tnet.set_adapter(1, ad, alpha=alpha)
    toks = onp.random.RandomState(4).randint(0, VOCAB, 10).astype("i4")
    padded = onp.zeros((2, 8), "i4")
    padded[0, :6], padded[1, :3] = toks[:6], toks[6:9]
    jc, tc = jnet.init_cache(2, SMAX), tnet.init_cache(2, SMAX)
    jl, jc = jnet.prefill(padded, [6, 3], jc, slots=[0, 1],
                          adapters=[1, 0])
    tl, tc = tnet.prefill(padded, [6, 3], tc, slots=[0, 1],
                          adapters=[1, 0])
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **LOGITS)
    for t in range(3):
        step = onp.array([toks[t], toks[t + 3]], "i4")
        jl, jc = jnet.decode_step(step, jc, adapters=[1, 0])
        tl, tc = tnet.decode_step(step, tc, adapters=[1, 0])
        onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **LOGITS)


def test_merged_weights_teacher_forced_divergence(params):
    """The unmerged batched path (base product + low-rank delta) tracks
    a model whose Dense weights were MERGED (``W += (alpha / r) * (A @
    B)^T``) within the reference's teacher-forced bound."""
    armed = _port_net(params)
    armed.arm_lora(3, rank=RANK)
    ad, alpha = _adapter(3, scale=0.3)
    armed.set_adapter(1, ad, alpha=alpha)
    mparams = dict(params)
    for li in range(LAYERS):
        for p in PROJS:
            key = f"layers.{li}.{p}.weight"
            mparams[key] = params[key] + (
                ad[f"layers.{li}.{p}.A"] @ ad[f"layers.{li}.{p}.B"]).T \
                * (alpha / RANK)
    merged = _port_net(mparams)
    toks = onp.random.RandomState(4).randint(0, VOCAB, 10).astype("i4")
    full = merged(toks[None, :]).numpy()[0]
    cache = armed.init_cache(2, SMAX)
    lg, cache = armed.prefill(toks[None, :6], [6], cache, slots=[0],
                              adapters=[1])
    onp.testing.assert_allclose(lg.numpy()[0], full[5], rtol=2e-3,
                                atol=2e-4)
    for t in range(6, 10):
        step = onp.zeros((2,), "i4")
        step[0] = toks[t]
        lg, cache = armed.decode_step(step, cache, adapters=[1, 0])
        onp.testing.assert_allclose(lg.numpy()[0], full[t], rtol=2e-3,
                                    atol=2e-4)


def test_base_idx_vector_cached_per_batch(params):
    """The adapters=None index vector is a constant: one cached tensor
    per batch size, not a new one every step."""
    net = _port_net(params)
    assert net._lora_idx(None, 4) is net._lora_idx(None, 4)
    assert net._lora_idx(None, 2) is not net._lora_idx(None, 4)
    assert tuple(net._lora_idx(None, 3).shape) == (3,)
    with pytest.raises(ValueError, match="one index per row"):
        net._lora_idx([0, 1], 3)


# -- engine level ------------------------------------------------------

def test_engine_constructor_validation(params):
    def build(**kw):
        return GenerationEngine(_port_net(params), max_slots=2,
                                max_length=SMAX, device="cpu", **kw)
    with pytest.raises(ValueError, match="lora_rank must be"):
        build(lora_rank=0)
    with pytest.raises(ValueError, match="max_adapters must be"):
        build(lora_rank=RANK, max_adapters=0)
    with pytest.raises(ValueError, match="max_adapters without"):
        build(max_adapters=4)
    plain = _port_net(params)   # a decoder without the batched-LoRA API
    plain.arm_lora = None
    with pytest.raises(TypeError, match="arm_lora"):
        GenerationEngine(plain, max_slots=2, max_length=SMAX,
                         lora_rank=RANK, device="cpu")
    eng = _engine(params)
    assert eng.lora == "rank=2:max=3" and eng.model.lora_armed
    assert eng._lora_free == [1, 2, 3]
    eng.close()


def test_submit_kwarg_errors_name_argument_and_capabilities(params):
    eng = _engine(params, lora=False)
    rng = onp.random.RandomState(5)
    with pytest.raises(TypeError) as ei:
        eng.submit(_prompt(rng), adapter="t")
    msg = str(ei.value)
    assert "adapter=" in msg and "capabilities" in msg
    assert "precision=fp32" in msg and "lora=off" in msg
    with pytest.raises(TypeError, match="load_adapter") as ei:
        eng.load_adapter("t", {})
    assert "capabilities" in str(ei.value)
    assert "submit()" not in str(ei.value)
    with pytest.raises(TypeError, match="unload_adapter") as ei:
        eng.unload_adapter("t")
    assert "capabilities" in str(ei.value)
    eng.close()
    eng2 = _engine(params)
    with pytest.raises(ValueError) as ei:
        eng2.submit(_prompt(rng), adapter="ghost")
    assert "ghost" in str(ei.value) and "capabilities" in str(ei.value)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng2.unload_adapter("ghost")
    eng2.close()


def test_load_unload_refresh_allocates_nothing(params):
    """Once warmed, adapter load, refresh, use and unload keep the banks
    and the cache where they are (``data_ptr()``): the port's form of
    the reference's zero retraces. A refresh lands."""
    eng = _engine(params).warmup()
    banks = _bank_ptrs(eng.model)
    cache = [t.data_ptr() for t in eng._cache_tensors()]
    a1, alpha1 = _adapter(10)
    eng.load_adapter("t1", a1, alpha=alpha1)
    p = _prompt(onp.random.RandomState(6))
    first = eng.generate(p, adapter="t1", timeout=120).tokens
    telemetry.reset()
    a2, alpha2 = _adapter(11)
    eng.load_adapter("t2", a2, alpha=alpha2)       # load
    eng.load_adapter("t1", a2, alpha=alpha2)       # refresh in place
    refreshed = eng.generate(p, adapter="t1", timeout=120).tokens
    same = eng.generate(p, adapter="t2", timeout=120).tokens
    assert eng.unload_adapter("t2") is True        # unload
    post = eng.generate(p, adapter="t1", timeout=120).tokens
    assert _bank_ptrs(eng.model) == banks
    assert [t.data_ptr() for t in eng._cache_tensors()] == cache
    assert refreshed == same == post   # t1 now holds t2's factors
    assert refreshed != first          # and the refresh really landed
    snap = telemetry.snapshot()
    assert snap["counters"]["serving.generate.lora.adapters_loaded"] == 2
    assert snap["counters"]["serving.generate.lora.adapters_evicted"] == 1
    assert snap["counters"]["serving.generate.lora.requests"] == 3
    assert snap["gauges"]["serving.generate.lora.active_adapters"][
        "value"] == 1
    assert "serving.generate.lora.load" in snap["histograms"]
    eng.close()


def _workload():
    rng = onp.random.RandomState(7)
    return [_prompt(rng, 3 + i % 5) for i in range(6)]


def _serve(eng, adapters, prompts, max_new=6):
    """Load ``adapters`` and serve every prompt under every tenant (None:
    the base model), interleaved; tokens keyed by (tenant, request)."""
    for name, (ad, alpha) in adapters.items():
        eng.load_adapter(name, ad, alpha=alpha)
    names = [None, *adapters]
    streams = [(t, i, eng.submit(p, max_new_tokens=max_new,
                                 **({} if t is None else {"adapter": t})))
               for i, p in enumerate(prompts) for t in names]
    out = {(t, i): s.result(timeout=240).tokens for t, i, s in streams}
    eng.close()
    return out


_JAX_STREAMS = {}


def _jax_streams(adapters, key, **kw):
    """The JAX multi-tenant engine's streams on the same weights (cached
    per configuration: every JAX engine compiles its programs anew)."""
    if key not in _JAX_STREAMS:
        eng = JaxEngine(_jax_net(), max_slots=SLOTS, max_length=SMAX,
                        max_new_tokens=6, queue_limit=64, lora_rank=RANK,
                        max_adapters=len(adapters), **kw)
        _JAX_STREAMS[key] = _serve(eng, adapters, _workload())
    return _JAX_STREAMS[key]


ADAPTERS = {"t1": _adapter(20), "t2": _adapter(21)}


@pytest.mark.parametrize("composition", ["dense", "paged", "int8"])
def test_multi_tenant_token_identity(params, composition):
    """Per-tenant greedy streams of the port's multi-tenant engine equal
    the JAX engine's token for token, with base co-tenants in the same
    batches: dense, paged (the index is per slot, orthogonal to pages)
    and int8 (the fp32 delta over the dequantized base, an int8 KV
    cache). The JAX engine holds its own streams equal to dedicated
    single-adapter engines' (``tests/test_lora.py``)."""
    kw, key = {}, "fp32"
    if composition == "paged":
        kw = {"paged": True, "page_size": 8}
    elif composition == "int8":
        kw, key = {"quantize": "int8_weights", "kv_dtype": "int8"}, "int8"
    want = _jax_streams(ADAPTERS, key, **(kw if key == "int8" else {}))
    got = _serve(_engine(params, max_adapters=2, **kw).warmup(), ADAPTERS,
                 _workload())
    assert got == want
    assert got[("t1", 0)] != got[(None, 0)]   # the adapters act


def test_multi_tenant_token_identity_speculative(params):
    """The speculative engine proposes with the BASE draft and verifies
    adapted: every tenant's stream equals the JAX non-speculative
    multi-tenant engine's."""
    mx.np.random.seed(77)
    jd = jgpt_small(vocab_size=VOCAB, units=UNITS, num_layers=1,
                    num_heads=HEADS, max_length=SMAX)
    jd.initialize(mx.init.Xavier())
    jd(mx.np.array(onp.zeros((1, 4), "i4")))
    draft = tgpt.load_jax_params(
        tgpt.gpt_small(vocab_size=VOCAB, units=UNITS, num_layers=1,
                       num_heads=HEADS, max_length=SMAX, device="cpu"),
        {k: onp.asarray(p.data()._data)
         for k, p in jd.collect_params().items()})
    telemetry.reset()
    got = _serve(_engine(params, max_adapters=2, draft_model=draft,
                         spec_k=3), ADAPTERS, _workload())
    assert got == _jax_streams(ADAPTERS, "fp32")
    assert telemetry.counter_value("serving.generate.spec.proposed") > 0


def test_lora_bf16_matches_jax(params):
    """LoRA under ``compute_dtype="bfloat16"``: the adapted projections
    promote to fp32 (a bf16 base output plus the fp32 delta), and
    everything downstream of them with them, as in the reference, whose
    engine serves the same tokens."""
    tnet = _port_net(params).cast_compute_params("bfloat16")
    tnet.arm_lora(2, rank=RANK)
    tnet.set_adapter(1, *_adapter(20))
    blk = tnet.layers[0]
    h = torch.zeros((1, 1, UNITS), dtype=torch.bfloat16)
    with tnet._bound([1], 1):
        assert blk._proj("q_proj", h).dtype == torch.float32
        assert blk._proj("ffn1", h).dtype == torch.bfloat16
    tnet.cast_compute_params(None)
    want = _jax_streams({"t1": ADAPTERS["t1"]}, "bf16",
                        compute_dtype="bfloat16")
    got = _serve(_engine(params, max_adapters=1, compute_dtype="bfloat16"),
                 {"t1": ADAPTERS["t1"]}, _workload())
    assert got == want


def test_prefix_reuse_is_base_only(params):
    """Paged: an adapted request never matches nor publishes cached
    prefix pages (its K/V differ); base requests share them."""
    eng = _engine(params, paged=True, page_size=8)
    eng.load_adapter("t1", *_adapter(22))
    p = onp.random.RandomState(8).randint(0, VOCAB, 17).astype("i4")
    telemetry.reset()
    a1 = eng.generate(p, adapter="t1", max_new_tokens=3, timeout=120).tokens
    a2 = eng.generate(p, adapter="t1", max_new_tokens=3, timeout=120).tokens
    assert telemetry.counter_value("serving.generate.prefix_hits") == 0
    b1 = eng.generate(p, max_new_tokens=3, timeout=120).tokens
    b2 = eng.generate(p, max_new_tokens=3, timeout=120).tokens
    assert telemetry.counter_value("serving.generate.prefix_hits") == 1
    assert a1 == a2 and b1 == b2 and a1 != b1
    eng.close()


def test_pinned_adapter_deferred_unload(params):
    """An in-flight request pins its adapter: unload defers (False), the
    name refuses new submits at once, the stream finishes on the
    adapter's factors, and the slot frees afterwards."""
    eng = _engine(params).warmup()
    ad, alpha = _adapter(30)
    eng.load_adapter("pinned", ad, alpha=alpha)
    telemetry.reset()
    p = _prompt(onp.random.RandomState(8))
    ref = eng.generate(p, adapter="pinned", max_new_tokens=4,
                       timeout=120).tokens
    s = eng.submit(p, adapter="pinned", max_new_tokens=30)
    assert eng.unload_adapter("pinned") is False   # deferred
    assert "pinned" not in eng.adapters and not eng.has_adapter("pinned")
    with pytest.raises(ValueError, match="pinned"):
        eng.submit(p, adapter="pinned")
    assert s.result(timeout=120).tokens[:4] == ref
    deadline = time.monotonic() + 10
    while "pinned" in eng._lora_reg and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "pinned" not in eng._lora_reg, "deferred unload never ran"
    assert telemetry.counter_value(
        "serving.generate.lora.adapters_evicted") == 1
    eng.load_adapter("next", ad, alpha=alpha)    # the freed slot
    assert eng.adapters == ["next"] and eng.has_adapter("next")
    eng.close()


def test_adapter_capacity_and_freed_slot_reuse(params):
    eng = _engine(params, max_adapters=2)
    a, alpha = _adapter(40)
    eng.load_adapter("a", a, alpha=alpha)
    eng.load_adapter("b", a, alpha=alpha)
    with pytest.raises(ValueError, match="capacity exhausted"):
        eng.load_adapter("c", a, alpha=alpha)
    assert eng.unload_adapter("a") is True
    eng.load_adapter("c", a, alpha=alpha)   # the freed slot reused
    assert eng.adapters == ["b", "c"]
    eng.close()


def test_refresh_racing_deferred_unload_reregisters(params):
    """A refresh whose adapter an unload completes between
    ``load_adapter``'s two lock sections re-registers the name on the
    slot it just wrote."""
    eng = _engine(params)
    ad, alpha = _adapter(50)
    eng.load_adapter("t", ad, alpha=alpha)
    eng._pin_adapter("t")
    orig = eng.model.set_adapter

    def racing(idx, p, alpha=1.0):
        orig(idx, p, alpha=alpha)
        assert eng.unload_adapter("t") is False
        eng._unpin_adapter("t")
        assert "t" not in eng._lora_reg

    eng.model.set_adapter = racing
    try:
        eng.load_adapter("t", ad, alpha=alpha)   # the refresh
    finally:
        eng.model.set_adapter = orig
    assert eng.adapters == ["t"], "the refresh silently vanished"
    assert eng._lora_reg["t"].idx not in eng._lora_free
    eng.close()


def test_active_adapters_gauge_excludes_unload_pending(params):
    eng = _engine(params).warmup()
    ad, alpha = _adapter(51)
    eng.load_adapter("g1", ad, alpha=alpha)
    eng.load_adapter("g2", ad, alpha=alpha)

    def gauge():
        return telemetry.snapshot()["gauges"][
            "serving.generate.lora.active_adapters"]["value"]
    assert gauge() == 2
    eng._pin_adapter("g2")
    assert eng.unload_adapter("g2") is False
    assert gauge() == 1
    eng._unpin_adapter("g2")
    assert gauge() == 1 and eng.adapters == ["g1"]
    eng.close()


def test_unloaded_slot_factors_zeroed_at_next_swap(params):
    """An evicted tenant's factors do not linger: freed slots are zeroed
    inside the next ``load_adapter``'s exclusive window."""
    eng = _engine(params)
    eng.load_adapter("a", *_adapter(60))
    eng.load_adapter("b", *_adapter(61))
    idx_a, idx_b = eng._lora_reg["a"].idx, eng._lora_reg["b"].idx
    bank = eng.model._lora[0]["q_proj"]
    assert float(bank["A"][idx_b].abs().sum()) > 0
    assert eng.unload_adapter("a") is True
    assert eng.unload_adapter("b") is True
    assert eng._lora_stale == {idx_a, idx_b}
    eng.load_adapter("c", *_adapter(62))
    idx_c = eng._lora_reg["c"].idx
    for freed in {idx_a, idx_b} - {idx_c}:
        for tab in eng.model._lora:
            for bk in tab.values():
                assert float(bk["A"][freed].abs().sum()) == 0
                assert float(bk["scale"][freed]) == 0
    assert not eng._lora_stale
    eng.close()
