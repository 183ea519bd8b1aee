"""Multi-tick decode in the port (ROADMAP.md queue 1, item 10):
``GPTModel.decode_multi``/``decode_multi_paged`` and the engine's
``decode_ticks``, on the CPU, against the JAX package.

Mirrors ``tests/test_multitick.py`` case by case, with the same names:
greedy parity of ``decode_ticks=k`` with k = 1 (dense, paged, int8),
seeded sampled streams identical across k in {1, 4, 8}, eos and budgets
landing mid-tick, the host-sync arithmetic (``host_syncs`` ==
ceil((new - 1) / k) for a lone request, one dispatch a tick,
``ticks_per_sync`` == k), a steady state that reallocates nothing (the
port's form of "compiles nothing": PyTorch runs eagerly), one
``decode`` span a tick, the knob validation, and the bf16 engine with
multi-tick decode and an int8 KV cache. ``decode_multi`` and
``decode_multi_paged`` are also held to the JAX package's on the same
weights and caches: the same tokens and emission masks, greedy, with
eos and budgets landing mid-tick.

``test_multitick_greedy_parity_lora`` (batched LoRA) also holds the
streams to the JAX engine's. Two cases of the JAX file are about
``TrainStep``: ``test_trainstep_bf16_fp32_masters_and_bounded_loss``
is ported, under its name, in ``tests/test_torch_train_step.py``;
``test_overlap_gather_barrier_chain`` (``TrainStep``'s ``tp_fsdp``
layout) waits for ROADMAP.md queue 1, item 20.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serving import GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, SLOTS, SMAX = 97, 4, 64
UNITS, LAYERS, HEADS = 32, 2, 4


def _jax_pair(seed=1234):
    onp.random.seed(seed)
    mx.np.random.seed(seed)
    jnet = jgpt.gpt_small(vocab_size=VOCAB, units=UNITS, num_layers=LAYERS,
                          num_heads=HEADS, max_length=128)
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    return jnet, tgpt.load_jax_params(_bare(), params)


def _bare():
    return tgpt.gpt_small(vocab_size=VOCAB, units=UNITS, num_layers=LAYERS,
                          num_heads=HEADS, max_length=128, device="cpu")


def _net(seed=1234):
    return _bare().initialize(seed=seed)


def _engine(net, **kw):
    return GenerationEngine(net, max_slots=SLOTS, max_length=SMAX,
                            max_new_tokens=16, device="cpu", **kw)


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def _corpus(seed=3, n=8):
    rng = onp.random.RandomState(seed)
    prompts = [_prompt(rng, 3 + (5 * i) % 17) for i in range(n)]
    budgets = [3 + (7 * i) % 11 for i in range(n)]
    return prompts, budgets


def _drain(eng, prompts, budgets, **submit_kw):
    streams = [eng.submit(p, max_new_tokens=b, **submit_kw)
               for p, b in zip(prompts, budgets)]
    return [s.result(timeout=120) for s in streams]


def _serve(prompts, budgets, net=None, **kw):
    eng = _engine(net if net is not None else _net(), **kw).warmup()
    out = _drain(eng, prompts, budgets)
    eng.close()
    return [(r.tokens, r.finish_reason) for r in out]


# -- decode_multi against the JAX package ------------------------------------

def _prefill(net, prompts, paged):
    """The prompts prefilled into slot b of a fresh cache of ``net``
    (dense, or paged: pages 1 + 8b .. of a 33-page pool); returns the
    cache and each slot's first greedy token."""
    if paged:
        cache = net.init_paged_cache(SLOTS, 8 * SLOTS + 1, 8, SMAX)
    else:
        cache = net.init_cache(SLOTS, SMAX)
    firsts = []
    for b, p in enumerate(prompts):
        pad = onp.zeros((1, 16), "i4")
        pad[0, :p.size] = p
        if paged:
            row = onp.arange(1 + 8 * b, 9 + 8 * b, dtype="i4")
            lg, cache = net.prefill_paged(pad, p.size, b, row, cache,
                                          fresh=True)
        else:
            lg, cache = net.prefill(pad, [p.size], cache, slots=[b])
        firsts.append(int(onp.asarray(lg)[0].argmax()))
    return cache, onp.asarray(firsts, "i4")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_multi_matches_jax(paged):
    """Greedy k-step calls with budgets that run out mid-call (3 of 6),
    one at 0 on entry (a free slot) and an eos that fires mid-call: the
    tokens (the stopped rows' re-fed ones included), the emission masks
    and the lengths equal the JAX package's."""
    jnet, tnet = _jax_pair()
    rng = onp.random.RandomState(9)
    prompts = [_prompt(rng, n) for n in (5, 11, 7, 14)]
    k = 6
    budgets = onp.array([6, 3, 0, 5], "i4")
    greedy = dict(temps=onp.zeros(SLOTS, "f4"), top_ks=onp.zeros(SLOTS, "i4"),
                  top_ps=onp.ones(SLOTS, "f4"))
    fn = "decode_multi_paged" if paged else "decode_multi"
    # a first call without eos picks as a row's eos the first token that
    # row emits for the first time after its first, with budget left
    pc, pf = _prefill(tnet, prompts, paged)
    ptok, _, _, _ = getattr(tnet, fn)(pf, budgets, pc, k, [None] * SLOTS,
                                      eos_ids=onp.full(SLOTS, -1, "i4"),
                                      **greedy)
    ptok = ptok.tolist()
    row, j = next((r, j) for r in (0, 3) for j in range(1, budgets[r] - 1)
                  if ptok[r][j] not in ptok[r][:j])
    eos = onp.full(SLOTS, -1, "i4")
    eos[row] = ptok[row][j]
    tc, tf = _prefill(tnet, prompts, paged)
    jc, jf = _prefill(jnet, prompts, paged)
    assert (jf == tf).all()
    ttok, temit, _, tcache = getattr(tnet, fn)(tf, budgets, tc, k,
                                               [None] * SLOTS, eos_ids=eos,
                                               **greedy)
    jtok, jemit, _, jcache = getattr(jnet, fn)(
        jf, budgets, jc, k, onp.zeros((SLOTS, 2), "u4"), eos_ids=eos,
        **greedy)
    assert ttok.dtype == torch.int32 and temit.dtype == torch.bool
    onp.testing.assert_array_equal(ttok.numpy(), onp.asarray(jtok))
    onp.testing.assert_array_equal(temit.numpy(), onp.asarray(jemit))
    emitted = [6, 3, 0, 5]
    emitted[row] = j + 1
    assert temit.sum(1).tolist() == emitted
    onp.testing.assert_array_equal(tcache["len"].numpy(),
                                   onp.asarray(jcache["len"]))


# -- greedy parity across compositions ---------------------------------------

@pytest.mark.parametrize("k", [4, 8])
def test_multitick_greedy_parity_dense(k):
    """Dense engine: decode_ticks=k token-identical to k=1, mixed
    prompt lengths and budgets (budgets deliberately NOT multiples
    of k)."""
    prompts, budgets = _corpus()
    net = _net()
    assert _serve(prompts, budgets, net, decode_ticks=k) == \
        _serve(prompts, budgets, net)


def test_multitick_greedy_parity_paged():
    """Paged pool: the scrap-page redirection for finished slots must
    not perturb any live row."""
    prompts, budgets = _corpus(seed=5)
    net = _net()
    kw = dict(paged=True, page_size=8)
    assert _serve(prompts, budgets, net, decode_ticks=4, **kw) == \
        _serve(prompts, budgets, net, **kw)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_multitick_greedy_parity_int8(bf16):
    """int8 weights + int8 KV (and the same under bf16 compute): the
    k-step call reads the same int8 tables as the single step."""
    prompts, budgets = _corpus(seed=9, n=6)
    kw = dict(quantize="int8_weights", kv_dtype="int8")
    if bf16:
        kw["compute_dtype"] = "bfloat16"
    assert _serve(prompts, budgets, _net(), decode_ticks=4, **kw) == \
        _serve(prompts, budgets, _net(), **kw)


def test_multitick_greedy_parity_lora():
    """Batched LoRA: the per-slot adapter indices ride the k-step call
    unchanged, and base and adapted co-tenants stay row-independent:
    decode_ticks=4 equals k = 1, and both equal the JAX engine's
    streams on the same weights and adapter."""
    from mxnet_tpu.serving import GenerationEngine as JaxEngine
    rank = 2
    rng = onp.random.RandomState(11)
    adapter = {}
    for li in range(LAYERS):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            adapter[f"layers.{li}.{proj}.A"] = \
                (rng.randn(UNITS, rank) * 0.4).astype("f4")
            adapter[f"layers.{li}.{proj}.B"] = \
                (rng.randn(rank, UNITS) * 0.4).astype("f4")
    prompts, budgets = _corpus(seed=13, n=6)
    ads = [None, "t", None, "t", "t", None]
    jnet, tnet = _jax_pair()
    params = {k: p.data().numpy() for k, p in tnet.collect_params().items()}

    def run(k, jax=False):
        if jax:
            eng = JaxEngine(jnet, max_slots=SLOTS, max_length=SMAX,
                            max_new_tokens=16, lora_rank=rank,
                            max_adapters=3)
        else:
            eng = _engine(tgpt.load_jax_params(_bare(), params),
                          lora_rank=rank, max_adapters=3, decode_ticks=k)
        eng.load_adapter("t", adapter)
        eng.warmup()
        streams = [eng.submit(p, max_new_tokens=b, adapter=a)
                   for p, b, a in zip(prompts, budgets, ads)]
        out = [s.result(timeout=120).tokens for s in streams]
        eng.close()
        return out

    assert run(4) == run(1) == run(1, jax=True)


def test_multitick_sampled_bitwise_reproducible_across_k():
    """Seeded stochastic requests replayed through k in {1,4,8}
    engines produce identical streams: a sampled row's generator
    advances once per step whatever the tick size. Mixed
    greedy/stochastic batches share the one call."""
    prompts, budgets = _corpus(seed=17, n=6)
    kw = [dict(temperature=0.8, top_k=9, seed=100 + i) if i % 2
          else {} for i in range(len(prompts))]

    def run(k):
        eng = _engine(_net(), decode_ticks=k).warmup()
        streams = [eng.submit(p, max_new_tokens=b, **s)
                   for p, b, s in zip(prompts, budgets, kw)]
        out = [s.result(timeout=120).tokens for s in streams]
        eng.close()
        return out

    r1, r4, r8 = run(1), run(4), run(8)
    assert r4 == r1
    assert r8 == r1


# -- on-device eos / budget semantics ----------------------------------------

def test_multitick_eos_and_budget_truncate_mid_scan():
    """eos or budget landing in the middle of a tick truncates the
    committed block exactly where the k=1 engine stops, with the same
    finish_reason."""
    prompts, budgets = _corpus(seed=21, n=8)
    net = _net()
    ref0 = _serve(prompts, budgets, net)
    flat = [t for toks, _ in ref0 for t in toks]
    eos = max(set(flat), key=flat.count)
    ref = _serve(prompts, budgets, net, eos_id=int(eos))
    got = _serve(prompts, budgets, net, eos_id=int(eos), decode_ticks=4)
    assert any(reason == "eos" for _, reason in ref), \
        "probe failed to arrange a mid-stream eos"
    assert got == ref


# -- host-sync amortization, gated from counters ------------------------------

@pytest.mark.parametrize("k", [1, 4, 8])
def test_multitick_host_sync_arithmetic(k):
    """A lone request emitting N tokens costs exactly ceil((N-1)/k)
    decode host syncs (token 1 rides the prefill sync) and ONE dispatch
    per tick."""
    eng = GenerationEngine(_net(), max_slots=SLOTS, max_length=SMAX,
                           max_new_tokens=32, decode_ticks=k,
                           device="cpu").warmup()
    rng = onp.random.RandomState(2)
    n_new = 21
    eng.submit(_prompt(rng, 6), max_new_tokens=n_new).result(120)
    telemetry.reset()
    res = eng.submit(_prompt(rng, 6), max_new_tokens=n_new).result(120)
    snap = telemetry.snapshot()
    eng.close()
    assert len(res.tokens) == n_new
    want = math.ceil((n_new - 1) / k)
    assert snap["counters"]["serving.generate.host_syncs"] == want
    assert snap["counters"]["serving.generate.dispatches"] == want
    assert snap["gauges"]["serving.generate.ticks_per_sync"]["value"] == k


def test_multitick_zero_steady_state_compiles_mixed_traffic():
    """Mixed prompt lengths, budgets, and greedy/sampled mixes through
    one decode_ticks=4 engine reallocate nothing after warmup: the cache
    tensors keep their storage (the port runs eagerly, so this is its
    form of the reference's zero steady-state compiles)."""
    eng = _engine(_net(), decode_ticks=4, paged=True, page_size=8).warmup()
    prompts, budgets = _corpus(seed=23, n=8)
    _drain(eng, prompts[:4], budgets[:4])
    ptrs = [t.data_ptr() for t in eng._cache_tensors()]
    streams = [eng.submit(p, max_new_tokens=b,
                          **(dict(temperature=0.7, seed=i) if i % 3
                             else {}))
               for i, (p, b) in enumerate(zip(prompts, budgets))]
    for s in streams:
        assert len(s.result(timeout=120).tokens) >= 1
    assert [t.data_ptr() for t in eng._cache_tensors()] == ptrs
    eng.close()


# -- tracing: one span per tick -------------------------------------------

def test_multitick_records_one_decode_span_per_tick():
    """A tick records ONE ``decode`` span with a ``tokens`` attribute
    covering the whole block — k spans would lie about dispatch count,
    zero spans would hide the tick."""
    eng = _engine(_net(), decode_ticks=4).warmup()
    rng = onp.random.RandomState(4)
    stream = eng.submit(_prompt(rng, 5), max_new_tokens=9, trace=True)
    res = stream.result(timeout=120)
    spans = stream.trace()
    eng.close()
    dec = [s for s in spans if s["name"] == "decode"]
    assert dec, "no decode span recorded"
    assert all("tokens" in s.get("attrs", {}) for s in dec)
    # 9 tokens: 1 from prefill + ticks covering the rest
    assert sum(s["attrs"]["tokens"] for s in dec) == len(res.tokens) - 1
    assert len(dec) == math.ceil((len(res.tokens) - 1) / 4)


# -- knob validation ------------------------------------------------------

def test_decode_ticks_validation():
    net = _net()
    with pytest.raises(ValueError, match="decode_ticks"):
        GenerationEngine(net, max_slots=2, max_length=SMAX, decode_ticks=0,
                         device="cpu")
    with pytest.raises(ValueError, match="amortization"):
        GenerationEngine(net, max_slots=2, max_length=SMAX,
                         draft_model=_net(seed=7), decode_ticks=4,
                         device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        GenerationEngine(net, max_slots=2, max_length=SMAX,
                         compute_dtype="float16", device="cpu")


# -- bf16 compute with multi-tick decode ----------------------------------

def test_bf16_engine_composes_with_multitick_and_int8_kv():
    """The bf16 engine serves greedy traffic end to end with
    decode_ticks=4 (the same tokens as at k=1) and defaults its KV cache
    to bf16; the capability string advertises the precision; it tracks
    the fp32 greedy stream (bounded divergence, small model: near-total
    agreement, not bitwise); over an int8 KV cache k=4 equals k=1 too."""
    prompts, budgets = _corpus(seed=29, n=4)
    eng = _engine(_net(), compute_dtype="bfloat16", decode_ticks=4).warmup()
    assert "bf16" in eng.precision
    assert eng._cache["k"][0].dtype == torch.bfloat16
    out = _drain(eng, prompts, budgets)
    eng.close()
    assert all(len(r.tokens) == b for r, b in zip(out, budgets))
    assert [(r.tokens, r.finish_reason) for r in out] == \
        _serve(prompts, budgets, compute_dtype="bfloat16")
    ref = _serve(prompts, budgets)
    n = sum(len(toks) for toks, _ in ref)
    same = sum(t == u for (toks, _), g in zip(ref, out)
               for t, u in zip(toks, g.tokens))
    assert same / n >= 0.8
    kw = dict(compute_dtype="bfloat16", kv_dtype="int8", paged=True,
              page_size=8)
    assert _serve(prompts, budgets, decode_ticks=4, **kw) == \
        _serve(prompts, budgets, **kw)
