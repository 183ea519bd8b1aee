"""The port's paged KV cache (GPTModel's paged calls) and the paged
GenerationEngine, against the JAX package's on the same weights.

Guarantees under test (the ones of tests/test_paged.py, where ported):
- the paged calls are faithful to the dense ones — fresh prefill and
  decode are BITWISE equal to the port's dense prefill and decode —
  and chunked prefill, peek and decode logits agree with the JAX
  model's paged calls (rtol=2e-3, atol=2e-4: fp32, another reduction
  order);
- inactive rows write only the scrap page, and the pool, table and
  lengths are updated in place (same ``data_ptr()``);
- greedy output of the paged engine is TOKEN-IDENTICAL to the JAX
  paged engine and to the port's dense engine under mixed lengths,
  shared prefixes, exact duplicates and churn; with
  ``quantize="int8_weights"`` the port's dense and paged engines are
  token-identical to the JAX int8 engine;
- prefix hits skip prefill, COW keeps shared pages intact under any
  finish order, at most one prefill chunk runs per iteration, an
  exhausted pool defers admission, and every terminal path leaves the
  pool fully free.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serving import EngineClosedError, GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: gpt_small's defaults (vocab 1000, 64 units, 2 layers, 4 heads, 128
#: positions) in both packages
VOCAB, UNITS, HEADS = 1000, 64, 4
SLOTS, SMAX, PS, CHUNK = 4, 64, 8, 16
N_PAGES = SLOTS * SMAX // PS + 1
P_MAX = SMAX // PS
TOL = dict(rtol=2e-3, atol=2e-4)


def _models():
    """(JAX model, port model) on the same seeded weights."""
    onp.random.seed(1234)
    mx.np.random.seed(1234)
    jnet = jgpt.gpt_small()
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tgpt.gpt_small(device="cpu")
    tgpt.load_jax_params(tnet, params)
    return jnet, tnet


@pytest.fixture(scope="module")
def pair():
    return _models()


@pytest.fixture(scope="module")
def net(pair):
    return pair[1]


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def _paged_engine(net, **kw):
    args = dict(max_slots=SLOTS, max_length=SMAX, max_new_tokens=8,
                queue_limit=64, paged=True, page_size=PS,
                prefill_chunk=CHUNK, n_pages=N_PAGES)
    args.update(kw)
    return GenerationEngine(net, device="cpu", **args)


def _dense_engine(net, **kw):
    args = dict(max_slots=SLOTS, max_length=SMAX, max_new_tokens=8,
                queue_limit=64)
    args.update(kw)
    return GenerationEngine(net, device="cpu", **args)


def _row(*pages):
    row = onp.zeros(P_MAX, "i4")
    row[:len(pages)] = pages
    return row


# -- model-level --------------------------------------------------------
def test_paged_fresh_prefill_bitwise_matches_dense(net):
    """The fresh (single-chunk, unshared) paged prefill runs the dense
    prefill's computation: logits bitwise equal, and decode stays
    bitwise equal step for step."""
    rng = onp.random.RandomState(2)
    padded = onp.zeros((1, 16), "i4")
    padded[0, :11] = _prompt(rng, 11)
    dense = net.init_cache(SLOTS, SMAX)
    lg_d, dense = net.prefill(padded, [11], dense, slots=[2])
    paged = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    lg_p, paged = net.prefill_paged(padded, 11, 2, _row(5, 6, 7, 8), paged,
                                    fresh=True)
    assert torch.equal(lg_d, lg_p)
    onp.testing.assert_array_equal(
        paged["k"][1][[5, 6]].transpose(0, 1)
        .reshape(HEADS, 16, UNITS // HEADS).numpy(),
        dense["k"][1][2, :, :16].numpy())
    tok = int(lg_d[0].argmax())
    active = onp.zeros(SLOTS, "i4")
    active[2] = 1
    for _ in range(4):
        step = onp.zeros((SLOTS,), "i4")
        step[2] = tok
        lgd, dense = net.decode_step(step, dense)
        lgp, paged = net.decode_step_paged(step, active, paged)
        assert torch.equal(lgd[2], lgp[2])
        tok = int(lgd[2].argmax())
    assert paged["len"].tolist() == [0, 0, 15, 0]


def test_paged_calls_match_jax(pair):
    """Chunked prefill (a shared-prefix page layout), peek, bind, COW
    copy and decode logits agree with the JAX model's paged calls on
    the same sequence of calls; table and lengths agree exactly."""
    jnet, tnet = pair
    rng = onp.random.RandomState(3)
    prompt = _prompt(rng, 21)
    jc = jnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    tc = tnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    row = _row(10, 11, 12, 13)
    pos = 0
    while pos < 21:
        nv = min(CHUNK, 21 - pos)
        chunk = onp.zeros((1, CHUNK), "i4")
        chunk[0, :nv] = prompt[pos:pos + nv]
        jl, jc = jnet.prefill_paged(chunk, nv, 1, row, jc, start=pos)
        tl, tc = tnet.prefill_paged(chunk, nv, 1, row, tc, start=pos)
        onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **TOL)
        pos += nv
    full = tnet(prompt[None])[0]
    onp.testing.assert_allclose(tl[0].numpy(), full[-1].numpy(), **TOL)
    onp.testing.assert_array_equal(tc["table"].numpy(),
                                   onp.asarray(jc["table"]))
    assert tc["len"].tolist() == onp.asarray(jc["len"]).tolist() \
        == [0, 21, 0, 0]
    jp = jnet.peek_logits_paged(int(prompt[-1]), 1, jc)
    tp = tnet.peek_logits_paged(int(prompt[-1]), 1, tc)
    onp.testing.assert_allclose(tp.numpy(), onp.asarray(jp), **TOL)
    # a second slot shares the first two pages and diverges after them
    tail = _prompt(rng, 5)
    chunk = onp.zeros((1, CHUNK), "i4")
    chunk[0, :5] = tail
    row3 = _row(10, 11, 20)
    jl, jc = jnet.prefill_paged(chunk, 5, 3, row3, jc, start=16)
    tl, tc = tnet.prefill_paged(chunk, 5, 3, row3, tc, start=16)
    onp.testing.assert_allclose(tl.numpy(), onp.asarray(jl), **TOL)
    # COW of slot 1's tail page, then decode both slots
    jc = jnet.copy_page_paged(12, 21, jc)
    tc = tnet.copy_page_paged(12, 21, tc)
    row_cow = _row(10, 11, 21, 13)
    jc = jnet.bind_slot_paged(1, row_cow, 21, jc)
    tc = tnet.bind_slot_paged(1, row_cow, 21, tc)
    tp2 = tnet.peek_logits_paged(int(prompt[-1]), 1, tc)
    assert torch.equal(tp2, tp)
    active = onp.asarray([0, 1, 0, 1], "i4")
    for _ in range(3):
        toks = rng.randint(0, VOCAB, SLOTS).astype("i4")
        jl, jc = jnet.decode_step_paged(toks, active, jc)
        tl, tc = tnet.decode_step_paged(toks, active, tc)
        onp.testing.assert_allclose(tl.numpy()[[1, 3]],
                                    onp.asarray(jl)[[1, 3]], **TOL)
    assert tc["len"].tolist() == onp.asarray(jc["len"]).tolist() \
        == [0, 24, 0, 24]
    for li in range(2):
        onp.testing.assert_allclose(tc["k"][li].numpy(),
                                    onp.asarray(jc["k"][li]), **TOL)


def test_inactive_rows_write_only_the_scrap_page(net):
    """A free slot whose table row still aliases another slot's pages
    (its len stale) runs in the fixed-shape step: its write is
    redirected into page 0 and its len stands still, so the owner's
    pages keep their K/V."""
    cache = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    padded = onp.zeros((1, 16), "i4")
    padded[0, :10] = _prompt(onp.random.RandomState(4), 10)
    _, cache = net.prefill_paged(padded, 10, 0, _row(3, 4), cache,
                                 fresh=True)
    cache = net.bind_slot_paged(2, _row(3, 4), 5, cache)   # stale alias
    before = [p[[3, 4]].clone() for p in (*cache["k"], *cache["v"])]
    active = onp.asarray([1, 0, 0, 0], "i4")
    # slot 0 writes token 5 at position 10, where the prompt's bucket
    # padding (token 0) sat
    _, cache = net.decode_step_paged(onp.asarray([5, 6, 7, 8], "i4"),
                                     active, cache)
    assert cache["len"].tolist() == [11, 0, 5, 0]
    after = [p[[3, 4]] for p in (*cache["k"], *cache["v"])]
    for b, a in zip(before, after):
        # only slot 0's own row 10 (page 4, offset 2) changed
        changed = (b != a).any(dim=(1, 3))
        assert changed.nonzero().tolist() == [[1, 2]]
    assert cache["k"][0][0].abs().max() > 0     # the scrap page took writes


def test_paged_cache_updated_in_place(net):
    cache = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    ptrs = [t.data_ptr() for t in (*cache["k"], *cache["v"], cache["table"],
                                   cache["len"])]
    padded = onp.zeros((1, 16), "i4")
    _, c2 = net.prefill_paged(padded, 9, 1, _row(1, 2), cache, fresh=True)
    _, c2 = net.prefill_paged(padded, 16, 2, _row(5, 6, 7), c2, start=0)
    _, c2 = net.decode_step_paged(onp.zeros(SLOTS, "i4"),
                                  onp.ones(SLOTS, "i4"), c2)
    c2 = net.copy_page_paged(1, 9, net.bind_slot_paged(3, _row(9), 1, c2))
    net.peek_logits_paged(0, 1, c2)
    assert c2 is cache
    assert [t.data_ptr() for t in (*c2["k"], *c2["v"], c2["table"],
                                   c2["len"])] == ptrs


def test_paged_cache_validation(net):
    with pytest.raises(ValueError, match="divide"):
        net.init_paged_cache(SLOTS, N_PAGES, 7, SMAX)
    with pytest.raises(ValueError, match="scrap"):
        net.init_paged_cache(SLOTS, 1, PS, SMAX)
    int8 = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="int8")
    assert int8["k"][0].dtype == torch.int8
    assert [tuple(t.shape) for t in int8["k_scale"]] == \
        [(N_PAGES, HEADS)] * 2
    bf16 = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="bfloat16")
    assert bf16["k"][0].dtype == bf16["v"][1].dtype == torch.bfloat16
    f16 = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype="float16")
    assert f16["k"][1].dtype == f16["v"][0].dtype == torch.float16
    cache = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    row = onp.zeros(P_MAX, "i4")
    with pytest.raises(ValueError, match="multiple of page_size"):
        net.prefill_paged(onp.zeros((1, 12), "i4"), 12, 0, row, cache)
    with pytest.raises(ValueError, match="multiple of page_size"):
        net.prefill_paged(onp.zeros((1, 16), "i4"), 16, 0, row, cache,
                          start=4)
    with pytest.raises(ValueError, match="fresh"):
        net.prefill_paged(onp.zeros((1, 16), "i4"), 16, 0, row, cache,
                          start=16, fresh=True)
    with pytest.raises(ValueError, match=r"\(1, W\)"):
        net.prefill_paged(onp.zeros((2, 16), "i4"), 16, 0, row, cache)


# -- engine: token identity --------------------------------------------
def _corpus(seed=4):
    rng = onp.random.RandomState(seed)
    sys_prompt = _prompt(rng, 24)
    prompts = [_prompt(rng, n) for n in (3, 9, 17, 5, 30, 12, 7, 21, 40, 2)]
    prompts += [onp.concatenate([sys_prompt, _prompt(rng, n)])
                for n in (4, 7, 3, 11)]
    prompts.append(prompts[-1].copy())     # exact duplicate
    prompts.append(prompts[4].copy())
    budgets = [3 + i % 7 for i in range(len(prompts))]
    return prompts, budgets


def _serve(eng, prompts, budgets):
    out = [s.result(timeout=300) for s in
           [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]]
    eng.close()
    return out


def test_paged_engine_token_identical_to_jax_and_dense(pair):
    """Mixed single-chunk, multi-chunk, shared-prefix and duplicate
    prompts, several waves deep: the port's paged engine gives every
    request the JAX paged engine's tokens and the port's dense
    engine's, and sharing really happened."""
    jnet, tnet = pair
    prompts, budgets = _corpus()
    ref = _serve(JaxEngine(jnet, max_slots=SLOTS, max_length=SMAX,
                           max_new_tokens=8, queue_limit=64, paged=True,
                           page_size=PS, prefill_chunk=CHUNK,
                           n_pages=N_PAGES), prompts, budgets)
    dense = _serve(_dense_engine(tnet), prompts, budgets)
    telemetry.reset()
    eng = _paged_engine(tnet)
    got = _serve(eng, prompts, budgets)
    snap = telemetry.snapshot()
    for i, (g, j, d) in enumerate(zip(got, ref, dense)):
        assert g.tokens == j.tokens == d.tokens, f"request {i} diverged"
        assert g.finish_reason == j.finish_reason == d.finish_reason
    assert snap["counters"]["serving.generate.pages.shared"] > 0
    assert snap["counters"]["serving.generate.prefill_chunks"] > 0
    assert eng._pool.free_count == eng._pool.n_pages - 1


@pytest.fixture(scope="module")
def qpair():
    """A second (JAX, port) pair for the int8 engines: building an int8
    engine arms the model's int8 tables."""
    return _models()


def test_int8_engines_token_identical_to_jax_int8(qpair):
    jnet, tnet = qpair
    prompts, budgets = _corpus(seed=5)
    prompts, budgets = prompts[::2], budgets[::2]
    ref = _serve(JaxEngine(jnet, max_slots=SLOTS, max_length=SMAX,
                           max_new_tokens=8, queue_limit=64,
                           quantize="int8_weights"), prompts, budgets)
    dense_eng = _dense_engine(tnet, quantize="int8_weights")
    assert dense_eng.precision == "int8_weights" and tnet.quantized
    dense = _serve(dense_eng, prompts, budgets)
    paged = _serve(_paged_engine(tnet, quantize="int8_weights"), prompts,
                   budgets)
    for i, (p, d, j) in enumerate(zip(paged, dense, ref)):
        assert p.tokens == d.tokens == j.tokens, f"request {i} diverged"


# -- engine: behaviour --------------------------------------------------
def test_engine_paged_without_prefix_cache(net):
    """``prefix_cache=False``: nothing is published or shared, every
    prompt prefills, and the tokens are the same."""
    rng = onp.random.RandomState(16)
    p = _prompt(rng, 13)
    dense = _dense_engine(net)
    ref = dense.generate(p, max_new_tokens=5, timeout=300)
    dense.close()
    eng = _paged_engine(net, prefix_cache=False)
    assert eng._prefix is None
    telemetry.reset()
    outs = [eng.generate(p, max_new_tokens=5, timeout=300) for _ in range(2)]
    cnt = telemetry.snapshot()["counters"]
    assert all(o.tokens == ref.tokens for o in outs)
    assert "serving.generate.prefix_hits" not in cnt
    assert "serving.generate.pages.shared" not in cnt
    assert cnt["serving.generate.prefills"] == 2
    eng.close()
    assert eng._pool.free_count == eng._pool.n_pages - 1


def test_engine_paged_prefix_hit_skips_prefill(net):
    eng = _paged_engine(net)
    p = _prompt(onp.random.RandomState(6), PS * 2)
    r1 = eng.generate(p, max_new_tokens=5, timeout=300)
    telemetry.reset()
    r2 = eng.generate(p, max_new_tokens=5, timeout=300)
    snap = telemetry.snapshot()
    assert r2.tokens == r1.tokens
    assert snap["counters"].get("serving.generate.prefix_hits", 0) == 1
    assert "serving.generate.prefill_chunks" not in snap["counters"]
    eng.close()


def test_engine_paged_cow_and_arbitrary_finish_order(net):
    """Requests sharing one prompt with a partial tail page finish in
    any order: every stream is right, the divergence page is COW'd, and
    after close the pool is fully free."""
    eng = _paged_engine(net)
    p = _prompt(onp.random.RandomState(7), 13)
    dense = _dense_engine(net, max_new_tokens=16)
    budgets = (9, 2, 14, 5, 11, 3)
    refs = {b: dense.generate(p, max_new_tokens=b, timeout=300).tokens
            for b in budgets}
    dense.close()
    telemetry.reset()
    streams = [eng.submit(p, max_new_tokens=b) for b in budgets]
    outs = {b: s.result(timeout=300).tokens for b, s in zip(budgets, streams)}
    snap = telemetry.snapshot()
    assert outs == refs
    assert snap["counters"]["serving.generate.pages.cow_copies"] >= 1
    assert snap["counters"]["serving.generate.pages.shared"] > 0
    eng.close()
    assert eng._pool.free_count == eng._pool.n_pages - 1


def test_engine_paged_one_chunk_per_iteration(net):
    eng = _paged_engine(net)
    eng.warmup()
    rng = onp.random.RandomState(8)
    short, long_p = _prompt(rng, 4), _prompt(rng, 50)
    dense = _dense_engine(net, max_new_tokens=24)
    ref_long = dense.generate(long_p, max_new_tokens=8, timeout=300).tokens
    dense.close()
    telemetry.reset()
    busy = eng.submit(short, max_new_tokens=24)
    s = eng.submit(long_p, max_new_tokens=8)
    assert s.result(timeout=300).tokens == ref_long
    busy.result(timeout=300)
    snap = telemetry.snapshot()
    assert snap["counters"]["serving.generate.prefill_chunks"] >= 4
    assert snap["gauges"][
        "serving.generate.prefill_chunks_per_iter"]["peak"] <= 1
    eng.close()


def test_engine_paged_pool_exhaustion_defers_admission(net):
    """More demand than pages: admission waits for freed pages and
    everything completes; a request that can never fit is rejected at
    submit."""
    eng = _paged_engine(net, n_pages=SMAX // PS // 2 + 1)
    rng = onp.random.RandomState(9)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(_prompt(rng, SMAX - 1), max_new_tokens=64)
    streams = [eng.submit(_prompt(rng, 20), max_new_tokens=12)
               for _ in range(6)]
    for s in streams:
        assert len(s.result(timeout=300).tokens) == 12
    eng.close()
    assert eng._pool.free_count == eng._pool.n_pages - 1


def test_engine_paged_match_survives_eviction_during_alloc(net):
    """A matched prefix's pages are retained BEFORE the private
    allocation may LRU-evict their record, so they never come back as
    the same request's private pages."""
    eng = _paged_engine(net, n_pages=9)
    rng = onp.random.RandomState(11)
    a = _prompt(rng, 4 * PS)
    follow = onp.concatenate([a[:2 * PS], _prompt(rng, 2)])
    dense = _dense_engine(net)
    ref_a = dense.generate(a, max_new_tokens=4, timeout=300).tokens
    ref_f = dense.generate(follow, max_new_tokens=32, timeout=300).tokens
    dense.close()
    assert eng.generate(a, max_new_tokens=4, timeout=300).tokens == ref_a
    assert eng.generate(follow, max_new_tokens=32, timeout=300).tokens \
        == ref_f
    eng.close()
    assert eng._pool.free_count == eng._pool.n_pages - 1


def test_engine_paged_prefix_hit_degrades_to_unshared(net, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING", "0")
    eng = _paged_engine(net, max_slots=2, page_size=16, prefill_chunk=16,
                        n_pages=5)
    p = _prompt(onp.random.RandomState(14), 20)
    first = eng.generate(p, max_new_tokens=4, timeout=300)
    second = eng.generate(p, max_new_tokens=44, timeout=300)
    assert second.tokens[:4] == first.tokens
    eng.close()


def test_engine_paged_close_mid_prefill_rejects_not_empty(net):
    outcomes = set()
    rng = onp.random.RandomState(13)
    for _ in range(3):
        eng = _paged_engine(net, max_new_tokens=4)
        s = eng.submit(_prompt(rng, SMAX - 2))
        eng.close(timeout=0.0)
        try:
            assert len(s.result(timeout=30).tokens) >= 1
            outcomes.add("tokens")
        except EngineClosedError:
            outcomes.add("rejected")
        assert eng._pool.free_count == eng._pool.n_pages - 1
    assert outcomes


def test_engine_paged_sync_mode(net, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING", "0")
    eng = _paged_engine(net, max_new_tokens=6)
    assert eng._worker is None
    p = _prompt(onp.random.RandomState(10), 25)
    s = eng.submit(p)
    assert s.done()
    eng.close()
    monkeypatch.setenv("MXTPU_SERVING", "1")
    eng2 = _paged_engine(net, max_new_tokens=6)
    assert eng2.generate(p, timeout=300).tokens == s.result().tokens
    eng2.close()


def test_engine_paged_keeps_its_pool(net):
    """Admissions, COW and decode over ONE pool allocation."""
    eng = _paged_engine(net)
    eng.warmup()
    ptrs = [t.data_ptr() for t in eng._cache_tensors()]
    rng = onp.random.RandomState(15)
    shared = _prompt(rng, 13)
    wave = [eng.submit(shared if i % 3 == 0 else _prompt(rng, 3 + 5 * i),
                       max_new_tokens=2 + i % 5) for i in range(9)]
    for s in wave:
        assert len(s.result(timeout=300).tokens) >= 1
    assert [t.data_ptr() for t in eng._cache_tensors()] == ptrs
    eng.close()


def test_engine_paged_constructor_validation(net):
    with pytest.raises(ValueError, match="power of two"):
        _paged_engine(net, page_size=12)
    with pytest.raises(ValueError, match="divide"):
        GenerationEngine(net, max_slots=2, max_length=40, paged=True,
                         page_size=16, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        _paged_engine(net, prefill_chunk=12)
    with pytest.raises(ValueError, match="quantize"):
        _paged_engine(net, quantize="int4")


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8_kv"])
def test_engine_paged_rollover_flushes_prefix_cache(kv_dtype):
    """load_weights on a paged engine drops the prefix cache (its K/V
    came from the old weights): the repeated prompt prefills again under
    the new weights — no stale prefix hit — and matches a fresh engine
    (tests/test_paged.py's rollover test)."""
    def build(seed):
        return tgpt.gpt_small(device="cpu").initialize(seed=seed)
    params_b = {k: p.data().numpy().copy()
                for k, p in build(2).collect_params().items()}
    eng = _paged_engine(build(1), kv_dtype=kv_dtype)
    p = _prompt(onp.random.RandomState(12), 2 * PS)   # a clean peek hit
    eng.generate(p, max_new_tokens=4, timeout=300)
    assert len(eng._prefix) == 1
    eng.load_weights(params_b)
    assert len(eng._prefix) == 0, "stale prefix survived the rollover"
    telemetry.reset()
    got = eng.generate(p, max_new_tokens=4, timeout=300).tokens
    assert telemetry.counter_value("serving.generate.prefix_hits") == 0
    eng.close()
    ref = _paged_engine(build(2), kv_dtype=kv_dtype)
    assert got == ref.generate(p, max_new_tokens=4, timeout=300).tokens
    ref.close()


def test_engine_paged_sampled_requests_seeded(net):
    """Paged mode arms a sampled request at its first token: its stream
    is the same alone and behind a chunked prefill, a prefix hit and
    greedy co-tenants."""
    rng = onp.random.RandomState(17)
    p, long_p = _prompt(rng, 13), _prompt(rng, 40)
    eng = _paged_engine(net, max_new_tokens=10)
    alone = eng.submit(p, temperature=0.8, top_k=50, seed=4).result(
        timeout=300).tokens
    streams = [eng.submit(long_p), eng.submit(p),
               eng.submit(p, temperature=0.8, top_k=50, seed=4),
               eng.submit(long_p, temperature=1.2, seed=9)]
    out = [s.result(timeout=300).tokens for s in streams]
    eng.close()
    assert out[2] == alone
    assert eng._pool.free_count == eng._pool.n_pages - 1
