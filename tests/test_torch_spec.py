"""Speculative decoding in the port (ROADMAP.md queue 1, item 9): the
accept rules of ``ops/sampling.py``, the verify/propose/commit calls of
``gluon/model_zoo/gpt.py`` and the engine's ``draft_model=``, on the
CPU, against the JAX package on the same numpy weights
(``load_jax_params``), at the sizes of ``tests/test_speculative.py``
(vocab 97; a 2-layer, 32-unit target and a 1-layer, 16-unit draft; 64
cache rows).

Guarantees under test:
- ``greedy_accept`` equals the JAX function exactly, and
  ``speculative_accept``'s greedy rows equal it inside a mixed batch;
- the sampled accept rule commits draws from the WARPED target
  distribution: over 4000 seeded rows (V = 8, fixed p and q) the first
  committed token is within total variation 0.04 of the JAX package's
  ``warp_logits`` + softmax, and the first proposal is accepted at
  sum(min(p, q)) within 0.03; ``sample_with_probs``'s probabilities
  equal the JAX function's (rtol 1e-6);
- ``verify_step``/``verify_step_paged`` logits equal the JAX model's and
  the port's sequential decode chain (1e-5), ``advance_len`` commits and
  rolls back (a continued decode equals the never-speculated cache's),
  inactive rows write scrap page 0 only, and after a paged int8 verify
  across a page boundary the int8 pools and the scale pools are bitwise
  the JAX package's (both start from the same numpy state);
- greedy ``propose_tokens`` equals the JAX model's;
- greedy speculative engines are token-identical to the JAX speculative
  engine and to the port's non-speculative engine — dense, paged, and
  paged with int8 weights and an int8 KV cache — and bf16 compute with
  speculation equals bf16 without;
- seeded sampled streams repeat across engine restarts and do not depend
  on co-tenants, nor on what a slot's previous tenant left in the
  draft's cache; the ``spec_k`` capacity margin, eos inside a
  multi-token commit, the reference's validation, the
  ``serving.generate.spec.*`` telemetry, no reallocation after warmup
  (the port's form of "compiles nothing"), and ``decode_ticks > 1``
  refused.

Sampled draws are never compared with the JAX package's token for
token: Philox and Threefry streams differ.
"""
import numpy as onp
import pytest
import torch
import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.ops import sampling as jsmp
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.ops import sampling as tsmp
from mxnet_tpu_torch.serving import GenerationEngine

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, SLOTS, SMAX, PS, K = 97, 4, 64, 8, 3
N_PAGES = SLOTS * SMAX // PS + 1
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PAGED = dict(paged=True, page_size=PS, prefill_chunk=16)
INT8 = dict(PAGED, quantize="int8_weights", kv_dtype="int8")

def _jax_model(units, layers, seed):
    onp.random.seed(seed)
    mx.np.random.seed(seed)
    net = jgpt.gpt_small(vocab_size=VOCAB, units=units, num_layers=layers,
                         num_heads=4, max_length=128)
    net.initialize(mx.init.Xavier())
    net._gen_params()
    return net


def _port_of(jnet, units, layers):
    """A port model on the JAX model's weights."""
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tgpt.gpt_small(vocab_size=VOCAB, units=units, num_layers=layers,
                          num_heads=4, max_length=128, device="cpu")
    return tgpt.load_jax_params(tnet, params)


def _pair(units, layers, seed):
    """(JAX model, port model) on the same seeded weights."""
    jnet = _jax_model(units, layers, seed)
    return jnet, _port_of(jnet, units, layers)


@pytest.fixture(scope="module")
def target():
    return _pair(32, 2, 21)


@pytest.fixture(scope="module")
def draft():
    return _pair(16, 1, 22)


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def _engine(net, max_new=8, **kw):
    return GenerationEngine(net, max_slots=SLOTS, max_length=SMAX,
                            max_new_tokens=max_new, queue_limit=64,
                            device="cpu", **kw).warmup()


def _serve(eng, prompts, budgets, **submit_kw):
    streams = [eng.submit(p, max_new_tokens=b, **submit_kw)
               for p, b in zip(prompts, budgets)]
    out = [s.result(timeout=240) for s in streams]
    eng.close()
    return out


# -- the accept rules ----------------------------------------------------

def _verify_case(seed, b=6, k=4, v=11):
    """Target logits (B, K+1, V) and drafts that follow the target's
    argmax for a random number of steps, then stray."""
    rng = onp.random.RandomState(seed)
    lg = (rng.randn(b, k + 1, v) * 2.0).astype("f4")
    arg = lg.argmax(-1)[:, :k]
    d = arg.copy()
    for row in range(b):
        cut = rng.randint(0, k + 1)
        if cut < k:
            d[row, cut] = (arg[row, cut] + 1 + rng.randint(v - 1)) % v
            d[row, cut + 1:] = rng.randint(0, v, size=k - cut - 1)
    return lg, d.astype("i4")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_accept_matches_jax(seed):
    lg, d = _verify_case(seed)
    commit, n = tsmp.greedy_accept(torch.from_numpy(lg), torch.from_numpy(d))
    jc, jn = jsmp.greedy_accept(jnp.asarray(lg), jnp.asarray(d))
    assert commit.dtype == n.dtype == torch.int32
    onp.testing.assert_array_equal(commit.numpy(), onp.asarray(jc))
    onp.testing.assert_array_equal(n.numpy(), onp.asarray(jn))
    assert sorted(set(n.tolist())) != [n.tolist()[0]]   # varied cuts


def test_speculative_accept_greedy_rows_follow_greedy_accept():
    lg, d = _verify_case(3)
    b, k1, v = lg.shape
    temps = onp.asarray([0.0, 0.8, 0.0, 1.0, 0.0, 0.5], "f4")
    gens = [torch.Generator().manual_seed(i) for i in range(b)]
    q = torch.softmax(torch.from_numpy(
        onp.random.RandomState(4).randn(b, k1 - 1, v).astype("f4")), -1)
    commit, n = tsmp.speculative_accept(
        gens, torch.from_numpy(lg), torch.from_numpy(d), q, temps,
        onp.zeros(b, "i4"), onp.ones(b, "f4"))
    gc, gn = tsmp.greedy_accept(torch.from_numpy(lg), torch.from_numpy(d))
    greedy = temps <= 0
    onp.testing.assert_array_equal(commit.numpy()[greedy],
                                   gc.numpy()[greedy])
    onp.testing.assert_array_equal(n.numpy()[greedy], gn.numpy()[greedy])
    assert ((n >= 1) & (n <= k1)).all()
    # a sampled row's committed prefix is its accepted draft tokens
    for row in onp.flatnonzero(~greedy):
        m = int(n[row])
        assert commit[row, :m - 1].tolist() == d[row, :m - 1].tolist()
        assert (commit[row, m:] == 0).all()


def test_speculative_accept_distribution():
    """4000 rows, each with its own seeded generator, k = 2: the first
    committed token follows the warped target p (total variation <=
    0.04 from the JAX package's warp + softmax) and the first proposal,
    drawn from q, is accepted at sum(min(p, q)) (within 0.03)."""
    n, k, v = 4000, 2, 8
    logits = onp.asarray([2.0, 1.5, 1.0, 0.5, 0.2, -0.5, -1.0, 0.8], "f4")
    knobs = (0.9, 6, 0.95)
    p = onp.asarray(jax.nn.softmax(jsmp.warp_logits(
        jnp.asarray(logits[None]), onp.asarray([knobs[0]], "f4"),
        onp.asarray([knobs[1]], "i4"), onp.asarray([knobs[2]], "f4"))))[0]
    p = p.astype("f8") / p.sum()
    assert (p == 0).sum() >= 2    # the warp masked some tokens
    q = onp.asarray([0.05, 0.3, 0.1, 0.05, 0.1, 0.2, 0.1, 0.1], "f8")
    rng = onp.random.RandomState(7)
    d = rng.choice(v, size=(n, k), p=q).astype("i4")
    tl = torch.from_numpy(onp.broadcast_to(logits, (n, k + 1, v)).copy())
    qt = torch.from_numpy(onp.broadcast_to(q, (n, k, v)).astype("f4").copy())
    gens = [torch.Generator().manual_seed(1000 + i) for i in range(n)]
    commit, n_commit = tsmp.speculative_accept(
        gens, tl, torch.from_numpy(d), qt, onp.full(n, knobs[0], "f4"),
        onp.full(n, knobs[1], "i4"), onp.full(n, knobs[2], "f4"))
    first = onp.bincount(commit[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * onp.abs(first - p).sum()
    assert tv <= 0.04, (tv, first, p)
    rate = float((n_commit > 1).double().mean())
    assert abs(rate - onp.minimum(p, q).sum()) <= 0.03, rate
    assert int(n_commit.min()) >= 1 and int(n_commit.max()) <= k + 1


def test_sample_with_probs_matches_jax():
    rng = onp.random.RandomState(8)
    lg = (rng.randn(6, 41) * 2.0).astype("f4")
    t = onp.asarray([0.0, 1.0, 0.7, 1.3, 0.0, 0.5], "f4")
    tk = onp.asarray([0, 5, 1, 40, 3, 0], "i4")
    tp = onp.asarray([1.0, 0.9, 0.5, 0.3, 1.0, 0.95], "f4")
    gens = [torch.Generator().manual_seed(i) for i in range(6)]
    tok, probs = tsmp.sample_with_probs(gens, torch.from_numpy(lg), t, tk, tp)
    _, jprobs, _ = jsmp.sample_with_probs(
        jnp.zeros((6, 2), jnp.uint32), jnp.asarray(lg), t, tk, tp)
    onp.testing.assert_allclose(probs.numpy(), onp.asarray(jprobs),
                                rtol=1e-6, atol=1e-7)
    greedy = t <= 0
    onp.testing.assert_array_equal(tok.numpy()[greedy],
                                   lg.argmax(-1)[greedy])
    assert (probs.numpy()[onp.arange(6), tok.numpy()] > 0).all()
    again, _ = tsmp.sample_with_probs(
        [torch.Generator().manual_seed(i) for i in range(6)],
        torch.from_numpy(lg), t, tk, tp)
    assert again.tolist() == tok.tolist()


# -- the model calls -------------------------------------------------------

def _prefilled(net, prompt, paged, kv_dtype=None):
    pad = onp.zeros((1, 8), "i4")
    pad[0, :prompt.size] = prompt
    if paged:
        row = onp.zeros((SMAX // PS,), "i4")
        row[:4] = [1, 2, 3, 4]
        cache = net.init_paged_cache(SLOTS, N_PAGES, PS, SMAX, dtype=kv_dtype)
        lg, cache = net.prefill_paged(pad, prompt.size, 0, row, cache,
                                      fresh=True)
    else:
        cache = net.init_cache(SLOTS, SMAX, dtype=kv_dtype)
        lg, cache = net.prefill(pad, [prompt.size], cache, slots=[0])
    return int(onp.asarray(lg)[0].argmax()), cache


def _decode(net, paged, tok, cache):
    step = onp.zeros((SLOTS,), "i4")
    step[0] = tok
    if paged:
        active = onp.zeros((SLOTS,), "i4")
        active[0] = 1
        lg, cache = net.decode_step_paged(step, active, cache)
    else:
        lg, cache = net.decode_step(step, cache)
    return onp.asarray(lg)[0], cache


def _verify(net, paged, seq, cache):
    vt = onp.zeros((SLOTS, len(seq)), "i4")
    vt[0] = seq
    if paged:
        active = onp.zeros((SLOTS,), "i4")
        active[0] = 1
        lg, cache = net.verify_step_paged(vt, active, cache)
    else:
        lg, cache = net.verify_step(vt, cache)
    return onp.asarray(lg)[0], cache


def _advance(net, paged, n, cache):
    delta = onp.zeros((SLOTS,), "i4")
    delta[0] = n
    return (net.advance_len_paged if paged else net.advance_len)(delta,
                                                                 cache)


@pytest.mark.parametrize("paged,kv_dtype", [(False, None), (False, "int8"),
                                            (True, None)],
                         ids=["dense", "dense_int8_kv", "paged"])
def test_verify_step_matches_jax_and_sequential_decode(target, paged,
                                                       kv_dtype):
    """Verify logits at all R positions equal the JAX model's verify and
    the port's decode chain over the same tokens; a full commit then
    continues as the never-speculated cache does."""
    jnet, tnet = target
    rng = onp.random.RandomState(0)
    prompt, chain = _prompt(rng, 7), _prompt(rng, 3)
    last, seq_cache = _prefilled(tnet, prompt, paged, kv_dtype)
    seq = [last] + chain.tolist()
    ref = []
    for t in seq:
        lg, seq_cache = _decode(tnet, paged, t, seq_cache)
        ref.append(lg)
    ref = onp.stack(ref)
    _, tc = _prefilled(tnet, prompt, paged, kv_dtype)
    _, jc = _prefilled(jnet, prompt, paged, kv_dtype)
    vt, tc = _verify(tnet, paged, seq, tc)
    vj, jc = _verify(jnet, paged, seq, jc)
    onp.testing.assert_allclose(vt, vj, **LOGIT_TOL)
    onp.testing.assert_allclose(vt, ref, **LOGIT_TOL)
    assert int(tc["len"][0]) == 7           # len unchanged
    tc = _advance(tnet, paged, len(seq), tc)
    assert int(tc["len"][0]) == int(seq_cache["len"][0]) == 11
    nxt = int(ref[-1].argmax())
    la, _ = _decode(tnet, paged, nxt, seq_cache)
    lb, _ = _decode(tnet, paged, nxt, tc)
    onp.testing.assert_allclose(lb, la, **LOGIT_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_rollback_clips_rejected_tail(target, paged):
    """A partial commit leaves the cache at the accept point: decoding on
    from there gives the sequential chain's logits."""
    tnet = target[1]
    rng = onp.random.RandomState(1)
    prompt, chain = _prompt(rng, 5), _prompt(rng, 3)
    last, ref_cache = _prefilled(tnet, prompt, paged)
    seq = [last] + chain.tolist()
    ref = []
    for t in seq:
        lg, ref_cache = _decode(tnet, paged, t, ref_cache)
        ref.append(lg)
    _, cache = _prefilled(tnet, prompt, paged)
    _, cache = _verify(tnet, paged, seq, cache)
    cache = _advance(tnet, paged, 2, cache)   # accept [last, chain[0]]
    lg, _ = _decode(tnet, paged, seq[2], cache)
    onp.testing.assert_allclose(lg, ref[2], **LOGIT_TOL)


def test_verify_inactive_rows_write_scrap_only(target):
    tnet = target[1]
    cache = tnet.init_paged_cache(SLOTS, N_PAGES, PS, SMAX)
    cache["table"][:] = torch.arange(1, 1 + SLOTS * 8, dtype=torch.int32
                                     ).reshape(SLOTS, 8)
    cache["len"][:] = torch.tensor([3, 8, 15, 60], dtype=torch.int32)
    before = [p.clone() for p in (*cache["k"], *cache["v"])]
    _, cache = tnet.verify_step_paged(onp.ones((SLOTS, 4), "i4"),
                                      onp.zeros((SLOTS,), "i4"), cache)
    for b, a in zip(before, (*cache["k"], *cache["v"])):
        assert torch.equal(a[1:], b[1:]), \
            "an inactive row's verify write escaped the scrap page"
    assert cache["len"].tolist() == [3, 8, 15, 60]


def test_int8_paged_verify_pools_bitwise_equal_to_jax(target):
    """Both packages start from one numpy pool state (int8 entries,
    per-page scales, table, lengths); after a verify that crosses page
    boundaries — row 0 from a partly committed page into a fresh one,
    row 1 from a page boundary, row 2 past its reservation, row 3
    inactive — every page but the scrap page and every scale are
    bitwise equal, the fresh pages carry their anchor's scale, and the
    logits agree."""
    jnet, tnet = target
    rng = onp.random.RandomState(2)
    layers, heads, dh = 2, 4, 8
    shape = (N_PAGES, heads, PS, dh)
    pools = {key: [rng.randint(-127, 128, size=shape).astype("i1")
                   for _ in range(layers)] for key in ("k", "v")}
    scales = {key: [(rng.rand(N_PAGES, heads) * 0.05 + 0.01).astype("f4")
                    for _ in range(layers)] for key in ("k_scale", "v_scale")}
    table = onp.zeros((SLOTS, SMAX // PS), "i4")
    table[0, :3] = [3, 5, 9]
    table[1, :2] = [7, 11]
    table[2, :2] = [12, 13]
    table[3, :2] = [20, 21]
    ln = onp.asarray([14, 8, 13, 5], "i4")
    active = onp.asarray([1, 1, 1, 0], "i4")
    tokens = rng.randint(0, VOCAB, size=(SLOTS, 5)).astype("i4")

    def state(asarray):
        c = {key: tuple(asarray(a.copy()) for a in val)
             for key, val in {**pools, **scales}.items()}
        c["table"], c["len"] = asarray(table.copy()), asarray(ln.copy())
        return c
    tc = state(torch.from_numpy)
    jc = state(jnp.asarray)
    tl, tc = tnet.verify_step_paged(tokens, active, tc)
    jl, jc = jnet.verify_step_paged(tokens, active, jc)
    onp.testing.assert_allclose(tl.numpy()[:3], onp.asarray(jl)[:3],
                                **LOGIT_TOL)
    for key in ("k", "v", "k_scale", "v_scale"):
        for li in range(layers):
            a, b = tc[key][li].numpy(), onp.asarray(jc[key][li])
            onp.testing.assert_array_equal(a[1:], b[1:], err_msg=key)
            # only the verified pages (and the scrap page) changed
            old = (pools if key in pools else scales)[key][li]
            changed = sorted(set(onp.flatnonzero(
                (a != old).reshape(N_PAGES, -1).any(1)).tolist()) - {0})
            assert set(changed) <= {5, 9, 11, 13}, (key, changed)
            if key.endswith("scale"):
                assert (a[9] == old[5]).all() and (a[11] == old[7]).all()
                assert (a[5] == old[5]).all() and (a[13] == old[13]).all()
    assert tc["len"].tolist() == ln.tolist()


def test_propose_tokens_greedy_matches_jax(draft):
    jnet, tnet = draft
    rng = onp.random.RandomState(3)
    prompts = [_prompt(rng, n) for n in (5, 8, 3, 7)]
    tc, jc = tnet.init_cache(SLOTS, SMAX), jnet.init_cache(SLOTS, SMAX)
    firsts = []
    for b, p in enumerate(prompts):
        pad = onp.zeros((1, 8), "i4")
        pad[0, :p.size] = p
        lg, tc = tnet.prefill(pad, [p.size], tc, slots=[b])
        _, jc = jnet.prefill(pad, [p.size], jc, slots=[b])
        firsts.append(int(lg[0].argmax()))
    firsts = onp.asarray(firsts, "i4")
    td, tc = tnet.propose_tokens(firsts, tc, 5)
    jd, jc = jnet.propose_tokens(firsts, jc, 5)
    assert td.dtype == torch.int32
    onp.testing.assert_array_equal(td.numpy(), onp.asarray(jd))
    assert tc["len"].tolist() == onp.asarray(jc["len"]).tolist() \
        == [10, 13, 8, 12]


# -- the engine ------------------------------------------------------------

def _corpus(seed, paged):
    rng = onp.random.RandomState(seed)
    if paged:    # shared prefixes: prefix hits, COW under verify writes
        sysp = _prompt(rng, 24)
        prompts = [onp.concatenate([sysp, _prompt(rng, 1 + i % 5)])
                   for i in range(6)] + [_prompt(rng, 5)]
    else:
        prompts = [_prompt(rng, n) for n in (3, 9, 17, 5, 12, 7)]
    return prompts, [4 + i % 5 for i in range(len(prompts))]


@pytest.mark.parametrize("kw", [{}, PAGED, INT8],
                         ids=["dense", "paged", "paged_int8_w_int8_kv"])
def test_engine_spec_greedy_token_identical(target, draft, kw):
    """The reference's identity suite: the speculative engine's greedy
    tokens equal the JAX speculative engine's and the port's
    non-speculative engine's, request by request (an int8 engine arms
    its model's tables, so that case builds its own pairs; the fp32
    cases serve the module's, whose JAX models are compiled once)."""
    (jt, tt), (jd, td) = ((_pair(32, 2, 21), _pair(16, 1, 22))
                          if kw is INT8 else (target, draft))
    prompts, budgets = _corpus(3 + len(kw), bool(kw))
    jeng = JaxEngine(jt, max_slots=SLOTS, max_length=SMAX, max_new_tokens=8,
                     queue_limit=64, draft_model=jd, spec_k=K, **kw)
    ref = [s.result(timeout=240).tokens for s in
           [jeng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]]
    jeng.close()
    plain = [r.tokens for r in _serve(_engine(tt, **kw), prompts, budgets)]
    spec = _engine(tt, draft_model=td, spec_k=K, **kw)
    assert spec.speculation == "k=3:draft=GPTModel:1L-16u"
    assert spec.precision == ("int8_weights+int8_kv" if kw is INT8
                              else "fp32")
    out = _serve(spec, prompts, budgets)
    assert [r.tokens for r in out] == ref == plain
    assert all(r.finish_reason == "length" for r in out)


def test_bf16_spec_equals_bf16_without(target, draft):
    """bf16 target compute with a draft (which stays fp32) commits the
    bf16 engine's own greedy tokens."""
    prompts, budgets = _corpus(4, False)
    tnet = _port_of(target[0], 32, 2)
    plain = _serve(_engine(tnet, compute_dtype="bfloat16"), prompts, budgets)
    spec = _engine(tnet, compute_dtype="bfloat16", draft_model=draft[1],
                   spec_k=K)
    assert spec._cache["k"][0].dtype == torch.bfloat16
    assert spec._draft_cache["k"][0].dtype == torch.float32
    assert spec.precision == "bf16"
    out = _serve(spec, prompts, budgets)
    assert [r.tokens for r in out] == [r.tokens for r in plain]


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_spec_sampled_streams_seeded_and_cotenant_independent(target, draft,
                                                              kw):
    """A seeded sampled request gives the same tokens on a fresh engine
    (a restart), alone or beside busy sampled and greedy co-tenants; a
    different seed gives another stream; temperature 0 is greedy."""
    rng = onp.random.RandomState(9)
    p = _prompt(rng, 20)
    knobs = dict(temperature=0.9, top_k=20, top_p=0.9)

    def spec():
        return _engine(target[1], max_new=12, draft_model=draft[1],
                       spec_k=K, **kw)
    eng = spec()
    alone = eng.submit(p, seed=1234, **knobs).result(timeout=240).tokens
    other = eng.submit(p, seed=1235, **knobs).result(timeout=240).tokens
    greedy0 = eng.submit(p, temperature=0.0).result(timeout=240).tokens
    greedy = eng.submit(p).result(timeout=240).tokens
    eng.close()
    eng = spec()
    busy = [eng.submit(_prompt(rng, 4 + i), max_new_tokens=30,
                       temperature=1.1, seed=i) for i in range(2)]
    busy.append(eng.submit(_prompt(rng, 6), max_new_tokens=30))
    again = eng.submit(p, seed=1234, **knobs).result(timeout=240).tokens
    for s in busy:
        s.result(timeout=240)
    eng.close()
    assert again == alone
    assert other != alone
    assert greedy0 == greedy


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_spec_sampled_stream_independent_of_the_slots_history(target, kw):
    """The target as its own draft accepts every sampled proposal, and
    after each full accept the draft attends the position of its last
    proposal, whose K/V it never wrote (the reference's rollback,
    ``n_commit - k``). The engine zeroes the draft's row at admission,
    so a seeded stream in a slot that a longer request used before
    equals the same stream on a fresh engine."""
    tnet = target[1]
    rng = onp.random.RandomState(12)
    p, other = _prompt(rng, 4), _prompt(rng, 6)
    knobs = dict(temperature=0.9, seed=5)

    def one_slot():
        return GenerationEngine(tnet, max_slots=1, max_length=SMAX,
                                max_new_tokens=30, draft_model=tnet,
                                spec_k=K, device="cpu", **kw)
    eng = one_slot()
    fresh = eng.submit(p, **knobs).result(timeout=240).tokens
    eng.close()
    eng = one_slot()
    eng.submit(other, max_new_tokens=40, temperature=1.0,
               seed=9).result(timeout=240)
    reused = eng.submit(p, **knobs).result(timeout=240).tokens
    eng.close()
    assert reused == fresh


def test_spec_capacity_margin_and_eos(target, draft):
    """Usable capacity is max_length - spec_k, enforced at validation and
    at eviction; eos inside a multi-token commit cuts the emission at
    the stop token."""
    eng = GenerationEngine(target[1], draft_model=draft[1], spec_k=K,
                           max_slots=2, max_length=32, max_new_tokens=100,
                           queue_limit=16, device="cpu")
    rng = onp.random.RandomState(10)
    with pytest.raises(ValueError, match="no room"):
        eng.submit(_prompt(rng, 29))     # fits 32 but not 32 - spec_k
    r = eng.generate(_prompt(rng, 10), timeout=120)
    assert r.finish_reason == "length"
    assert len(r.tokens) == (32 - K) - 10 + 1
    p = _prompt(rng, 5)
    free = eng.generate(p, max_new_tokens=10, timeout=120)
    j = next(i for i in range(1, len(free.tokens))
             if free.tokens[i] not in free.tokens[:i])
    r = eng.generate(p, max_new_tokens=10, eos_id=free.tokens[j],
                     timeout=120)
    assert r.finish_reason == "eos"
    assert r.tokens == free.tokens[:j + 1]
    eng.close()


def test_spec_validation(target, draft):
    tnet, dnet = target[1], draft[1]
    kw = dict(max_length=SMAX, device="cpu")
    with pytest.raises(ValueError, match="draft_model"):
        GenerationEngine(tnet, speculative=True, **kw)
    with pytest.raises(ValueError, match="inert"):
        GenerationEngine(tnet, draft_model=dnet, speculative=False, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        GenerationEngine(tnet, draft_model=dnet, spec_k=0, **kw)
    with pytest.raises(TypeError, match="explicit-cache"):
        GenerationEngine(tnet, draft_model=object(), **kw)
    small = tgpt.gpt_small(vocab_size=11, units=16, num_layers=1,
                           num_heads=4, max_length=128, device="cpu")
    with pytest.raises(TypeError, match="vocab"):
        GenerationEngine(tnet, draft_model=small, **kw)
    with pytest.raises(ValueError, match="amortization"):
        GenerationEngine(tnet, draft_model=dnet, decode_ticks=4, **kw)
    with pytest.raises(ValueError, match="margin"):
        GenerationEngine(tnet, draft_model=dnet, spec_k=7, max_length=8,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        GenerationEngine(tnet, draft_model=dnet, mesh_layout="tp", **kw)
    assert GenerationEngine(tnet, **kw).speculation == "off"


def test_spec_telemetry_and_no_reallocation(target, draft):
    """The spec counters add up (proposed = accepted + rejected), one
    host sync and three calls per iteration, ``spec_k + 1`` tokens a
    sync at most, and neither cache is reallocated after warmup across
    a greedy and sampled wave."""
    eng = _engine(target[1], draft_model=draft[1], spec_k=K)
    ptrs = [t.data_ptr() for c in (eng._cache, eng._draft_cache)
            for t in (*c["k"], *c["v"], c["len"])]
    rng = onp.random.RandomState(6)
    telemetry.reset()
    wave = [eng.submit(_prompt(rng, 3 + (5 * i) % 20),
                       max_new_tokens=2 + i % 5,
                       temperature=0.8 if i % 2 else None, seed=i)
            for i in range(10)]
    tokens = sum(len(s.result(timeout=240).tokens) for s in wave)
    snap = telemetry.snapshot()
    eng.close()
    assert [t.data_ptr() for c in (eng._cache, eng._draft_cache)
            for t in (*c["k"], *c["v"], c["len"])] == ptrs
    c, g = snap["counters"], snap["gauges"]
    assert c["serving.generate.spec.proposed"] > 0
    assert c["serving.generate.spec.proposed"] == \
        c["serving.generate.spec.accepted"] \
        + c["serving.generate.spec.rejected"]
    assert c["serving.generate.dispatches"] == \
        3 * c["serving.generate.host_syncs"]
    assert g["serving.generate.ticks_per_sync"]["value"] == K + 1
    assert 0 <= g["serving.generate.spec.accept_rate"]["value"] <= 1
    assert g["serving.generate.spec.tokens_per_step"]["peak"] <= \
        SLOTS * (K + 1)
    # every generated token but each request's first comes from a verify
    assert c["serving.generate.tokens"] == tokens
    assert tokens - 10 <= c["serving.generate.host_syncs"] * SLOTS * (K + 1)


def test_spec_sync_mode_and_load_weights(target, draft, monkeypatch):
    """MXTPU_SERVING=0 speculative generation matches the threaded
    engine; ``load_weights`` swaps the target only, and the engine then
    serves a fresh engine's tokens on the new weights."""
    tnet = _port_of(target[0], 32, 2)
    rng = onp.random.RandomState(11)
    p = _prompt(rng, 7)
    eng = _engine(tnet, max_new=6, draft_model=draft[1], spec_k=K)
    ref = eng.submit(p).result(timeout=120).tokens
    new = {k: q._read().numpy() * 1.5 for k, q in
           _pair(32, 2, 23)[1].collect_params().items()}
    draft_before = {k: v._read().clone() for k, v in
                    draft[1].collect_params().items()}
    eng.load_weights(new)
    swapped = eng.submit(p).result(timeout=120).tokens
    eng.close()
    assert all(torch.equal(v._read(), draft_before[k])
               for k, v in draft[1].collect_params().items())
    fresh = _serve(_engine(tnet, max_new=6), [p], [6])[0].tokens
    assert swapped == fresh
    monkeypatch.setenv("MXTPU_SERVING", "0")
    tnet2 = _port_of(target[0], 32, 2)
    eng2 = GenerationEngine(tnet2, draft_model=draft[1], spec_k=K,
                            max_slots=SLOTS, max_length=SMAX,
                            max_new_tokens=6, device="cpu")
    s = eng2.submit(p)
    assert s.done()
    assert s.result().tokens == ref
    eng2.close()
