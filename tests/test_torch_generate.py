"""The port's GenerationEngine (mxnet_tpu_torch.serving) on the CPU.

Greedy output must be TOKEN-IDENTICAL to the JAX package's engine on
the same weights; eviction (eos, length, capacity, deadline), admission
control and shutdown follow the reference engine's contract; sampled
requests are seeded, row-independent and leave greedy co-tenants
untouched; ``load_weights`` swaps weights in place and serves as a fresh
engine on the new weights would; modes the port does not have yet raise
NotImplementedError naming their ROADMAP.md item (multi-tick decode,
bf16 compute and speculative decoding: tests/test_torch_multitick.py,
tests/test_torch_bf16.py, tests/test_torch_spec.py).
"""
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import gpt as jgpt
from mxnet_tpu.serving import GenerationEngine as JaxEngine
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import gpt as tgpt
from mxnet_tpu_torch.serving import (
    EngineClosedError, GenerationEngine, QueueFullError,
    ReplicaFailedError, RequestTimeoutError,
)

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, SLOTS, SMAX = 97, 4, 64


@pytest.fixture(scope="module")
def pair():
    onp.random.seed(1234)
    mx.np.random.seed(1234)
    jnet = jgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                          num_heads=4, max_length=128)
    jnet.initialize(mx.init.Xavier())
    jnet._gen_params()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                          num_heads=4, max_length=128, device="cpu")
    tgpt.load_jax_params(tnet, params)
    return jnet, tnet


@pytest.fixture(scope="module")
def net(pair):
    return pair[1]


def _engine(net, **kw):
    kw.setdefault("max_length", SMAX)
    return GenerationEngine(net, device="cpu", **kw)


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).astype("i4")


def _ref_generate(net, policy, prompt, max_new, width=SLOTS,
                  max_length=SMAX, eos_id=None):
    """Single-request greedy prefill+decode loop at slot width
    ``width`` on the port's model."""
    cache = net.init_cache(width, max_length)
    n = len(prompt)
    padded = onp.zeros((1, policy.bucket(n)), "i4")
    padded[0, :n] = prompt
    logits, cache = net.prefill(padded, [n], cache, slots=[0])
    toks = [int(logits[0].argmax())]
    n_ctx = n
    while toks[-1] != eos_id and len(toks) < max_new \
            and n_ctx < max_length:
        step = onp.zeros((width,), "i4")
        step[0] = toks[-1]
        lg, cache = net.decode_step(step, cache)
        toks.append(int(lg[0].argmax()))
        n_ctx += 1
    return toks


def test_greedy_tokens_identical_to_jax_engine(pair):
    """The corpus of tests/test_generate.py's parity test through both
    engines on the same weights: every request's tokens, finish reason
    and prompt length agree; the port also equals its own
    single-request loop."""
    jnet, tnet = pair
    rng = onp.random.RandomState(2)
    prompts = [_prompt(rng, n) for n in (3, 9, 17, 5, 30, 12, 7, 21)]
    budgets = [4 + i % 7 for i in range(len(prompts))]
    jeng = JaxEngine(jnet, max_slots=SLOTS, max_length=SMAX,
                     max_new_tokens=8, queue_limit=64)
    jeng.warmup()
    ref = [s.result(timeout=120) for s in
           [jeng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]]
    jeng.close()
    eng = _engine(tnet, max_slots=SLOTS, max_new_tokens=8, queue_limit=64)
    eng.warmup()
    out = [s.result(timeout=120) for s in
           [eng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]]
    eng.close()
    for p, b, r, j in zip(prompts, budgets, out, ref):
        assert r.tokens == j.tokens
        assert (r.finish_reason, r.prompt_len) == \
            (j.finish_reason, j.prompt_len) == ("length", len(p))
        assert r.tokens == _ref_generate(tnet, eng.policy, p, b)


def test_engine_keeps_its_cache_and_counts(net):
    """Slots evict and refill mid-sequence over ONE cache allocation
    (the port's no-steady-state-reallocation contract), and the engine's
    telemetry counts what it did."""
    eng = _engine(net, max_slots=SLOTS, max_new_tokens=6, queue_limit=128)
    eng.warmup()
    ptrs = [t.data_ptr() for t in (*eng._cache["k"], *eng._cache["v"],
                                   eng._cache["len"])]
    telemetry.reset()
    rng = onp.random.RandomState(3)
    wave = [eng.submit(_prompt(rng, 3 + (7 * i) % 28),
                       max_new_tokens=2 + i % 6) for i in range(12)]
    for s in wave:
        assert len(s.result(timeout=120).tokens) >= 1
    assert [t.data_ptr() for t in (*eng._cache["k"], *eng._cache["v"],
                                   eng._cache["len"])] == ptrs
    snap = telemetry.snapshot()
    assert snap["counters"]["serving.generate.evictions"] == 12
    assert snap["counters"]["serving.generate.prefills"] == 12
    assert snap["gauges"]["serving.generate.slots"]["peak"] == SLOTS
    assert snap["counters"]["serving.generate.tokens"] == sum(
        len(s.result().tokens) for s in wave)
    assert snap["histograms"]["serving.generate.ttft"]["count"] == 12
    eng.close()


def test_eos_eviction(net):
    eng = _engine(net, max_slots=2, max_new_tokens=8, queue_limit=16)
    p = _prompt(onp.random.RandomState(4), 5)
    free_run = eng.generate(p, timeout=60)
    assert len(free_run.tokens) == 8
    j = next(i for i in range(1, 8)
             if free_run.tokens[i] not in free_run.tokens[:i])
    r = eng.generate(p, eos_id=free_run.tokens[j], timeout=60)
    assert r.finish_reason == "eos"
    assert r.tokens == free_run.tokens[:j + 1]
    eng.close()


def test_capacity_finishes_with_length(net):
    eng = _engine(net, max_slots=2, max_length=16, max_new_tokens=1000,
                  queue_limit=16)
    r = eng.generate(_prompt(onp.random.RandomState(5), 10), timeout=60)
    assert r.finish_reason == "length"
    assert len(r.tokens) == 16 - 10 + 1
    eng.close()


class _SlowModel:
    """Model wrapper whose decode step takes at least ``delay`` s."""

    def __init__(self, model, delay):
        self._model = model
        self._delay = delay

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, tokens, cache):
        time.sleep(self._delay)
        return self._model.decode_step(tokens, cache)


def test_deadline_finishes_active_generation_with_timeout(net, monkeypatch):
    """A request past its deadline while GENERATING is finished early
    with finish_reason='timeout' and keeps the tokens already
    streamed."""
    monkeypatch.setenv("MXTPU_SERVING", "0")
    eng = _engine(net, max_slots=2, max_new_tokens=50, queue_limit=16)
    eng.model = _SlowModel(net, 0.02)
    r = eng.submit(_prompt(onp.random.RandomState(12), 4),
                   timeout_ms=100.0).result(timeout=60)
    assert r.finish_reason == "timeout"
    assert 1 <= len(r.tokens) < 50
    eng.close()


def test_stream_iteration_and_snapshot(net):
    eng = _engine(net, max_slots=2, max_new_tokens=5, queue_limit=16)
    s = eng.submit(_prompt(onp.random.RandomState(6), 4))
    got = list(s)
    res = s.result(timeout=60)
    assert got == res.tokens == s.tokens and len(got) == 5
    assert list(s) == got
    eng.close()


def test_validation_and_closed_rejection(net):
    eng = _engine(net, max_slots=2, max_length=32, max_new_tokens=4,
                  queue_limit=4)
    rng = onp.random.RandomState(7)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(onp.zeros((2, 3), "i4"))
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(onp.zeros(4, "f4"))
    with pytest.raises(ValueError, match="no room"):
        eng.submit(_prompt(rng, 32))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(_prompt(rng, 3), max_new_tokens=0)
    eng.close()
    with pytest.raises(EngineClosedError):
        eng.submit(_prompt(rng, 3))


def test_queue_limit_sheds_load(net):
    eng = _engine(net, max_slots=1, max_new_tokens=30, queue_limit=2)
    rng = onp.random.RandomState(8)
    rejected, streams = 0, []
    for _ in range(40):
        try:
            streams.append(eng.submit(_prompt(rng, 3), max_new_tokens=2))
        except QueueFullError:
            rejected += 1
    assert rejected > 0, "queue_limit never rejected under flood"
    for s in streams:
        assert len(s.result(timeout=120).tokens) == 2
    eng.close()


def test_request_timeout_in_queue(net):
    eng = _engine(net, max_slots=1, max_new_tokens=8, queue_limit=16)
    eng.warmup()
    rng = onp.random.RandomState(9)
    busy = eng.submit(_prompt(rng, 3), max_new_tokens=30)
    doomed = eng.submit(_prompt(rng, 3), timeout_ms=0.0)
    with pytest.raises(RequestTimeoutError, match=r"waited [0-9.]+ ms"):
        doomed.result(timeout=120)
    assert len(busy.result(timeout=120).tokens) == 30
    eng.close()


def test_close_drains_then_rejects(net):
    eng = _engine(net, max_slots=2, max_new_tokens=4, queue_limit=64)
    rng = onp.random.RandomState(10)
    streams = [eng.submit(_prompt(rng, 5)) for _ in range(8)]
    eng.close(timeout=120.0)
    for s in streams:
        assert len(s.result(timeout=5).tokens) == 4
    with pytest.raises(EngineClosedError):
        eng.submit(_prompt(rng, 5))

    eng2 = _engine(net, max_slots=2, max_new_tokens=40, queue_limit=64)
    streams = [eng2.submit(_prompt(rng, 5)) for _ in range(8)]
    eng2.close(timeout=0.0)
    done = rejected = truncated = 0
    for s in streams:
        try:
            r = s.result(timeout=10)
            if r.finish_reason == "closed":
                truncated += 1
            else:
                done += 1
        except EngineClosedError:
            rejected += 1
    assert done + rejected + truncated == 8, "a stream hung"


def test_serving_disabled_sync_mode_parity(net, monkeypatch):
    monkeypatch.setenv("MXTPU_SERVING", "0")
    eng = _engine(net, max_slots=SLOTS, max_new_tokens=6, queue_limit=16)
    assert eng._worker is None
    p = _prompt(onp.random.RandomState(11), 7)
    s = eng.submit(p)
    assert s.done()
    assert s.result().tokens == _ref_generate(net, eng.policy, p, 6)
    eng.close()
    with pytest.raises(EngineClosedError):
        eng.submit(p)


class _PoisonedModel:
    def __init__(self, model, exc):
        self._model = model
        self._exc = exc

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, tokens, cache):
        raise self._exc


def test_worker_crash_surfaces_replica_failed(net):
    eng = _engine(net, max_slots=2, max_new_tokens=6, queue_limit=16)
    boom = RuntimeError("decode exploded")
    eng.model = _PoisonedModel(net, boom)
    rng = onp.random.RandomState(20)
    s = eng.submit(_prompt(rng, 4))
    with pytest.raises(ReplicaFailedError) as ei:
        s.result(timeout=60)
    assert ei.value.cause is boom
    with pytest.raises(ReplicaFailedError):
        eng.submit(_prompt(rng, 4))


PORTED = [
    ("paged", dict(paged=True, page_size=8), "fp32"),
    ("quantize", dict(quantize="int8_weights"), "int8_weights"),
    ("kv_dtype", dict(kv_dtype="int8"), "int8_kv"),
    ("kv_dtype_paged", dict(kv_dtype="int8", paged=True, page_size=8),
     "int8_kv"),
    ("cache_dtype", dict(cache_dtype="int8"), "int8_kv"),
    ("both_int8", dict(kv_dtype="int8", quantize="int8_weights"),
     "int8_weights+int8_kv"),
]


@pytest.mark.parametrize("kw,precision", [p[1:] for p in PORTED],
                         ids=[p[0] for p in PORTED])
def test_ported_modes_serve(kw, precision):
    """Modes the port has build on the CPU and serve a request (on a
    model of their own: an int8 engine arms its model's tables), and
    ``precision`` names them as the reference does."""
    net = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=1,
                         num_heads=4, max_length=128,
                         device="cpu").initialize(seed=3)
    eng = _engine(net, max_slots=2, max_new_tokens=3, **kw)
    r = eng.generate(_prompt(onp.random.RandomState(14), 5), timeout=60)
    assert len(r.tokens) == 3 and r.finish_reason == "length"
    assert eng.paged == bool(kw.get("paged"))
    assert eng.precision == precision
    assert (eng._cache["k"][0].dtype == torch.int8) == (
        "int8_kv" in precision)
    eng.close()


def test_kv_dtype_validation(net):
    """The reference's ValueErrors for a conflicting or unknown KV
    dtype."""
    with pytest.raises(ValueError, match="conflicts"):
        _engine(net, kv_dtype="int8", cache_dtype="float32")
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        _engine(net, kv_dtype="int4")


UNPORTED = [
    ("mesh_layout", dict(mesh_layout="tp"), "20"),
]


@pytest.mark.parametrize("kw,item", [u[1:] for u in UNPORTED],
                         ids=[u[0] for u in UNPORTED])
def test_unported_modes_raise(net, kw, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        _engine(net, **kw)


#: the modes that the refusals above used to name (ROADMAP items 10 and
#: 11): each engine now builds and serves
PORTED_MODES = [
    ("cache_dtype_fp16", dict(cache_dtype="float16"), torch.float16),
    ("lora_rank", dict(lora_rank=4), torch.float32),
]


@pytest.mark.parametrize("kw,cache_dt", [m[1:] for m in PORTED_MODES],
                         ids=[m[0] for m in PORTED_MODES])
def test_formerly_unported_modes_serve(kw, cache_dt):
    eng = GenerationEngine(
        tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=1,
                       num_heads=4, max_length=SMAX,
                       device="cpu").initialize(5),
        max_slots=2, max_length=SMAX, max_new_tokens=3, device="cpu", **kw)
    assert eng._cache["k"][0].dtype == cache_dt
    assert eng.lora == ("rank=4:max=8" if "lora_rank" in kw else "off")
    r = eng.generate(_prompt(onp.random.RandomState(14), 4), timeout=60)
    assert len(r.tokens) == 3
    eng.close()


def test_unported_request_options_raise(net):
    """``adapter=`` on an engine without a LoRA bank is the reference's
    TypeError naming the argument and the engine's capabilities;
    sampling is ported, with the reference's validation."""
    eng = _engine(net, max_slots=2, max_new_tokens=2)
    p = _prompt(onp.random.RandomState(13), 3)
    with pytest.raises(TypeError, match="adapter=.*lora=off"):
        eng.submit(p, adapter="tenant")
    for bad in (dict(temperature=-1.0), dict(temperature=float("nan")),
                dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            eng.submit(p, **bad)
    assert len(eng.generate(p, temperature=0.7, seed=1,
                            timeout=60).tokens) == 2
    # greedy ignores the sampling knobs, as in the reference
    assert len(eng.generate(p, temperature=0.0, top_k=5, seed=3,
                            timeout=60).tokens) == 2
    eng.close()


def test_engine_device_rule(net):
    """The engine defaults to the card and raises without one; a device
    that is not the model's is refused."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GenerationEngine(net, max_slots=2)
    with pytest.raises(ValueError, match="unsupported device"):
        GenerationEngine(net, max_slots=2, device="meta")
    on_card = _SlowModel(net, 0.0)
    on_card.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="lives on"):
        GenerationEngine(on_card, max_slots=2, device="cpu")


# -- per-request sampling ---------------------------------------------
def _sampled(eng, p, seed, **kw):
    return eng.submit(p, temperature=0.9, top_k=20, top_p=0.95, seed=seed,
                      **kw)


def test_sampled_requests_seeded_and_independent_of_co_tenants(net):
    """A sampled request's tokens depend on its seed only: alone, or in
    another slot beside greedy and other sampled co-tenants, the same
    seed gives the same tokens; greedy co-tenants keep their greedy
    tokens; the sampling counter counts sampled requests."""
    rng = onp.random.RandomState(21)
    p, q = _prompt(rng, 6), _prompt(rng, 11)
    eng = _engine(net, max_slots=SLOTS, max_new_tokens=12, queue_limit=64)
    alone = _sampled(eng, p, seed=7).result(timeout=120).tokens
    greedy = eng.generate(q, timeout=120).tokens
    telemetry.reset()
    # busy engine: the seeded request now lands in another slot
    streams = [eng.submit(q), _sampled(eng, q, seed=3), eng.submit(p),
               _sampled(eng, p, seed=7), _sampled(eng, p, seed=8)]
    out = [s.result(timeout=120).tokens for s in streams]
    eng.close()
    assert out[3] == alone
    assert out[0] == greedy
    assert out[4] != alone      # another seed, another stream
    assert telemetry.counter_value("serving.generate.sampling.requests") == 3
    assert eng._n_sampling == 0 and all(g is None for g in eng._gens)


def test_sampling_with_top_k_1_is_greedy(net):
    """top_k=1 leaves one token to draw: the sampled stream equals the
    greedy one, whatever the seed and temperature."""
    p = _prompt(onp.random.RandomState(22), 9)
    eng = _engine(net, max_slots=2, max_new_tokens=8)
    greedy = eng.generate(p, timeout=120).tokens
    for seed, t in ((1, 0.5), (2, 3.0)):
        assert eng.generate(p, temperature=t, top_k=1, seed=seed,
                            timeout=120).tokens == greedy
    eng.close()


# -- weight rollover ----------------------------------------------------
def _fresh_params(seed):
    donor = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                           num_heads=4, max_length=128,
                           device="cpu").initialize(seed=seed)
    return {k: p._read().numpy().copy()
            for k, p in donor.collect_params().items()}


@pytest.mark.parametrize("kw", [{}, dict(quantize="int8_weights",
                                         kv_dtype="int8")],
                         ids=["fp32", "int8_weights_int8_kv"])
def test_load_weights_matches_a_fresh_engine(kw):
    """load_weights swaps the parameters in place (same tensors) under
    the generation lock; a quantized engine re-quantizes inside the swap
    window; the next requests get a fresh engine's tokens on the new
    weights (tests/test_quantized.py's rollover test)."""
    def model(seed):
        return tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=2,
                              num_heads=4, max_length=128,
                              device="cpu").initialize(seed=seed)
    rng = onp.random.RandomState(23)
    prompts = [_prompt(rng, n) for n in (4, 9, 15)]
    net_a = model(0)
    eng = _engine(net_a, max_slots=2, max_new_tokens=6, **kw).warmup()
    before = [eng.generate(p, timeout=120).tokens for p in prompts]
    ptrs = [p._read().data_ptr() for p in net_a.collect_params().values()]
    new = _fresh_params(5)
    telemetry.reset()
    assert eng.load_weights(new) is eng
    after = [eng.generate(p, timeout=120).tokens for p in prompts]
    snap = telemetry.snapshot()
    eng.close()
    assert [p._read().data_ptr()
            for p in net_a.collect_params().values()] == ptrs
    assert snap["counters"]["serving.generate.weight_swaps"] == 1
    assert "serving.generate.swap" in snap["histograms"]
    assert ("serving.generate.quant.requantize" in snap["histograms"]) \
        == ("quantize" in kw)
    fresh = _engine(model(5), max_slots=2, max_new_tokens=6, **kw)
    expect = [fresh.generate(p, timeout=120).tokens for p in prompts]
    fresh.close()
    assert after == expect and after != before


def test_load_weights_validates_before_touching_anything(net):
    eng = _engine(net, max_slots=2, max_new_tokens=2)
    good = {k: p._read().numpy().copy()
            for k, p in net.collect_params().items()}
    snapshot = {k: v.copy() for k, v in good.items()}
    bad_shape = dict(good)
    bad_shape["lm_head.weight"] = onp.zeros((3, 3), "f4")
    bad_shape["layers.0.ln1.gamma"] = onp.full(32, 9.0, "f4")
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.load_weights(bad_shape)
    missing = {k: v for k, v in good.items() if k != "ln_f.beta"}
    with pytest.raises(ValueError, match="missing"):
        eng.load_weights(missing)
    for k, p in net.collect_params().items():
        onp.testing.assert_array_equal(p._read().numpy(), snapshot[k])
    eng.load_weights(missing, strict=False)   # the intersection
    with pytest.raises(NotImplementedError, match="item 18b"):
        eng.load_weights("/some/checkpoint/dir")
    eng.close()
    with pytest.raises(EngineClosedError):
        eng.load_weights(good)
