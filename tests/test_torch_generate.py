"""The port's GenerationEngine (mxnet_tpu_torch.serving) on the CPU.

Greedy output must be TOKEN-IDENTICAL to the JAX package's engine on
the same weights; eviction (eos, length, capacity, deadline), admission
control and shutdown follow the reference engine's contract; modes this
slice does not port raise NotImplementedError naming their ROADMAP.md
item.
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
    ("paged", dict(paged=True, page_size=8)),
    ("quantize", dict(quantize="int8_weights")),
]


@pytest.mark.parametrize("kw", [p[1] for p in PORTED],
                         ids=[p[0] for p in PORTED])
def test_ported_modes_serve(kw):
    """Modes this slice ports build on the CPU and serve a request (on a
    model of their own: an int8 engine arms its model's tables)."""
    net = tgpt.gpt_small(vocab_size=VOCAB, units=32, num_layers=1,
                         num_heads=4, max_length=128,
                         device="cpu").initialize(seed=3)
    eng = _engine(net, max_slots=2, max_new_tokens=3, **kw)
    r = eng.generate(_prompt(onp.random.RandomState(14), 5), timeout=60)
    assert len(r.tokens) == 3 and r.finish_reason == "length"
    assert eng.paged == bool(kw.get("paged"))
    assert eng.precision == kw.get("quantize", "fp32")
    eng.close()


UNPORTED = [
    ("kv_dtype", dict(kv_dtype="int8"), "8"),
    ("kv_dtype_paged", dict(kv_dtype="int8", paged=True), "8"),
    ("cache_dtype", dict(cache_dtype="int8"), "8"),
    ("draft_model", dict(draft_model=object()), "9"),
    ("decode_ticks", dict(decode_ticks=4), "10"),
    ("compute_dtype", dict(compute_dtype="bfloat16"), "10"),
    ("lora_rank", dict(lora_rank=4), "11"),
    ("mesh_layout", dict(mesh_layout="tp"), "20"),
]


@pytest.mark.parametrize("kw,item", [u[1:] for u in UNPORTED],
                         ids=[u[0] for u in UNPORTED])
def test_unported_modes_raise(net, kw, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        _engine(net, **kw)


def test_unported_request_options_raise(net):
    eng = _engine(net, max_slots=2, max_new_tokens=2)
    p = _prompt(onp.random.RandomState(13), 3)
    with pytest.raises(NotImplementedError, match="item 6"):
        eng.submit(p, temperature=0.7)
    with pytest.raises(NotImplementedError, match="item 11"):
        eng.submit(p, adapter="tenant")
    with pytest.raises(ValueError, match="temperature"):
        eng.submit(p, temperature=-1.0)
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
