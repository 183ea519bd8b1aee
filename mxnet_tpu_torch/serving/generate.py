"""GenerationEngine — slot-based continuous batching for greedy
autoregressive decoding (dense KV cache, fp32).

Counterpart of ``mxnet_tpu/serving/generate.py``'s dense greedy engine.
Iteration-level scheduling (Orca, OSDI'22; vLLM's continuous batching)
admits and evicts requests at DECODE-STEP boundaries over a fixed
``max_slots``-row KV cache (``GPTModel.init_cache``): every step of
every mix of requests runs the same shapes, and occupancy changes
rebind slot rows, never shapes — so the cache is allocated once and
updated in place for the engine's whole life.

Architecture::

    caller threads ── submit(prompt) ──► bounded request queue
                                              │ (admission control:
                                              │  queue_limit, timeout,
                                              ▼  closed-engine reject)
                                        generator thread
                     ┌──────────────────────────────────────────────┐
                     │ per step: admit queued prompts into FREE     │
                     │ slots (prefill bucketed on the seq axis via  │
                     │ BucketingPolicy, K/V written into the cache  │
                     │ at the slot row) ── one decode_step over ALL │
                     │ slots ── emit one token per live slot into   │
                     │ its stream ── evict EOS / max-tokens /       │
                     │ capacity / deadline slots                    │
                     └──────────────────────────────────────────────┘

``submit`` returns a :class:`GenerationStream` — a token-stream
future: iterate it to consume tokens as they are generated, or call
``result(timeout)`` for the completed :class:`GenerationResult`.
Admission control and shutdown: ``QueueFullError`` /
``RequestTimeoutError`` / ``EngineClosedError``; ``close()``
drains-then-rejects via the shared ``BoundedQueueWorker``; no stream is
ever left hanging; ``MXTPU_SERVING=0`` degrades to synchronous inline
generation.

Decoding is GREEDY (argmax, taken on the device): a request's tokens do
not depend on its co-tenants, so the output equals a single-request
``prefill`` + ``decode_step`` loop at the same slot width — and, on the
same weights, the JAX package's engine.

The reference engine's other modes — paged KV, int8 weights or KV,
speculative decoding, multi-tick decode, bf16 compute, LoRA, tensor
parallelism, sampling and weight rollover — are later slices of the
port; asking for one raises ``NotImplementedError`` naming its
ROADMAP.md item.

Telemetry: counters ``serving.generate.{requests,tokens,prefills,
evictions,rejected_full,rejected_closed,timeouts,errors,host_syncs,
dispatches}``, gauges ``serving.generate.slots`` /
``serving.generate.queue.depth``, histograms
``serving.generate.{queue_wait,prefill,decode,ttft}``. The ``prefill``
and ``decode`` histograms end at the host's read of the step's tokens,
so on the card they include the device time (PyTorch returns before
the device finishes; the reference's XLA histograms timed the
dispatch).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
import weakref

import numpy as onp
import torch

from .. import telemetry, tracing
from .._bounded_worker import BoundedQueueWorker
from ..base import not_ported
from ..bucketing import BucketingPolicy, as_policy
from ..context import resolve_device
from .engine import (
    EngineClosedError, QueueFullError, ReplicaFailedError,
    RequestTimeoutError, _live_engines, _serving_enabled,
)

__all__ = ["GenerationEngine", "GenerationStream", "GenerationResult"]


class GenerationResult:
    """Completed generation: ``tokens`` (generated ids, prompt
    excluded), ``finish_reason`` in {"eos", "length", "timeout",
    "closed"}, and the ``prompt_len`` it continued from."""

    __slots__ = ("tokens", "finish_reason", "prompt_len")

    def __init__(self, tokens, finish_reason, prompt_len):
        self.tokens = tokens
        self.finish_reason = finish_reason
        self.prompt_len = prompt_len

    def __len__(self):
        return len(self.tokens)

    def __repr__(self):
        return (f"GenerationResult({len(self.tokens)} tokens, "
                f"finish_reason={self.finish_reason!r})")


class GenerationStream:
    """Per-request token-stream future.

    Iterating yields token ids as the engine produces them (multiple
    iterators each see the full stream); ``result(timeout)`` blocks for
    the final :class:`GenerationResult`. A rejected/failed request
    raises the failure from both paths — never a hung consumer."""

    def __init__(self, prompt_len):
        self.prompt_len = prompt_len
        self._cv = threading.Condition()
        self._tokens: list = []
        self._reason = None
        self._exc = None
        #: ``time.perf_counter()`` stamps of the first token and of
        #: completion — producer-side, so latency measurement needs no
        #: consumer thread racing the stream
        self.first_token_at = None
        self.done_at = None
        #: the request's tracing.Trace, or None (tracing off for this
        #: request — the near-zero disabled path)
        self._trace = None

    # -- producer side (generator thread) ------------------------------
    def _emit(self, token: int):
        with self._cv:
            if self._reason is not None or self._exc is not None:
                return  # finished streams take no more tokens
            if not self._tokens:
                self.first_token_at = time.perf_counter()
            self._tokens.append(int(token))
            if self._trace is not None:
                self._trace.event("emit", n=1, total=len(self._tokens))
            self._cv.notify_all()

    def _finish(self, reason=None, exc=None):
        with self._cv:
            if self._reason is not None or self._exc is not None:
                return  # first outcome stands (close racing a finish)
            self._reason = reason
            self._exc = exc
            self.done_at = time.perf_counter()
            if self._trace is not None:
                self._trace.finish(reason=reason, error=exc)
            self._cv.notify_all()

    # -- consumer side --------------------------------------------------
    def done(self) -> bool:
        with self._cv:
            return self._reason is not None or self._exc is not None

    @property
    def trace_id(self):
        """The request's trace id, or None when untraced."""
        return None if self._trace is None else self._trace.trace_id

    def trace(self):
        """The request's recorded spans, or None when untraced."""
        return None if self._trace is None else self._trace.spans()

    @property
    def tokens(self):
        """Snapshot of the tokens generated so far."""
        with self._cv:
            return list(self._tokens)

    def __iter__(self):
        i = 0
        while True:
            with self._cv:
                while i >= len(self._tokens) and self._reason is None \
                        and self._exc is None:
                    self._cv.wait()  # every producer path notifies
                if i < len(self._tokens):
                    tok = self._tokens[i]
                    i += 1
                elif self._exc is not None:
                    raise self._exc
                else:
                    return
            yield tok

    def result(self, timeout=None) -> GenerationResult:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._reason is None and self._exc is None:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise TimeoutError(
                        "generation still running after result() timeout")
                self._cv.wait(rem)
            if self._exc is not None:
                raise self._exc
            return GenerationResult(list(self._tokens), self._reason,
                                    self.prompt_len)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "stream", "t_submit",
                 "t_enq", "deadline")

    def __init__(self, prompt, max_new, eos_id, stream, t_submit, t_enq,
                 deadline):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.stream = stream
        self.t_submit = t_submit
        self.t_enq = t_enq     # monotonic enqueue stamp (queue wait)
        self.deadline = deadline


class _Slot:
    __slots__ = ("stream", "last", "left", "eos_id", "deadline", "n_ctx")

    def __init__(self, stream, last, left, eos_id, deadline, n_ctx):
        self.stream = stream
        self.last = last       # last emitted token (next step's input)
        self.left = left       # generated-token budget remaining
        self.eos_id = eos_id
        self.deadline = deadline
        self.n_ctx = n_ctx     # cache rows filled (prompt + decoded)


class _GenWorker(BoundedQueueWorker):
    """Consumer side of the request queue: the admit/step loop.

    A graceful ``_draining`` phase finishes admitted work; ``stop()``
    is the hard deadline whose drain rejects queued leftovers through
    ``_drained``."""

    def __init__(self, engine: "GenerationEngine", queue_limit: int):
        super().__init__(queue_limit, name="GenerationEngine.worker")
        self._engine = weakref.ref(engine)
        self._draining = False
        self.start()

    def run(self):
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — a failed step must not
            # strand waiters: fail every live stream and queued request
            telemetry.counter("serving.generate.errors")
            eng = self._engine()
            if eng is not None:
                eng._fail_all(e)
            return
        # hard-stopped mid-generation: the worker owns the slots, so it
        # (not close(), racing is_alive) finishes leftover streams
        eng = self._engine()
        if eng is not None and self._stopped:
            eng._close_active("closed")

    def _run(self):
        while not self._stopped:
            eng = self._engine()
            if eng is None:
                return  # abandoned engine: streams die with their refs
            with eng._gen_lock:
                eng._admit(self._queue)
                active = eng._n_active
                if active:
                    eng._step()
            if eng._gen_waiters:
                # fairness: cede one scheduler slice between steps when
                # a warmup/close caller waits on _gen_lock
                time.sleep(0.0005)
            if active:
                continue
            del eng  # don't pin the engine while blocking on the queue
            try:
                r = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._draining:
                    return
                continue
            eng = self._engine()
            if eng is None:
                r.stream._finish(exc=EngineClosedError(
                    "engine was garbage-collected"))
                return
            with eng._gen_lock:
                eng._admit_one(r)

    def _drained(self, item):
        if isinstance(item, _GenRequest):
            telemetry.counter("serving.generate.rejected_closed")
            item.stream._finish(exc=EngineClosedError(
                "engine closed before the request was scheduled"))

    def close(self, timeout: float):
        self._draining = True
        self.join(timeout=max(0.0, timeout))
        self.stop(timeout=min(timeout, 2.0) if timeout > 0 else 0.1)


class GenerationEngine:
    """Continuously-batched greedy generation over a decoder model.

    Parameters
    ----------
    model
        A decoder exposing the explicit-cache generation API —
        ``init_cache(batch_size, max_length, dtype)`` /
        ``prefill(tokens, valid_length, cache, slots)`` /
        ``decode_step(tokens, cache)`` (``gluon.model_zoo.gpt.GPTModel``).
    max_slots : int
        Concurrent sequences per decode step — the fixed batch width of
        the decode step and the KV-cache row count.
    max_length : int, optional
        Cache sequence capacity (default: the model's position table).
        A prompt must leave room for at least one generated token.
    max_new_tokens : int
        Default generated-token budget per request (``submit``
        overrides per call).
    eos_id : int, optional
        Default stop token (``submit`` overrides per call).
    queue_limit : int
        Bound on queued requests; beyond it ``submit`` raises
        :class:`QueueFullError` immediately (load shedding).
    timeout_ms : float, optional
        Default deadline: a request still QUEUED past it is rejected
        with :class:`RequestTimeoutError`; one already generating is
        finished early with ``finish_reason="timeout"``.
    prefill_bucketing : BucketingPolicy | str | None
        Sequence-axis policy for prefill (default pow2, min 8, clamped
        to the cache capacity).
    device : str | torch.device, optional
        Where the engine runs: the CUDA card by default (raises without
        one); ``"cpu"`` only when asked for. Must be the model's device.

    The reference's other keyword arguments (``paged``, ``quantize``,
    ``kv_dtype``, ``draft_model``, ``decode_ticks > 1``,
    ``compute_dtype="bfloat16"``, ``lora_rank``, ``mesh_layout``, a
    non-fp32 ``cache_dtype``) raise ``NotImplementedError``.
    """

    def __init__(self, model, max_slots: int = 8, max_length=None,
                 max_new_tokens: int = 64, eos_id=None,
                 queue_limit: int = 256, timeout_ms=None,
                 prefill_bucketing=None, cache_dtype=None,
                 paged: bool = False, quantize=None, kv_dtype=None,
                 draft_model=None, speculative=None, mesh_layout=None,
                 lora_rank=None, decode_ticks: int = 1,
                 compute_dtype=None, device=None):
        if paged:
            raise not_ported("paged=True", "7 (paged engine)")
        if quantize is not None or kv_dtype is not None:
            raise not_ported(f"quantize={quantize!r} / "
                             f"kv_dtype={kv_dtype!r}", "8 (int8)")
        if cache_dtype is not None and str(cache_dtype) != "float32":
            raise not_ported(f"cache_dtype={cache_dtype!r}",
                             "8 (int8) / 10 (bf16)")
        if draft_model is not None or speculative:
            raise not_ported("speculative decoding (draft_model=)",
                             "9 (speculative decoding)")
        if int(decode_ticks) != 1:
            raise not_ported(f"decode_ticks={decode_ticks}",
                             "10 (multi-tick decode and bf16)")
        if compute_dtype not in (None, "float32"):
            raise not_ported(f"compute_dtype={compute_dtype!r}",
                             "10 (multi-tick decode and bf16)")
        if lora_rank is not None:
            raise not_ported("lora_rank=", "11 (batched LoRA)")
        if mesh_layout is not None:
            raise not_ported(f"mesh_layout={mesh_layout!r}",
                             "20 (parallelism over torch.distributed)")
        dev = resolve_device(device)
        for attr in ("init_cache", "prefill", "decode_step"):
            if not callable(getattr(model, attr, None)):
                raise TypeError(
                    f"GenerationEngine needs a decoder with the "
                    f"explicit-cache generation API (missing {attr!r}); "
                    f"see gluon.model_zoo.gpt.GPTModel")
        model_dev = getattr(model, "device", dev)
        if torch.device(model_dev) != dev:
            raise ValueError(f"the model lives on {model_dev}, the engine "
                             f"was asked to run on {dev}")
        if int(max_slots) < 1:
            raise ValueError("max_slots must be >= 1")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.device = dev
        self.model = model
        self.max_slots = int(max_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.queue_limit = max(1, int(queue_limit))
        self.timeout_ms = timeout_ms
        self._s_max = int(max_length) if max_length is not None \
            else int(model.max_length)
        #: usable sequence capacity (the speculative verify margin of
        #: the reference does not apply to this engine)
        self._s_cap = self._s_max
        if self._s_cap < 2:
            raise ValueError(
                f"max_length {self._s_max} leaves no usable capacity")
        policy = as_policy(prefill_bucketing)
        if policy is None:
            policy = BucketingPolicy(mode="pow2", min_size=8)
        self.policy = policy.clamped(self._s_max)
        self._cache = model.init_cache(self.max_slots, self._s_max)
        self._slots: list = [None] * self.max_slots
        self._n_active = 0
        #: serializes every model call (worker admit/step, sync-mode
        #: generation, warmup): the cache is updated in place
        self._gen_lock = threading.Lock()
        #: threads waiting on _gen_lock via _gen_exclusive — the
        #: worker's step loop yields between steps when non-zero
        self._gen_waiters = 0
        self._lock = threading.Lock()
        self._closed = False
        #: set (to a ReplicaFailedError) when the generator thread died
        #: from an unexpected error — a broken replica, not a close()
        self._failure: ReplicaFailedError | None = None
        self._sync = not _serving_enabled()
        self._worker = None if self._sync \
            else _GenWorker(self, self.queue_limit)
        _live_engines.add(self)

    # -- lifecycle -----------------------------------------------------
    @contextlib.contextmanager
    def _gen_exclusive(self):
        """Acquire ``_gen_lock`` as a registered waiter (the worker's
        step loop re-acquires the lock back to back, and Python lock
        handoff is unfair)."""
        with self._lock:
            self._gen_waiters += 1
        try:
            with self._gen_lock:
                yield
        finally:
            with self._lock:
                self._gen_waiters -= 1

    def warmup(self):
        """Run every shape the steady state will see once ahead of
        traffic — one prefill per sequence bucket the policy can
        produce, plus the decode step — against a THROWAWAY cache of the
        live cache's shape. On the card the first call also builds the
        CUDA kernels, so no request pays for that."""
        with self._gen_exclusive():
            if self._closed:
                return self
            cache = self.model.init_cache(self.max_slots, self._s_max)
            for sb in self.policy.sizes(self._s_cap - 1):
                _, cache = self.model.prefill(onp.zeros((1, sb), "i4"),
                                              [sb], cache, slots=[0])
            lg, cache = self.model.decode_step(
                onp.zeros((self.max_slots,), "i4"), cache)
            lg.argmax(dim=-1).cpu()
            del cache
            self._warmup_telemetry()
        return self

    def _warmup_telemetry(self):
        """The measured bytes of parameters + live cache on the device
        (``serving.generate.per_device_bytes``)."""
        tensors = list(self.model.parameters()) if callable(
            getattr(self.model, "parameters", None)) else []
        tensors += [*self._cache["k"], *self._cache["v"], self._cache["len"]]
        telemetry.gauge("serving.generate.per_device_bytes",
                        sum(t.numel() * t.element_size() for t in tensors))

    def close(self, timeout: float = 5.0):
        """Stop admission, finish ACTIVE generations and drain the
        queue under ``timeout``; past the deadline queued requests are
        rejected and still-active streams are finished early with
        ``finish_reason="closed"`` — nothing ever hangs. Idempotent;
        also invoked via ``atexit``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._worker is not None:
            self._worker.close(timeout)
            if not self._worker.is_alive():
                # thread provably dead: it can no longer touch slots
                self._close_active("closed")
        else:
            self._close_active("closed")  # sync mode: nothing active
        _live_engines.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close(timeout=0.5)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    @property
    def closed(self) -> bool:
        return self._closed

    # -- admission -----------------------------------------------------
    def _validate(self, prompt, max_new_tokens, eos_id):
        prompt = onp.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(
                f"prompt must be a non-empty 1-D token sequence, got "
                f"shape {prompt.shape}")
        if not onp.issubdtype(prompt.dtype, onp.integer):
            raise ValueError(f"prompt must hold token ids, got dtype "
                             f"{prompt.dtype}")
        if prompt.size > self._s_cap - 1:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate (cache capacity {self._s_max})")
        max_new = self.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos = self.eos_id if eos_id is None else eos_id
        return prompt.astype("i4"), max_new, eos

    @staticmethod
    def _validate_sampling(temperature, top_k, top_p, seed):
        """Validate the per-request sampling knobs as the reference does;
        only greedy (``temperature`` absent or 0, where ``top_k`` /
        ``top_p`` / ``seed`` are ignored) is ported."""
        t = 0.0 if temperature is None else float(temperature)
        if not t >= 0.0:   # also rejects NaN
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{temperature!r}")
        k = 0 if top_k is None else int(top_k)
        if k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got "
                             f"{top_k!r}")
        p = 1.0 if top_p is None else float(top_p)
        if not 0.0 < p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1] (1 = off), got {top_p!r}")
        if t > 0:
            raise not_ported("sampling (temperature > 0)",
                             "6 (ops/sampling.py)")

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               timeout_ms=None, temperature=None, top_k=None, top_p=None,
               seed=None, adapter=None, trace=None) -> GenerationStream:
        """Queue one prompt; returns a :class:`GenerationStream`.
        Raises :class:`EngineClosedError` / :class:`QueueFullError` /
        ``ValueError`` immediately instead of returning a stream that
        can never complete. ``trace`` arms per-request tracing
        (``True``/``False``/``None`` = the module flag, or a
        ``tracing.Trace`` to thread through)."""
        if self._failure is not None:
            telemetry.counter("serving.generate.rejected_closed")
            raise ReplicaFailedError(str(self._failure),
                                     cause=self._failure.cause)
        if self._closed:
            telemetry.counter("serving.generate.rejected_closed")
            raise EngineClosedError("submit on a closed engine")
        prompt, max_new, eos = self._validate(prompt, max_new_tokens,
                                              eos_id)
        self._validate_sampling(temperature, top_k, top_p, seed)
        if adapter is not None:
            raise not_ported("adapter=", "11 (batched LoRA)")
        telemetry.counter("serving.generate.requests")
        stream = GenerationStream(int(prompt.size))
        tr = tracing.start_trace(trace)
        if tr is not None:
            stream._trace = tr
            tr.event("submit", prompt_len=int(prompt.size),
                     max_new=max_new)
        tmo = self.timeout_ms if timeout_ms is None else timeout_ms
        now = time.monotonic()
        req = _GenRequest(prompt, max_new, eos, stream, telemetry.clock(),
                          now, now + tmo / 1e3 if tmo is not None else None)
        if self._sync:  # MXTPU_SERVING=0: inline generation
            with self._gen_lock:
                self._admit_one(req)
                while self._n_active:
                    self._step()
            return stream
        try:
            self._worker._queue.put_nowait(req)
        except queue.Full:
            telemetry.counter("serving.generate.rejected_full")
            raise QueueFullError(
                f"request queue at queue_limit={self.queue_limit}") \
                from None
        telemetry.gauge("serving.generate.queue.depth",
                        self._worker._queue.qsize())
        if self._failure is not None:
            # the worker died while the request was being queued: its
            # drain may have missed this request — fail it ourselves
            stream._finish(exc=ReplicaFailedError(
                str(self._failure), cause=self._failure.cause))
        elif self._closed:
            # close() raced the put: its drain may have missed this
            # request — reject it ourselves (no-op if already handled)
            stream._finish(exc=EngineClosedError(
                "engine closed while the request was being queued"))
        return stream

    def generate(self, prompt, timeout=None, **kwargs) -> GenerationResult:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(prompt, **kwargs).result(timeout)

    # -- scheduling (generator thread / sync mode) ---------------------
    def _admit(self, q):
        while self._n_active < self.max_slots:
            try:
                r = q.get_nowait()
            except queue.Empty:
                break
            self._admit_one(r)
        telemetry.gauge("serving.generate.queue.depth", q.qsize())

    def _admit_one(self, r: _GenRequest):
        """Admit ``r`` into a free slot, prefill it and emit its first
        token. Called only at step boundaries."""
        waited_ms = (time.monotonic() - r.t_enq) * 1e3
        if r.deadline is not None and time.monotonic() > r.deadline:
            telemetry.hist("serving.generate.queue_wait", waited_ms)
            telemetry.counter("serving.generate.timeouts")
            r.stream._finish(exc=RequestTimeoutError(
                f"request expired in queue before prefill (waited "
                f"{waited_ms:.1f} ms)"))
            return
        try:
            self._admit_one_inner(r, waited_ms)
        except Exception as e:  # noqa: BLE001 — the worker is about to
            # die (_fail_all); without this the IN-HAND request —
            # already popped from the queue, not yet in a slot — would
            # be invisible to the cleanup and hang its caller forever
            r.stream._finish(exc=ReplicaFailedError(
                f"admission failed: {type(e).__name__}: {e}", cause=e))
            raise

    def _admit_one_inner(self, r: _GenRequest, waited_ms):
        telemetry.hist("serving.generate.queue_wait", waited_ms)
        tr = r.stream._trace
        if tr is not None:
            tr.add_ms("queue", waited_ms)
        slot = self._slots.index(None)
        n = int(r.prompt.size)
        if tr is not None:
            tr.event("admission", slot=slot, mode="dense")
        tracing.flight.record("gen.admit", slot=slot, mode="dense",
                              trace_id=r.stream.trace_id)
        sb = self.policy.bucket(n)
        padded = onp.zeros((1, sb), "i4")
        padded[0, :n] = r.prompt
        pt0 = time.perf_counter() if tr is not None else 0.0
        t0 = telemetry.clock()
        logits, self._cache = self.model.prefill(
            padded, onp.asarray([n], "i4"), self._cache,
            slots=onp.asarray([slot], "i4"))
        tok = int(logits[0].argmax())   # the host sync of this admission
        telemetry.hist_since("serving.generate.prefill", t0)
        telemetry.counter("serving.generate.prefills")
        if tr is not None:
            tr.add("prefill", pt0, slot=slot, tokens=n)
        s = _Slot(r.stream, tok, r.max_new - 1, r.eos_id, r.deadline,
                  n_ctx=n)
        self._slots[slot] = s
        self._n_active += 1
        r.stream._emit(tok)
        telemetry.counter("serving.generate.tokens")
        telemetry.hist_since("serving.generate.ttft", r.t_submit)
        if s.eos_id is not None and tok == s.eos_id:
            self._evict(slot, "eos")
        elif s.left <= 0 or s.n_ctx >= self._s_cap:
            self._evict(slot, "length")
        else:
            telemetry.gauge("serving.generate.slots", self._n_active)

    def _step(self):
        """One engine iteration: one decode step over ALL slots (free
        rows ride along in the fixed-shape batch), the argmax of every
        row taken on the device and the (B,) tokens brought to the host
        — the step's one sync — then one token per live slot and the
        eviction ladder: eos first, then budget/capacity, then
        deadline. Freed rows admit the next prompts mid-sequence."""
        idxs = [i for i, s in enumerate(self._slots) if s is not None]
        if not idxs:
            return
        toks = onp.zeros((self.max_slots,), "i4")
        any_trace = False
        for i in idxs:
            s = self._slots[i]
            toks[i] = s.last
            if s.stream._trace is not None:
                any_trace = True
        tt0 = time.perf_counter() if any_trace else 0.0
        t0 = telemetry.clock()
        logits, self._cache = self.model.decode_step(toks, self._cache)
        step_toks = logits.argmax(dim=-1).cpu().numpy()
        telemetry.hist_since("serving.generate.decode", t0)
        telemetry.counter("serving.generate.host_syncs")
        telemetry.counter("serving.generate.dispatches")
        now = time.monotonic()
        for i in idxs:
            s = self._slots[i]
            tok = int(step_toks[i])
            if s.stream._trace is not None:
                s.stream._trace.add("decode", tt0, slot=i, token=tok)
            s.stream._emit(tok)
            s.last = tok
            s.left -= 1
            s.n_ctx += 1
            if s.eos_id is not None and tok == s.eos_id:
                self._evict(i, "eos")
            elif s.left <= 0 or s.n_ctx >= self._s_cap:
                self._evict(i, "length")
            elif s.deadline is not None and now > s.deadline:
                telemetry.counter("serving.generate.timeouts")
                self._evict(i, "timeout")
        telemetry.counter("serving.generate.tokens", len(idxs))
        telemetry.gauge("serving.generate.slots", self._n_active)

    def _free_slot(self, slot: int):
        self._slots[slot] = None
        self._n_active -= 1
        telemetry.counter("serving.generate.evictions")
        telemetry.gauge("serving.generate.slots", self._n_active)

    def _evict(self, slot: int, reason: str):
        s = self._slots[slot]
        if s.stream._trace is not None:
            s.stream._trace.event("evict", slot=slot, reason=reason)
        tracing.flight.record("gen.evict", slot=slot, reason=reason,
                              trace_id=s.stream.trace_id)
        s.stream._finish(reason=reason)
        self._free_slot(slot)

    def _close_active(self, reason: str):
        """Finish every still-active stream with ``reason`` (a first
        outcome stands) and free the slots."""
        for i, s in enumerate(self._slots):
            if s is not None:
                s.stream._finish(reason=reason)
                self._slots[i] = None
        self._n_active = 0

    def _fail_all(self, exc):
        """Worker crashed mid-step: fail every live stream and queued
        request with a :class:`ReplicaFailedError` — retryable replica
        death, NOT a deliberate close — and close the engine."""
        failure = exc if isinstance(exc, ReplicaFailedError) \
            else ReplicaFailedError(
                f"generation worker died: {type(exc).__name__}: {exc}",
                cause=exc)
        if not isinstance(exc, ReplicaFailedError):
            failure.__cause__ = exc
        self._failure = failure
        self._closed = True
        tracing.flight.dump("engine.fail_all",
                            error=f"{type(exc).__name__}: {exc}")
        for i, s in enumerate(self._slots):
            if s is not None:
                s.stream._finish(exc=failure)
                self._slots[i] = None
        self._n_active = 0
        if self._worker is not None:
            self._worker._stopped = True
            try:
                while True:
                    r = self._worker._queue.get_nowait()
                    r.stream._finish(exc=failure)
            except queue.Empty:
                pass
        _live_engines.discard(self)
