"""GenerationEngine — slot-based continuous batching for autoregressive
decoding, greedy or sampled per request, over a dense or a paged KV
cache (fp32, bf16, float16 or int8), with fp32, bf16 or weight-only int8
projections, one or k decode steps per host sync, and batched
multi-tenant LoRA adapters.

Counterpart of ``mxnet_tpu/serving/generate.py``'s single-step engine.
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

Decoding is GREEDY by default (argmax, taken on the device): a
request's tokens do not depend on its co-tenants, so the output equals
a single-request ``prefill`` + ``decode_step`` loop at the same slot
width — and, on the same weights, the JAX package's engine.
``submit(temperature>0, top_k, top_p, seed)`` samples that request
instead (``ops/sampling.py``) with a ``torch.Generator`` of its own,
seeded from ``seed``: a mixed greedy and sampled batch runs the same
step, greedy rows keep their argmax, and a sampled request's tokens
depend on its seed only, never on its co-tenants or its slot.

``paged=True`` serves from a page pool (``GPTModel.init_paged_cache``,
host bookkeeping in ``serving/paging.py``): a request's pages are
reserved at admission for its worst case, the longest cached prefix is
shared (refcounted pages of the prefix index), a prompt that is cached
whole skips prefill and peeks its first token off the pool, the shared
partial tail page is copied before the first decode write into it
(copy-on-write), long or prefix-sharing prompts prefill in chunks — at
most ONE chunk per engine iteration, interleaved with the decode step —
and a request the pool cannot cover waits, FIFO, until pages free up.
``quantize="int8_weights"`` (dense or paged) arms the model's
weight-only int8 projections (``GPTModel.quantize_params``);
``kv_dtype="int8"`` (alias ``cache_dtype="int8"``, dense or paged)
keeps the KV cache as int8 with per-head scales (per slot, or per page)
and decodes through the int8 instances of the decode kernels.
``compute_dtype="bfloat16"`` arms the model's bf16 compute
(``GPTModel.cast_compute_params``: bf16 copies of the fp32 masters,
fp32 statistics and logits) and defaults the KV cache to bf16; it
composes with ``kv_dtype="int8"`` and ``quantize="int8_weights"``.
``decode_ticks=k`` runs k decode steps per engine tick
(``GPTModel.decode_multi``): eos and budget stops happen on the device,
and the tick's (B, k) tokens and their emission mask reach the host in
one sync; greedy output is the same as at k = 1, seeded sampled streams
too, and deadlines and evictions act once per tick.
``draft_model=`` (with ``spec_k``, default 4) serves by speculative
decoding (docs/SERVING.md "Speculative decoding & sampling"): each
iteration the draft proposes ``spec_k`` tokens per decoding slot
(``propose_tokens``: k chained decode steps of the draft over its own
dense fp32 cache), the target verifies all ``spec_k + 1`` positions and
applies the accept rule in one call (``verify_commit[_paged]``), the
commit block reaches the host in the iteration's one sync, and the
draft rolls back to the accept point (``advance_len``). Greedy slots
commit exactly the tokens the non-speculative engine would; sampled
slots commit draws from the warped target distribution. Each cache row
keeps a ``spec_k`` scratch margin (usable capacity ``max_length -
spec_k``). It composes with the paged cache, int8 weights, the int8 KV
cache and bf16 target compute (the draft stays fp32).
``load_weights`` swaps the model's weights in place between steps
(re-quantizing an int8 engine's tables and re-casting a bf16 engine's
copies inside the swap); a speculative engine's draft keeps its own.
``cache_dtype="float16"`` keeps a float16 KV cache (dense or paged,
read by the float16 instances of the decode kernels), and an engine over
a float16 model (``GPTModel(dtype="float16")``) defaults its cache to
float16; ``compute_dtype="float16"`` is the reference's ValueError.
``lora_rank=`` (with ``max_adapters``, default 8) serves batched
multi-tenant LoRA (docs/SERVING.md "Multi-tenant LoRA"): the model's
stacked adapter banks (``GPTModel.arm_lora``) hold ``max_adapters``
tenants beside the reserved base slot 0; ``load_adapter`` /
``unload_adapter`` install and free them at a step boundary, writing the
banks in place; ``submit(adapter=name)`` pins a tenant for the request's
life (an unload while it runs is deferred) and every generation call
takes the per-slot bank index vector. Prefix reuse is base-model only:
an adapted request neither matches nor publishes cached pages, since its
K/V differ. A speculative engine proposes with the base draft and
verifies adapted, so its greedy tenants' streams equal dedicated
non-speculative adapted engines'.

The reference engine's other modes — tensor parallelism and weight
rollover from a checkpoint path — are later slices of the port; asking
for one raises ``NotImplementedError`` naming its ROADMAP.md item.

Telemetry: counters ``serving.generate.{requests,tokens,prefills,
evictions,rejected_full,rejected_closed,timeouts,errors,host_syncs,
dispatches,weight_swaps,sampling.requests}`` (one host sync and one
dispatch per decode tick, whatever k; three dispatches per speculative
iteration), the gauge ``serving.generate.ticks_per_sync`` (k, or
``spec_k + 1``), with a draft ``serving.generate.spec.{proposed,
accepted,rejected}`` and the gauges ``serving.generate.spec.
{accept_rate,tokens_per_step}``, in paged mode
``serving.generate.{prefix_hits,prefill_chunks}`` and
``serving.generate.pages.{allocated,shared,cow_copies,freed}``, with
``quantize`` ``serving.generate.quant.{params,bytes_saved}``; gauges
``serving.generate.slots`` / ``serving.generate.queue.depth``, with an
int8 KV cache ``serving.generate.quant.kv_bytes_per_slot``, in paged
mode ``serving.generate.pages.free`` and
``serving.generate.prefill_chunks_per_iter``; histograms
``serving.generate.{queue_wait,prefill,decode,ttft,swap}`` and
``serving.generate.quant.{quantize,requantize}`` and
``serving.generate.cast.{cast,recast}``, with LoRA
``serving.generate.lora.{adapters_loaded,adapters_evicted,requests}``,
the gauge ``serving.generate.lora.active_adapters`` and the histogram
``serving.generate.lora.load``. The ``prefill``
and ``decode`` histograms end at the host's read of the step's tokens,
so on the card they include the device time (PyTorch returns before
the device finishes; the reference's XLA histograms timed the
dispatch).
"""
from __future__ import annotations

import collections
import contextlib
import os
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
from ..ops import sampling as _smp
from . import paging
from .engine import (
    EngineClosedError, QueueFullError, ReplicaFailedError,
    RequestTimeoutError, _live_engines, _serving_enabled,
)

__all__ = ["GenerationEngine", "GenerationStream", "GenerationResult"]


def _swap_param_buffers(params, new_params, strict=True):
    """Write ``new_params`` (``{name: array}``) into the live
    parameters ``params`` in place. Everything is checked first — name
    coverage under ``strict`` (``strict=False`` swaps the intersection)
    and every shape — so a bad source never leaves a model
    half-swapped. Returns the number of parameters written."""
    missing = [n for n in params if n not in new_params]
    unexpected = [n for n in new_params if n not in params]
    if strict and (missing or unexpected):
        raise ValueError(f"weights do not match the model: "
                         f"missing={missing[:4]} unexpected={unexpected[:4]}")
    plan = []
    for name, p in params.items():
        if name not in new_params:
            continue
        arr = new_params[name]
        shape = tuple(arr.shape) if hasattr(arr, "shape") \
            else onp.shape(arr)
        if shape != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: model "
                             f"{tuple(p.shape)}, given {shape}")
        plan.append((p, arr))
    for p, arr in plan:
        p.set_data(arr if torch.is_tensor(arr) or hasattr(arr, "_data")
                   else onp.asarray(arr))
    return len(plan)


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
        #: called once, with the stream lock held, when the stream
        #: finishes (an adapted request's pin drops there)
        self._finish_cbs: list = []

    # -- producer side (generator thread) ------------------------------
    def _emit(self, token: int):
        self._emit_many((token,))

    def _emit_many(self, tokens):
        """Append a sequence of tokens (a multi-tick block) under one
        lock and one wakeup."""
        if not tokens:
            return
        with self._cv:
            if self._reason is not None or self._exc is not None:
                return  # finished streams take no more tokens
            if not self._tokens:
                self.first_token_at = time.perf_counter()
            self._tokens.extend(int(t) for t in tokens)
            if self._trace is not None:
                self._trace.event("emit", n=len(tokens),
                                  total=len(self._tokens))
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
            for cb in self._finish_cbs:
                cb()

    def _on_finish(self, cb):
        """Call ``cb()`` once when the stream finishes (now, if it has):
        every stream finishes exactly once on every engine path, so this
        is the one place a per-request resource is reliably released.
        ``cb`` runs under the stream lock and must be quick."""
        with self._cv:
            if self._reason is None and self._exc is None:
                self._finish_cbs.append(cb)
                return
        cb()

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


class _Adapter:
    """Host-side registry record of one loaded LoRA adapter: its bank
    slot, the number of requests pinning it (submitted and not yet
    finished), and whether an unload is deferred behind those pins."""

    __slots__ = ("name", "idx", "refs", "unloading")

    def __init__(self, name, idx):
        self.name = name
        self.idx = idx
        self.refs = 0
        self.unloading = False


class _GenRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "stream", "t_submit",
                 "t_enq", "deadline", "sampling", "adapter_idx")

    def __init__(self, prompt, max_new, eos_id, stream, t_submit, t_enq,
                 deadline, sampling=(0.0, 0, 1.0, None), adapter_idx=0):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.stream = stream
        self.t_submit = t_submit
        self.t_enq = t_enq     # monotonic enqueue stamp (queue wait)
        self.deadline = deadline
        #: (temperature, top_k, top_p, seed); temperature 0 is greedy
        self.sampling = sampling
        #: the request's LoRA bank slot (0: the base model)
        self.adapter_idx = adapter_idx


class _Slot:
    __slots__ = ("stream", "last", "left", "eos_id", "deadline", "n_ctx")

    def __init__(self, stream, last, left, eos_id, deadline, n_ctx):
        self.stream = stream
        self.last = last       # last emitted token (next step's input)
        self.left = left       # generated-token budget remaining
        self.eos_id = eos_id
        self.deadline = deadline
        self.n_ctx = n_ctx     # cache rows filled (prompt + decoded)


class _PagedSlot:
    """Slot state in paged mode. ``state`` is "prefill" (chunks still
    pending — the slot sits out decode steps) or "decode". ``row`` is
    the host mirror of the slot's page-table row (physical page per
    logical page index; scrap 0 past its reservation); ``page_refs``
    are the pool references the slot holds (released at eviction);
    ``cow_pending`` is ``(src, dst, logical_idx)`` when the slot's next
    decode write would land in a SHARED page — the divergence page is
    copied to ``dst`` right before that first write (copy-on-write)."""

    __slots__ = ("stream", "last", "left", "eos_id", "deadline", "n_ctx",
                 "state", "chunks", "row", "page_refs", "cow_pending",
                 "prompt", "seq", "t_submit", "sampling", "draft_prompt",
                 "adapter_idx")

    def __init__(self, stream, left, eos_id, deadline, n_ctx, row,
                 page_refs, prompt, seq, t_submit, sampling, adapter_idx=0):
        self.stream = stream
        self.last = None
        self.left = left
        self.eos_id = eos_id
        self.deadline = deadline
        self.n_ctx = n_ctx
        self.state = "prefill"
        self.chunks = collections.deque()
        self.row = row
        self.page_refs = page_refs
        self.cow_pending = None
        self.prompt = prompt   # kept until registered in the index
        self.seq = seq         # admission order (oldest prefills first)
        self.t_submit = t_submit
        #: the request's sampling knobs, armed when it enters decode
        self.sampling = sampling
        #: a speculative engine's prompt for the draft's dense prefill
        #: when the slot enters decode (``prompt`` is dropped once the
        #: prefix index holds it)
        self.draft_prompt = None
        #: the request's LoRA bank slot: an adapted slot (non-zero)
        #: never matches nor publishes prefix pages
        self.adapter_idx = adapter_idx


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
    """Continuously-batched generation over a decoder model.

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

    paged : bool
        Serve from a page pool with prefix sharing, copy-on-write and
        chunked prefill instead of a dense cache.
    page_size, n_pages, prefill_chunk, prefix_cache
        Paged mode: tokens per page (a power of two dividing
        ``max_length``), pool pages (default ``max_slots * P_max + 1``:
        the dense cache's bytes plus the scrap page), prefill chunk
        width (default ``min(max_length, max(32, 2 * page_size))``) and
        whether prompts are published to the prefix index.
    quantize : str, optional
        ``"int8_weights"`` arms the model's weight-only int8
        projections (``quantize_params``) for every generation call.
    kv_dtype : str, optional
        ``"int8"`` keeps the KV cache (dense or paged) as int8 with
        fp32 per-head scales; ``cache_dtype="int8"`` is the same.
    cache_dtype : str, optional
        The KV cache's type: ``"float32"``, ``"bfloat16"``,
        ``"float16"`` or ``"int8"`` (default: the compute type's under
        ``compute_dtype="bfloat16"``, else the model's parameter type).
    decode_ticks : int
        Decode steps per engine tick and host sync (default 1).
    compute_dtype : str, optional
        ``"bfloat16"`` runs the generation calls on bf16 copies of the
        fp32 master weights (``cast_compute_params``); ``"float32"`` or
        None leaves them as they are.
    draft_model
        Enables speculative decoding: a smaller decoder with the same
        vocabulary and the dense explicit-cache API (``init_cache``,
        ``prefill``, ``propose_tokens``, ``advance_len``) on the same
        device, with a dense fp32 cache of its own.
    spec_k : int
        Draft tokens per slot per iteration (default 4); each cache row
        reserves ``spec_k`` rows at its top for the verify's writes.
    speculative : bool, optional
        Defaults to ``draft_model is not None``; ``True`` without a
        draft raises, as does a draft with ``False``.
    lora_rank : int, optional
        Arms batched multi-tenant LoRA at this rank: the model grows a
        stacked adapter bank per attention projection
        (``GPTModel.arm_lora``) before warm-up.
    max_adapters : int, optional
        Tenants the bank holds beside the reserved base slot (default
        8); only with ``lora_rank``.

    The reference's ``mesh_layout`` raises ``NotImplementedError``.
    """

    def __init__(self, model, max_slots: int = 8, max_length=None,
                 max_new_tokens: int = 64, eos_id=None,
                 queue_limit: int = 256, timeout_ms=None,
                 prefill_bucketing=None, cache_dtype=None,
                 paged: bool = False, page_size: int = 16, n_pages=None,
                 prefill_chunk=None, prefix_cache: bool = True,
                 quantize=None, kv_dtype=None, draft_model=None,
                 spec_k: int = 4, speculative=None, mesh_layout=None,
                 lora_rank=None, max_adapters=None, decode_ticks: int = 1,
                 compute_dtype=None, device=None):
        if speculative is None:
            speculative = draft_model is not None
        self.speculative = bool(speculative)
        if self.speculative and draft_model is None:
            raise ValueError(
                "speculative=True needs a draft_model (a second, smaller "
                "decoder from the same model_zoo family)")
        if draft_model is not None and not self.speculative:
            raise ValueError(
                "draft_model without speculative decoding is inert; drop "
                "it or pass speculative=True")
        self.draft = draft_model
        self.spec_k = int(spec_k)
        self.decode_ticks = int(decode_ticks)
        if self.decode_ticks < 1:
            raise ValueError(f"decode_ticks must be >= 1, got "
                             f"{decode_ticks}")
        if self.decode_ticks > 1 and self.speculative:
            raise ValueError(
                "decode_ticks > 1 does not compose with speculative "
                "decoding: the speculative iteration already amortizes "
                "one host sync over up to spec_k+1 tokens — pick one "
                "amortization scheme")
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"unsupported compute_dtype={compute_dtype!r} (only "
                f"'float32' or 'bfloat16')")
        self.compute_dtype = "float32" if compute_dtype is None \
            else str(compute_dtype)
        if quantize not in (None, "int8_weights"):
            raise ValueError(f"unsupported quantize={quantize!r} (only "
                             f"'int8_weights')")
        if kv_dtype is not None:
            if cache_dtype is not None \
                    and str(cache_dtype) != str(kv_dtype):
                raise ValueError(f"kv_dtype={kv_dtype!r} conflicts with "
                                 f"cache_dtype={cache_dtype!r}")
            if str(kv_dtype) != "int8":
                raise ValueError(
                    f"unsupported kv_dtype={kv_dtype!r} (only 'int8'; use "
                    f"cache_dtype for plain float layouts)")
            cache_dtype = kv_dtype
        if cache_dtype is None and self.compute_dtype == "bfloat16":
            # bf16 compute writes bf16 K/V: the cache defaults to match
            # (half the bytes); int8 KV still composes
            cache_dtype = "bfloat16"
        if cache_dtype is not None and str(cache_dtype) \
                not in ("float32", "bfloat16", "float16", "int8"):
            raise ValueError(f"unsupported cache_dtype={cache_dtype!r} "
                             f"(float32, bfloat16, float16 or int8)")
        if mesh_layout is not None:
            raise not_ported(f"mesh_layout={mesh_layout!r}",
                             "20 (parallelism over torch.distributed)")
        dev = resolve_device(device)
        self.paged = bool(paged)
        api = ("init_paged_cache", "prefill_paged", "decode_step_paged",
               "peek_logits_paged", "bind_slot_paged",
               "copy_page_paged") if self.paged \
            else ("init_cache", "prefill", "decode_step")
        if quantize is not None:
            api += ("quantize_params",)
        if self.decode_ticks > 1:
            api += ("decode_multi_paged",) if self.paged \
                else ("decode_multi",)
        if self.compute_dtype == "bfloat16":
            api += ("cast_compute_params",)
        if self.speculative:
            api += ("verify_commit_paged",) if self.paged \
                else ("verify_commit",)
        for attr in api:
            if not callable(getattr(model, attr, None)):
                raise TypeError(
                    f"GenerationEngine needs a decoder with the "
                    f"explicit-cache generation API (missing {attr!r}); "
                    f"see gluon.model_zoo.gpt.GPTModel")
        if self.speculative:
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            for attr in ("init_cache", "prefill", "propose_tokens",
                         "advance_len"):
                if not callable(getattr(draft_model, attr, None)):
                    raise TypeError(
                        f"draft_model needs the dense explicit-cache "
                        f"generation API (missing {attr!r}); see "
                        f"gluon.model_zoo.gpt.GPTModel")
            tv = getattr(model, "_vocab_size", None)
            dv = getattr(draft_model, "_vocab_size", None)
            if tv is not None and dv is not None and tv != dv:
                raise TypeError(
                    f"draft vocab {dv} != target vocab {tv}: speculative "
                    f"decoding needs one tokenizer — the draft proposes "
                    f"TARGET token ids")
        for what, m in (("model", model), ("draft_model", draft_model)):
            m_dev = getattr(m, "device", dev) if m is not None else dev
            if torch.device(m_dev) != dev:
                raise ValueError(f"the {what} lives on {m_dev}, the engine "
                                 f"was asked to run on {dev}")
        if int(max_slots) < 1:
            raise ValueError("max_slots must be >= 1")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.device = dev
        self.model = model
        self.quantize = quantize
        if quantize is not None:
            t0 = telemetry.clock()
            model.quantize_params()
            telemetry.hist_since("serving.generate.quant.quantize", t0)
            n, saved = model.quantized_param_stats() \
                if callable(getattr(model, "quantized_param_stats",
                                    None)) else (0, 0)
            telemetry.counter("serving.generate.quant.params", n)
            telemetry.counter("serving.generate.quant.bytes_saved", saved)
        if self.compute_dtype == "bfloat16":
            # the fp32 masters stay; the generation calls read bf16
            # copies of them
            t0 = telemetry.clock()
            model.cast_compute_params("bfloat16")
            telemetry.hist_since("serving.generate.cast.cast", t0)
        self.lora_enabled = lora_rank is not None
        if max_adapters is not None and not self.lora_enabled:
            raise ValueError(
                "max_adapters without lora_rank is inert; pass "
                "lora_rank= to arm the batched adapter bank")
        self.lora_rank, self.max_adapters = None, 0
        if self.lora_enabled:
            self.lora_rank = int(lora_rank)
            if self.lora_rank < 1:
                raise ValueError(f"lora_rank must be >= 1, got "
                                 f"{lora_rank}")
            self.max_adapters = 8 if max_adapters is None \
                else int(max_adapters)
            if self.max_adapters < 1:
                raise ValueError(f"max_adapters must be >= 1, got "
                                 f"{max_adapters}")
            for attr in ("arm_lora", "set_adapter", "clear_adapter"):
                if not callable(getattr(model, attr, None)):
                    raise TypeError(
                        f"lora_rank= needs a model exposing the "
                        f"batched-LoRA API (missing {attr!r}); see "
                        f"gluon.model_zoo.gpt.GPTModel")
            # bank slot 0 is the reserved all-zeros base adapter, so the
            # bank holds max_adapters + 1 slots, allocated here, once
            model.arm_lora(self.max_adapters + 1, self.lora_rank)
        self.max_slots = int(max_slots)
        self._cache_dtype = cache_dtype
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.queue_limit = max(1, int(queue_limit))
        self.timeout_ms = timeout_ms
        self._s_max = int(max_length) if max_length is not None \
            else int(model.max_length)
        #: usable sequence capacity. A speculative engine reserves a
        #: ``spec_k`` scratch margin at the top of every cache row: a
        #: verify writes ``len .. len + spec_k`` before knowing how many
        #: commit, and that write must never clamp; rejected entries sit
        #: above the ``len`` waterline (never attended, overwritten next
        #: iteration)
        self._s_cap = self._s_max - self.spec_k if self.speculative \
            else self._s_max
        if self._s_cap < 2:
            raise ValueError(
                f"max_length {self._s_max} leaves no usable capacity"
                + (f" after the spec_k={self.spec_k} verify margin"
                   if self.speculative else ""))
        policy = as_policy(prefill_bucketing)
        if self.paged:
            ps = int(page_size)
            if ps < 1 or (ps & (ps - 1)):
                raise ValueError("page_size must be a power of two")
            if self._s_max % ps:
                raise ValueError(f"page_size {ps} must divide max_length "
                                 f"{self._s_max}")
            self._ps = ps
            self._p_max = self._s_max // ps
            chunk = int(prefill_chunk) if prefill_chunk is not None \
                else min(self._s_max, max(32, 2 * ps))
            if chunk % ps or not 0 < chunk <= self._s_max:
                raise ValueError(
                    f"prefill_chunk {chunk} must be a positive multiple of "
                    f"page_size {ps} within the cache capacity "
                    f"{self._s_max}")
            self._chunk = chunk
            if policy is None:
                policy = BucketingPolicy(mode="pow2", min_size=max(8, ps))
            self.policy = policy.clamped(self._s_max)
            for w in self.policy.sizes(self._chunk):
                if w <= self._chunk and w % ps:
                    raise ValueError(
                        f"prefill bucket {w} is not a multiple of "
                        f"page_size {ps} (page-granular scatter needs "
                        f"aligned widths)")
            #: default pool = the dense cache's bytes exactly (max_slots
            #: full-length rows) + the scrap page; prefix sharing turns
            #: the saving into extra effective slots
            np_total = int(n_pages) if n_pages is not None \
                else self.max_slots * self._p_max + 1
            self._pool = paging.PagePool(np_total)
            self._prefix = paging.PrefixIndex(self._pool, ps) \
                if prefix_cache else None
            #: page-starved requests, oldest first
            self._blocked: collections.deque = collections.deque()
            self._seq = 0
            self._chunks_this_iter = 0
            self._cache = model.init_paged_cache(self.max_slots, np_total,
                                                 ps, self._s_max,
                                                 dtype=cache_dtype)
        else:
            if policy is None:
                policy = BucketingPolicy(mode="pow2", min_size=8)
            self.policy = policy.clamped(self._s_max)
            self._cache = model.init_cache(self.max_slots, self._s_max,
                                           dtype=cache_dtype)
        #: the draft's OWN cache: dense under a paged target too (the
        #: draft is small) and of the draft's own type (fp32 under a
        #: bf16 target: its logits only steer proposals)
        self._draft_cache = draft_model.init_cache(
            self.max_slots, self._s_max) if self.speculative else None
        self._kv_int8 = "k_scale" in self._cache
        if self._kv_int8:   # quant.* telemetry only for quantized engines
            kv_bytes = sum(t.numel() * t.element_size()
                           for key in ("k", "v", "k_scale", "v_scale")
                           for t in self._cache[key])
            telemetry.gauge("serving.generate.quant.kv_bytes_per_slot",
                            kv_bytes // self.max_slots)
        #: per-slot sampling state, armed when a request enters decode:
        #: host vectors the step's sampler reads (greedy rows keep the
        #: defaults) and one generator per sampled slot
        self._temps = onp.zeros((self.max_slots,), "f4")
        self._topks = onp.zeros((self.max_slots,), "i4")
        self._topps = onp.ones((self.max_slots,), "f4")
        self._gens: list = [None] * self.max_slots
        self._n_sampling = 0   # active slots with temperature > 0
        #: per-slot LoRA bank indices, passed as a (B,) vector to every
        #: generation call of a LoRA engine: a batch mixing any tenants
        #: (base rows included) runs the same step
        self._adapter_idx = onp.zeros((self.max_slots,), "i4")
        #: host-side adapter registry: name -> _Adapter (bank slot, pin
        #: count, deferred-unload flag). _lora_lock is a LEAF lock —
        #: taken from submit, stream-finish callbacks and the load and
        #: unload paths, never around a model call
        self._lora_lock = threading.Lock()
        self._lora_reg: dict = {}
        self._lora_free = list(range(1, self.max_adapters + 1))
        #: freed-but-not-yet-zeroed bank slots: eviction runs in
        #: stream-finish callbacks that may hold the worker's _gen_lock,
        #: where ``model.clear_adapter`` cannot be ordered against a
        #: concurrent ``set_adapter``, so the factors are zeroed lazily
        #: inside the NEXT ``load_adapter``'s exclusive window (a freed
        #: slot is unreachable: no name maps to it)
        self._lora_stale: set = set()
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
        produce, plus the decode step and, with ``decode_ticks > 1``,
        the multi-tick call (paged mode: ``_warmup_paged``), and a
        speculative engine's draft prefills, proposals, verify and
        rollback (``_warmup_spec``) — against THROWAWAY caches of the
        live caches' shapes. On the card the first call also builds the
        CUDA kernels, so no request pays for that."""
        with self._gen_exclusive():
            if self._closed:
                return self
            if self.paged:
                lg = self._warmup_paged()
            else:
                cache = self.model.init_cache(self.max_slots, self._s_max,
                                              dtype=self._cache_dtype)
                for sb in self.policy.sizes(self._s_cap - 1):
                    _, cache = self.model.prefill(
                        onp.zeros((1, sb), "i4"), [sb], cache, slots=[0])
                lg, cache = self.model.decode_step(
                    onp.zeros((self.max_slots,), "i4"), cache)
                self._warmup_multi(cache)
                self._warmup_spec(cache)
                del cache
            self._warm_sampler(lg)
            self._warmup_telemetry()
        return self

    def _warm_sampler(self, logits):
        """One sampled draw over a step's (B, V) logits, so the first
        sampled request does not pay for the sampler's first calls."""
        gen = torch.Generator(device=self.device)
        _smp.sample_tokens([gen] * self.max_slots, logits,
                           onp.ones((self.max_slots,), "f4"),
                           onp.full((self.max_slots,), 50, "i4"),
                           onp.full((self.max_slots,), 0.9, "f4")).cpu()

    def _warmup_paged(self):
        """The paged steady state against a throwaway pool: one fresh
        prefill per bucket up to the chunk width, one chunk per
        page-multiple width up to it (tail chunks shrink near the cache
        end), the decode step, the peek (prefix-hit) path and the
        table-bind / page-copy (COW) calls. Page ids are data, not
        shape, so the ids used here are arbitrary."""
        cache = self.model.init_paged_cache(
            self.max_slots, self._pool.n_pages, self._ps, self._s_max,
            dtype=self._cache_dtype)
        row = onp.ones((self._p_max,), "i4")
        for sb in self.policy.sizes(self._chunk):
            if sb <= self._chunk:
                _, cache = self.model.prefill_paged(
                    onp.zeros((1, sb), "i4"), sb, 0, row, cache, fresh=True)
        for w in range(self._ps, self._chunk + 1, self._ps):
            _, cache = self.model.prefill_paged(
                onp.zeros((1, w), "i4"), w, 0, row, cache, start=0)
        lg, cache = self.model.decode_step_paged(
            onp.zeros((self.max_slots,), "i4"),
            onp.ones((self.max_slots,), "i4"), cache)
        self._warmup_multi(cache)
        self.model.peek_logits_paged(0, 0, cache)
        cache = self.model.bind_slot_paged(0, row, 1, cache)
        self.model.copy_page_paged(1, 1, cache)
        self._warmup_spec(cache)
        del cache
        return lg

    def _warmup_multi(self, cache):
        """One greedy multi-tick call against the throwaway cache (a
        no-op at ``decode_ticks == 1``); every traffic mix runs the same
        call, the knobs being data."""
        b, k = self.max_slots, self.decode_ticks
        if k == 1:
            return
        fn = self.model.decode_multi_paged if self.paged \
            else self.model.decode_multi
        fn(onp.zeros((b,), "i4"), onp.full((b,), k, "i4"), cache, k,
           [None] * b, onp.zeros((b,), "f4"), onp.zeros((b,), "i4"),
           onp.ones((b,), "f4"), onp.full((b,), -1, "i4"))

    def _warmup_spec(self, cache):
        """The speculative steady state against the throwaway target
        cache and a throwaway draft cache (a no-op without a draft): the
        draft's prefill per bucket, its greedy and sampled proposals,
        the greedy and sampled verify-and-commit, and the rollback."""
        if not self.speculative:
            return
        b, k = self.max_slots, self.spec_k
        zb, ones = onp.zeros((b,), "i4"), onp.ones((b,), "i4")
        gens = [torch.Generator(device=self.device)] * b
        knobs = dict(temps=onp.ones((b,), "f4"),
                     top_ks=onp.full((b,), 50, "i4"),
                     top_ps=onp.full((b,), 0.9, "f4"))
        dcache = self.draft.init_cache(b, self._s_max)
        for sb in self.policy.sizes(self._s_cap - 1):
            _, dcache = self.draft.prefill(onp.zeros((1, sb), "i4"), [sb],
                                           dcache, slots=[0])
        dt, dcache = self.draft.propose_tokens(zb, dcache, k)
        dt, q, _, dcache = self.draft.propose_tokens(
            zb, dcache, k, generators=gens, **knobs)
        dcache = self.draft.advance_len(onp.full((b,), -2 * k, "i4"),
                                        dcache)
        vc = self.model.verify_commit_paged if self.paged \
            else self.model.verify_commit
        vc(zb, dt, ones, cache)
        vc(zb, dt, ones, cache, q=q, generators=gens, **knobs)[0].cpu()
        del dcache

    def _cache_tensors(self):
        out = []
        for val in self._cache.values():
            out += list(val) if isinstance(val, tuple) else [val]
        return out

    def _warmup_telemetry(self):
        """The measured bytes of parameters, int8 tables and the live
        cache on the device (``serving.generate.per_device_bytes``)."""
        tensors = list(self.model.parameters()) if callable(
            getattr(self.model, "parameters", None)) else []
        for tab in getattr(self.model, "_quant", None) or ():
            for wq, sc in tab.values():
                tensors += [wq, sc]
        tensors += self._cache_tensors()
        telemetry.gauge("serving.generate.per_device_bytes",
                        sum(t.numel() * t.element_size() for t in tensors))

    @property
    def precision(self) -> str:
        """The replica's numeric configuration, as the reference names
        it: ``"fp32"``, or a ``+``-join of ``"bf16"``,
        ``"int8_weights"`` and ``"int8_kv"``."""
        parts = ["bf16"] if self.compute_dtype == "bfloat16" else []
        if self.quantize is not None:
            parts.append(self.quantize)
        if self._kv_int8:
            parts.append("int8_kv")
        return "+".join(parts) if parts else "fp32"

    @property
    def speculation(self) -> str:
        """The replica's speculative-decoding configuration, as the
        reference names it: ``"off"`` or
        ``"k=<spec_k>:draft=<type>:<layers>L-<units>u"``. A seeded
        sampled stream depends on it (the draft and ``spec_k`` set what
        each iteration draws), so replicas that retry each other's
        requests must agree on it."""
        if not self.speculative:
            return "off"
        d = self.draft
        return (f"k={self.spec_k}:draft={type(d).__name__}:"
                f"{getattr(d, '_num_layers', '?')}L-"
                f"{getattr(d, '_units', '?')}u")

    @property
    def lora(self) -> str:
        """The replica's batched-LoRA configuration, as the reference
        names it: ``"off"`` or ``"rank=<r>:max=<n>"``."""
        if not self.lora_enabled:
            return "off"
        return f"rank={self.lora_rank}:max={self.max_adapters}"

    def capabilities(self) -> str:
        """One-line summary of the engine's configuration, quoted by the
        ``submit`` and adapter-management errors (the port serves no
        mesh: ``mesh=off``)."""
        return (f"precision={self.precision}, "
                f"speculation={self.speculation}, lora={self.lora}, "
                f"paged={self.paged}, mesh=off")

    def _submit_error(self, arg, value, why):
        """The ``submit`` keyword error: names the argument and the
        engine's capabilities."""
        return TypeError(
            f"submit() {arg}={value!r} not supported: {why} "
            f"(engine capabilities: {self.capabilities()})")

    def _no_bank(self, call, name):
        return TypeError(
            f"{call}({name!r}): this engine has no LoRA bank (constructed "
            f"without lora_rank=) (engine capabilities: "
            f"{self.capabilities()})")

    # -- multi-tenant LoRA ------------------------------------------------
    @property
    def adapters(self):
        """Sorted names of the loaded adapters (unload-pending ones,
        pinned by in-flight requests, excluded: they already refuse new
        requests)."""
        with self._lora_lock:
            return sorted(name for name, ad in self._lora_reg.items()
                          if not ad.unloading)

    def has_adapter(self, name) -> bool:
        """Whether ``name`` is loaded and not unload-pending: one lookup
        under the leaf lock."""
        with self._lora_lock:
            ad = self._lora_reg.get(name)
            return ad is not None and not ad.unloading

    def _lora_active_locked(self):
        """Loaded adapters for the ``lora.active_adapters`` gauge,
        unload-pending ones excluded (as :attr:`adapters`). Call under
        ``_lora_lock``."""
        return sum(1 for ad in self._lora_reg.values() if not ad.unloading)

    def load_adapter(self, name, params, alpha=1.0):
        """Load (or refresh) one tenant's LoRA adapter at a step
        boundary: the factors are written into the model's banks in
        place, so nothing is allocated. ``params`` is the flat
        ``{"layers.<li>.<proj>.A"/".B": array}`` mapping of
        ``GPTModel.set_adapter``. Refreshing a loaded name keeps its
        bank slot; in-flight requests bound to it continue on the new
        factors. Slots freed since the last load are zeroed first.
        Returns self."""
        if not self.lora_enabled:
            raise self._no_bank("load_adapter", name)
        if self._closed:
            raise EngineClosedError("load_adapter on a closed engine")
        t0 = telemetry.clock()
        with self._gen_exclusive():
            with self._lora_lock:
                ad = self._lora_reg.get(name)
                if ad is not None and ad.unloading:
                    raise ValueError(
                        f"adapter {name!r} is unloading (pinned by "
                        f"in-flight requests); retry once they finish")
                if ad is None and not self._lora_free:
                    raise ValueError(
                        f"adapter capacity exhausted: {self.max_adapters} "
                        f"slots all hold live adapters "
                        f"({sorted(self._lora_reg)!r}, unload-pending "
                        f"included)")
                idx = ad.idx if ad is not None else self._lora_free[0]
                stale, self._lora_stale = self._lora_stale, set()
            # model calls only under _gen_exclusive, never the leaf
            # lock: the worker is between steps here. An evicted
            # tenant's factors must not linger, and if the install below
            # raises, slot idx must not keep them either.
            for slot in stale:
                self.model.clear_adapter(slot)
            self.model.set_adapter(idx, params, alpha=alpha)
            with self._lora_lock:
                if self._lora_reg.get(name) is None:
                    # a fresh load, or a refresh whose name an unload
                    # completed (a pin drop takes only the leaf lock)
                    # between the two sections: the factors are in idx,
                    # so register them
                    self._lora_free.remove(idx)
                    self._lora_reg[name] = _Adapter(name, idx)
                # the slot holds a live install: an eviction in the
                # window above must not leave it marked for zeroing
                self._lora_stale.discard(idx)
                n_active = self._lora_active_locked()
        telemetry.hist_since("serving.generate.lora.load", t0)
        telemetry.counter("serving.generate.lora.adapters_loaded")
        telemetry.gauge("serving.generate.lora.active_adapters", n_active)
        return self

    def _release_adapter_locked(self, ad):
        """Free ``ad``'s bank slot (zeroed at the next load). Call under
        ``_lora_lock``."""
        del self._lora_reg[ad.name]
        self._lora_free.append(ad.idx)
        self._lora_free.sort()
        self._lora_stale.add(ad.idx)

    def unload_adapter(self, name) -> bool:
        """Unload an adapter. True when its bank slot was freed at once;
        False when in-flight requests still pin it: the unload is
        deferred — the name refuses new requests now, and the slot frees
        when the last pinned request finishes
        (``lora.adapters_evicted`` counts the eviction either way)."""
        if not self.lora_enabled:
            raise self._no_bank("unload_adapter", name)
        with self._lora_lock:
            ad = self._lora_reg.get(name)
            if ad is None:
                raise ValueError(f"unknown adapter {name!r} (loaded: "
                                 f"{sorted(self._lora_reg)!r})")
            deferred = ad.refs > 0
            if deferred:
                ad.unloading = True
            else:
                self._release_adapter_locked(ad)
            n_active = self._lora_active_locked()
        telemetry.gauge("serving.generate.lora.active_adapters", n_active)
        if deferred:
            return False
        telemetry.counter("serving.generate.lora.adapters_evicted")
        return True

    def _pin_adapter(self, name):
        """Resolve a ``submit(adapter=)`` name to its bank slot and pin
        it: an unload while the request runs is deferred, never a
        tenant swapped mid-stream."""
        with self._lora_lock:
            ad = self._lora_reg.get(name)
            if ad is None or ad.unloading:
                loaded = sorted(n for n, a in self._lora_reg.items()
                                if not a.unloading)
                raise ValueError(
                    f"submit() adapter={name!r} is not loaded on this "
                    f"engine (loaded adapters: {loaded!r}; engine "
                    f"capabilities: {self.capabilities()})")
            ad.refs += 1
            return ad.idx

    def _unpin_adapter(self, name):
        """Drop one request's pin; completes a deferred unload when the
        last pin goes (a stream-finish callback: leaf lock only)."""
        with self._lora_lock:
            ad = self._lora_reg.get(name)
            if ad is None:
                return
            ad.refs -= 1
            evicted = ad.refs <= 0 and ad.unloading
            if evicted:
                self._release_adapter_locked(ad)
                n_active = self._lora_active_locked()
        if evicted:
            telemetry.counter("serving.generate.lora.adapters_evicted")
            telemetry.gauge("serving.generate.lora.active_adapters",
                            n_active)

    def _akw(self, idx):
        """The ``adapters=`` keyword of a model call, on a LoRA engine
        only (other decoders need not take it)."""
        return {"adapters": idx} if self.lora_enabled else {}

    def load_weights(self, source, strict: bool = True):
        """Weight rollover: install new parameter values into the live
        model while traffic runs.

        ``source`` is an in-memory ``{name: array}`` mapping (a
        checkpoint path is a later slice). Names (under ``strict``, the
        model's exactly) and shapes are checked before any buffer is
        touched, so a bad source never leaves the model half-swapped.
        The swap happens at a step boundary under the generation lock:
        the parameters are written in place (same tensors, same
        ``data_ptr()``), an int8-weight engine re-quantizes its tables
        inside the same window (a step never sees new fp32 weights with
        stale int8 tables), and a paged engine flushes its prefix index
        and stops in-flight prompts from registering, since their K/V
        came from the old weights. A bf16 engine re-casts its copies in
        the same window. In-flight requests keep their KV cache and
        continue on the new weights. A speculative engine swaps the
        target only: the draft keeps its weights (greedy output follows
        the live target whatever the draft; a stale draft only lowers
        the acceptance rate). Returns self."""
        if self._closed:
            raise EngineClosedError("load_weights on a closed engine")
        if not isinstance(source, dict):
            raise not_ported("load_weights from a checkpoint path",
                             "18b (checkpoint)")
        t0 = telemetry.clock()
        with self._gen_exclusive():
            _swap_param_buffers(self.model.collect_params(), source, strict)
            if self.quantize is not None:
                tq = telemetry.clock()
                self.model.quantize_params()
                telemetry.hist_since("serving.generate.quant.requantize", tq)
            if self.compute_dtype == "bfloat16":
                tc = telemetry.clock()
                self.model.cast_compute_params("bfloat16")
                telemetry.hist_since("serving.generate.cast.recast", tc)
            if self.paged and self._prefix is not None:
                self._prefix.release_all()
                for s in self._slots:
                    if s is not None:
                        s.prompt = None
        telemetry.hist_since("serving.generate.swap", t0)
        telemetry.counter("serving.generate.weight_swaps")
        return self

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
            margin = f" minus the spec_k={self.spec_k} verify margin" \
                if self.speculative else ""
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate (cache capacity {self._s_max}{margin})")
        max_new = self.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.paged:
            cap = min(int(prompt.size) + max_new, self._s_cap)
            need = -(-cap // self._ps)
            if need > self._pool.n_pages - 1:
                raise ValueError(
                    f"request needs up to {need} KV pages but the pool "
                    f"holds {self._pool.n_pages - 1} allocatable pages")
        eos = self.eos_id if eos_id is None else eos_id
        return prompt.astype("i4"), max_new, eos

    @staticmethod
    def _validate_sampling(temperature, top_k, top_p, seed):
        """Normalize and validate the per-request sampling knobs as the
        reference does. Returns ``(temperature, top_k, top_p, seed)``
        with the greedy/off defaults filled in (``0.0``, ``0``, ``1.0``,
        ``None``)."""
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
        if seed is not None:
            seed = int(seed)
        return t, k, p, seed

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               timeout_ms=None, temperature=None, top_k=None, top_p=None,
               seed=None, adapter=None, trace=None) -> GenerationStream:
        """Queue one prompt; returns a :class:`GenerationStream`.
        Raises :class:`EngineClosedError` / :class:`QueueFullError` /
        ``ValueError`` immediately instead of returning a stream that
        can never complete.

        ``temperature``/``top_k``/``top_p`` select per-request sampling
        (default greedy: ``temperature`` absent or 0, and ``top_k`` /
        ``top_p`` / ``seed`` are then ignored). ``seed`` seeds the
        request's own generator: the same seed gives the same tokens on
        the same device and engine configuration; without one a fresh
        seed is drawn. ``adapter`` names a loaded LoRA adapter
        (``load_adapter``) the request decodes under; it stays pinned
        (an unload defers) until the request finishes. Default: the
        base model. ``trace`` arms per-request tracing
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
        temp, tk, tp, seed = self._validate_sampling(temperature, top_k,
                                                     top_p, seed)
        if adapter is not None and not self.lora_enabled:
            raise self._submit_error(
                "adapter", adapter, "this engine has no LoRA bank "
                "(constructed without lora_rank=)")
        if temp > 0:
            telemetry.counter("serving.generate.sampling.requests")
            if seed is None:
                seed = int.from_bytes(os.urandom(4), "little")
        aidx = 0
        if adapter is not None:
            aidx = self._pin_adapter(adapter)   # raises on an unknown name
            telemetry.counter("serving.generate.lora.requests")
        telemetry.counter("serving.generate.requests")
        stream = GenerationStream(int(prompt.size))
        tr = tracing.start_trace(trace)
        if tr is not None:
            stream._trace = tr
            tr.event("submit", prompt_len=int(prompt.size),
                     max_new=max_new)
        if adapter is not None:
            stream._on_finish(lambda: self._unpin_adapter(adapter))
        tmo = self.timeout_ms if timeout_ms is None else timeout_ms
        now = time.monotonic()
        req = _GenRequest(prompt, max_new, eos, stream, telemetry.clock(),
                          now, now + tmo / 1e3 if tmo is not None else None,
                          (temp, tk, tp, seed), aidx)
        if self._sync:  # MXTPU_SERVING=0: inline generation
            with self._gen_lock:
                self._admit_one(req)
                while self._n_active:
                    self._step()
                if self.paged and self._blocked:
                    # an idle sync engine can never unblock a stashed
                    # request (validated capacity makes this a pool-
                    # accounting fault, not a load condition): reject
                    # rather than hang
                    self._blocked.popleft().stream._finish(
                        exc=QueueFullError("page pool exhausted for a "
                                           "synchronous request"))
            return stream
        try:
            self._worker._queue.put_nowait(req)
        except queue.Full:
            telemetry.counter("serving.generate.rejected_full")
            # the stream never reaches the engine and never finishes:
            # drop the pin here
            if adapter is not None:
                self._unpin_adapter(adapter)
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
        if self.paged:
            # page-starved requests wait in _blocked, FIFO: younger queue
            # entries must not starve an older blocked one. queue_wait is
            # recorded at the actual admission (or the rejection), so
            # time spent blocked on KV pages shows in the histogram
            while self._blocked and self._n_active < self.max_slots:
                r = self._blocked[0]
                waited_ms = (time.monotonic() - r.t_enq) * 1e3
                if r.deadline is not None and time.monotonic() > r.deadline:
                    telemetry.hist("serving.generate.queue_wait", waited_ms)
                    telemetry.counter("serving.generate.timeouts")
                    r.stream._finish(exc=RequestTimeoutError(
                        f"request deadline expired while awaiting KV "
                        f"pages (waited {waited_ms:.1f} ms)"))
                    self._blocked.popleft()
                    continue
                if not self._try_admit_paged(r):
                    break
                telemetry.hist("serving.generate.queue_wait", waited_ms)
                if r.stream._trace is not None:
                    r.stream._trace.add_ms("queue", waited_ms, blocked=True)
                self._blocked.popleft()
        while self._n_active < self.max_slots \
                and not (self.paged and self._blocked):
            try:
                r = q.get_nowait()
            except queue.Empty:
                break
            self._admit_one(r)
        telemetry.gauge(
            "serving.generate.queue.depth",
            q.qsize() + (len(self._blocked) if self.paged else 0))

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
        if self.paged:
            # a page-starved request goes to _blocked: its queue_wait is
            # recorded when it actually admits (or is rejected)
            if self._try_admit_paged(r):
                telemetry.hist("serving.generate.queue_wait", waited_ms)
                if r.stream._trace is not None:
                    r.stream._trace.add_ms("queue", waited_ms)
            else:
                if r.stream._trace is not None:
                    r.stream._trace.event("deferred", why="kv_pages")
                self._blocked.append(r)
            return
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
        self._adapter_idx[slot] = r.adapter_idx
        pt0 = time.perf_counter() if tr is not None else 0.0
        t0 = telemetry.clock()
        logits, self._cache = self.model.prefill(
            padded, onp.asarray([n], "i4"), self._cache,
            slots=onp.asarray([slot], "i4"),
            **self._akw(self._adapter_idx[slot:slot + 1]))
        if self.speculative:
            # the draft mirrors the target's committed prefix from the
            # slot's first moment
            self._draft_prefill(slot, r.prompt)
        self._arm_sampling(slot, r.sampling)
        tok = self._pick_first(slot, logits[0])   # the admission's sync
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

    def _arm_sampling(self, slot: int, sampling):
        """Install a request's sampling knobs into the per-slot vectors
        when it enters decode (greedy requests write the defaults: the
        vectors never carry a previous tenant's state). A sampled
        request gets its own generator, seeded here; a paged request
        arms only at its first token, so the draws it makes depend on
        nothing that ran while it prefilled."""
        temp, tk, tp, seed = sampling
        self._temps[slot], self._topks[slot], self._topps[slot] = \
            temp, tk, tp
        if temp > 0:
            self._n_sampling += 1
            self._gens[slot] = torch.Generator(
                device=self.device).manual_seed(seed)

    def _disarm_slot(self, slot: int):
        """Reset a freed slot's per-slot state: its sampling knobs, and
        its adapter index (a freed row decodes as base)."""
        if self._temps[slot] > 0:
            self._n_sampling -= 1
        self._temps[slot], self._topks[slot], self._topps[slot] = 0, 0, 1
        self._gens[slot] = None
        self._adapter_idx[slot] = 0

    def _draft_prefill(self, slot: int, prompt):
        """The draft's dense prefill of ``prompt`` into its row ``slot``,
        at the target's bucket. The row is zeroed first. The rollback
        (``n_commit - k``, as in the reference) leaves the draft without
        the K/V of its last proposal after a full accept, and the draft
        then attends that position as it stands: it must hold nothing a
        previous tenant of the slot wrote, or a seeded sampled stream
        would depend on the slot's history."""
        for t in (*self._draft_cache["k"], *self._draft_cache["v"]):
            t[slot].zero_()
        n = int(prompt.size)
        padded = onp.zeros((1, self.policy.bucket(n)), "i4")
        padded[0, :n] = prompt
        _, self._draft_cache = self.draft.prefill(
            padded, onp.asarray([n], "i4"), self._draft_cache,
            slots=onp.asarray([slot], "i4"))

    def _pick_first(self, slot: int, logits_row) -> int:
        """First token of a fresh admission, from its prefill or peek
        logits row (V,): argmax for a greedy slot, a draw with the
        slot's generator for a sampled one."""
        if self._temps[slot] <= 0:
            return int(logits_row.argmax())
        sl = slice(slot, slot + 1)
        return int(_smp.sample_tokens(
            [self._gens[slot]], logits_row[None], self._temps[sl],
            self._topks[sl], self._topps[sl])[0])

    def _pick_step_tokens(self, logits):
        """Every row's next token from a decode step's (B, V) logits,
        brought to the host (the step's one sync): argmax when no slot
        samples, else one sampler call in which greedy rows keep their
        argmax."""
        if self._n_sampling:
            tok = _smp.sample_tokens(self._gens, logits, self._temps,
                                     self._topks, self._topps)
        else:
            tok = logits.argmax(dim=-1)
        return tok.cpu().numpy()

    # -- paged scheduling ----------------------------------------------
    def _alloc_pages(self, n):
        """Allocate ``n`` pool pages, evicting LRU cached prefixes to
        make room; None when even an empty prefix cache cannot cover
        them (the pages are pinned by active slots)."""
        out = self._pool.alloc(n)
        while out is None and self._prefix is not None \
                and self._prefix.evict_lru():
            out = self._pool.alloc(n)
        return out

    def _release_pages(self, pids):
        for pid in pids:
            self._pool.release(pid)

    def _try_admit_paged(self, r: _GenRequest) -> bool:
        """Place ``r`` into a free slot: match the longest cached
        prefix, reserve its worst-case private pages (so decode can
        never run out mid-sequence), and either peek its first token
        straight off a fully-cached prompt or queue its prefill chunks.
        False when the pool (after prefix-cache eviction) cannot cover
        the reservation — the request stays blocked."""
        length = int(r.prompt.size)
        ps = self._ps
        cap_pages = -(-min(length + r.max_new, self._s_cap) // ps)
        shared_pages, shared_tokens = [], 0
        if self._prefix is not None and r.adapter_idx == 0:
            # prefix reuse is base-model only: cached pages hold the K/V
            # of the projections that prefilled them, and an adapter
            # changes q/k/v; adapted requests always prefill fresh and
            # never publish (_register_prefix)
            shared_pages, shared_tokens = self._prefix.match(r.prompt)
        peek = shared_tokens == length
        first_write = (length if peek else shared_tokens) // ps
        # retain the matched pages BEFORE allocating: _alloc_pages may
        # LRU-evict the very record backing them, and unretained pages
        # would return to the free list and come straight back as this
        # request's PRIVATE pages (LIFO) — the row would alias shared
        # and private, and chunk prefill would overwrite the prefix K/V
        refs = []
        n_shared = len(shared_pages) if peek else first_write
        for i in range(n_shared):
            self._pool.retain(shared_pages[i])
            refs.append(shared_pages[i])
        private = self._alloc_pages(cap_pages - first_write)
        if private is None and refs:
            # our retained prefix refs pinned exactly the pages the
            # eviction sweep tried to reclaim: drop the match and retry
            # UNSHARED — a page-heavy prefix hit degrades to a plain
            # prefill instead of failing an admission a retry satisfies
            self._release_pages(refs)
            refs = []
            shared_pages, shared_tokens = [], 0
            peek = False
            first_write = n_shared = 0
            private = self._alloc_pages(cap_pages)
        if private is None:
            self._release_pages(refs)
            return False
        slot = self._slots.index(None)
        tr = r.stream._trace
        if tr is not None:
            tr.event("admission", slot=slot, mode="paged", peek=peek,
                     prefix_tokens=shared_tokens)
        tracing.flight.record("gen.admit", slot=slot, mode="paged",
                              peek=peek, prefix_tokens=shared_tokens,
                              trace_id=r.stream.trace_id)
        row = onp.zeros((self._p_max,), "i4")   # scrap past the cap
        for i in range(n_shared):
            row[i] = shared_pages[i]
        refs.extend(private)
        s = _PagedSlot(r.stream, r.max_new, r.eos_id, r.deadline,
                       n_ctx=length, row=row, page_refs=refs,
                       prompt=r.prompt, seq=self._seq, t_submit=r.t_submit,
                       sampling=r.sampling, adapter_idx=r.adapter_idx)
        self._adapter_idx[slot] = r.adapter_idx
        if self.speculative:
            # the draft (no pages, no prefix cache) prefills the whole
            # prompt when the slot enters decode, prefix hit or not
            s.draft_prompt = r.prompt
        self._seq += 1
        if peek:
            if length % ps:
                # the shared partial tail is this slot's divergence
                # page: COW it right before the first decode write
                s.cow_pending = (int(row[first_write]), private[0],
                                 first_write)
                row[first_write + 1:cap_pages] = private[1:]
            else:
                row[first_write:cap_pages] = private
            telemetry.counter("serving.generate.prefix_hits")
            self._slots[slot] = s
            self._n_active += 1
            pt0 = time.perf_counter() if tr is not None else 0.0
            t0 = telemetry.clock()
            self._cache = self.model.bind_slot_paged(slot, row, length,
                                                     self._cache)
            logits = self.model.peek_logits_paged(
                int(r.prompt[-1]), slot, self._cache,
                **self._akw(self._adapter_idx[slot:slot + 1]))
            self._register_prefix(s)
            self._first_token(slot, s, logits)   # the admission's sync
            telemetry.hist_since("serving.generate.prefill", t0)
            telemetry.counter("serving.generate.prefills")
            if tr is not None:
                tr.add("prefill", pt0, slot=slot, tokens=length, peek=True)
            return True
        row[first_write:cap_pages] = private
        start0 = first_write * ps
        if start0 == 0 and self.policy.bucket(length) <= self._chunk:
            w = self.policy.bucket(length)     # one fresh prefill
            toks = onp.zeros((1, w), "i4")
            toks[0, :length] = r.prompt
            s.chunks.append((toks, 0, length, True))
        else:
            pos = start0
            while pos < length:
                w = min(self._chunk, self._s_max - pos)
                nv = min(w, length - pos)
                toks = onp.zeros((1, w), "i4")
                toks[0, :nv] = r.prompt[pos:pos + nv]
                s.chunks.append((toks, pos, nv, False))
                pos += nv
        self._slots[slot] = s
        self._n_active += 1
        return True

    def _register_prefix(self, s: _PagedSlot):
        """Publish a completed prompt's pages to the prefix index so
        later identical or shared-prefix requests reuse them. When the
        prompt ends mid-page and this slot will keep decoding, the now
        index-retained tail page becomes shared — arm a COW so the
        slot's first decode write copies it instead of corrupting the
        cached prefix."""
        if self._prefix is None or s.prompt is None \
                or s.adapter_idx != 0:   # adapted K/V never publishes
            return
        length = int(s.prompt.size)
        needs_cow = (length % self._ps != 0 and s.cow_pending is None
                     and s.left > 1 and s.n_ctx < self._s_cap)
        dst = None
        if needs_cow:
            dst = self._alloc_pages(1)
            if dst is None:
                return  # cannot afford to freeze the tail: skip caching
        if not self._prefix.register(s.prompt, s.row):
            if dst:
                self._release_pages(dst)
        elif dst:
            s.cow_pending = (int(s.row[length // self._ps]), dst[0],
                             length // self._ps)
            s.page_refs.append(dst[0])
        s.prompt = None

    def _first_token(self, slot: int, s: _PagedSlot, logits_row):
        """Pick and emit a freshly admitted request's first token from
        its last prefill chunk's logits or the prefix-hit peek's (V,) —
        the paged analog of the dense admission's tail. The request's
        sampling knobs go live here, at its entry into decode, and a
        speculative engine's draft catches up: one dense prefill of the
        full prompt."""
        if s.draft_prompt is not None:
            self._draft_prefill(slot, s.draft_prompt)
            s.draft_prompt = None
        self._arm_sampling(slot, s.sampling)
        tok = self._pick_first(slot, logits_row)
        s.last = tok
        s.left -= 1
        s.state = "decode"
        s.stream._emit(tok)
        telemetry.counter("serving.generate.tokens")
        telemetry.hist_since("serving.generate.ttft", s.t_submit)
        if s.eos_id is not None and tok == s.eos_id:
            self._evict(slot, "eos")
        elif s.left <= 0 or s.n_ctx >= self._s_cap:
            self._evict(slot, "length")
        else:
            telemetry.gauge("serving.generate.slots", self._n_active)

    def _prefill_tick(self) -> int:
        """Run AT MOST ONE prefill chunk (oldest admitted slot first):
        the decode-stall bound — a long prompt spends several iterations
        prefilling, each interleaved with a decode step over the
        in-flight slots, so a decode step waits for one chunk, never
        for a whole prompt."""
        best = None
        for i, s in enumerate(self._slots):
            if s is not None and s.state == "prefill" \
                    and (best is None or s.seq < self._slots[best].seq):
                best = i
        if best is None:
            return 0
        s = self._slots[best]
        if s.deadline is not None and time.monotonic() > s.deadline:
            telemetry.counter("serving.generate.timeouts")
            self._evict_exc(best, RequestTimeoutError(
                "request deadline expired during chunked prefill"))
            return 0
        toks, start, n_valid, fresh = s.chunks.popleft()
        tr = s.stream._trace
        pt0 = time.perf_counter() if tr is not None else 0.0
        t0 = telemetry.clock()
        logits, self._cache = self.model.prefill_paged(
            toks, n_valid, best, s.row, self._cache, start=start,
            fresh=fresh, **self._akw(self._adapter_idx[best:best + 1]))
        telemetry.counter("serving.generate.prefill_chunks")
        self._chunks_this_iter += 1
        if not s.chunks:
            telemetry.counter("serving.generate.prefills")
            self._register_prefix(s)
            self._first_token(best, s, logits[0])   # host sync
        telemetry.hist_since("serving.generate.prefill", t0)
        if tr is not None:
            tr.add("prefill_chunk", pt0, slot=best, start=start,
                   tokens=n_valid)
        return 1

    def _cow_sweep(self):
        """Copy-on-write: a decoding slot whose next cache write would
        land in a SHARED page copies the divergence page first and
        rebinds its table row. Runs before every paged decode step."""
        for i, s in enumerate(self._slots):
            if s is not None and s.state == "decode" \
                    and s.cow_pending is not None:
                src, dst, logical = s.cow_pending
                tr = s.stream._trace
                pt0 = time.perf_counter() if tr is not None else 0.0
                self._cache = self.model.copy_page_paged(src, dst,
                                                         self._cache)
                s.row[logical] = dst
                self._cache = self.model.bind_slot_paged(i, s.row, s.n_ctx,
                                                         self._cache)
                self._pool.release(src)
                s.page_refs.remove(src)
                s.cow_pending = None
                telemetry.counter("serving.generate.pages.cow_copies")
                if tr is not None:
                    tr.add("cow_copy", pt0, slot=i, src=src, dst=dst)

    # -- the engine iteration ------------------------------------------
    def _step(self):
        """One engine iteration. Paged mode: at most one prefill chunk
        (``_prefill_tick``), then one decode step over the decoding
        slots. Dense mode: one decode step over ALL slots."""
        if self.paged:
            # the gauge counts every chunk run inside this iteration, so
            # the one-chunk decode-stall bound is falsifiable
            self._chunks_this_iter = 0
            self._prefill_tick()
            telemetry.gauge("serving.generate.prefill_chunks_per_iter",
                            self._chunks_this_iter)
            if any(s is not None and s.state == "decode"
                   for s in self._slots):
                self._tick()
            return
        self._tick()

    def _tick(self):
        if self.speculative:
            self._spec_tick()
        else:
            self._decode_tick()

    def _decode_idxs(self):
        """The slots that take part in a decode tick: every occupied
        slot, in paged mode only those past their prefill."""
        return [i for i, s in enumerate(self._slots)
                if s is not None and (not self.paged or s.state == "decode")]

    def _decode_tick(self):
        """One decode tick over every DECODING slot (free rows, and in
        paged mode prefilling rows, ride along in the fixed-shape batch:
        paged writes of those rows go to the scrap page and their
        ``len`` stands still), the argmax of every row taken on the
        device and the (B,) tokens brought to the host — the tick's one
        sync — then one token per live slot and the eviction ladder
        (``_commit_outputs``). With ``decode_ticks > 1`` the tick runs
        k steps instead (``_decode_tick_multi``). Freed rows admit the
        next prompts mid-sequence."""
        if self.paged:
            self._cow_sweep()
        idxs = self._decode_idxs()
        if not idxs:
            return
        if self.decode_ticks > 1:
            self._decode_tick_multi(idxs)
            return
        toks = onp.zeros((self.max_slots,), "i4")
        active = onp.zeros((self.max_slots,), "i4")
        for i in idxs:
            toks[i] = self._slots[i].last
            active[i] = 1
        tt0 = self._span_start(idxs)
        t0 = telemetry.clock()
        akw = self._akw(self._adapter_idx)
        if self.paged:
            logits, self._cache = self.model.decode_step_paged(
                toks, active, self._cache, **akw)
        else:
            logits, self._cache = self.model.decode_step(toks, self._cache,
                                                         **akw)
        step_toks = self._pick_step_tokens(logits)
        telemetry.hist_since("serving.generate.decode", t0)
        self._tick_counters(1, 1)

        def span(i, s, out):
            s.stream._trace.add("decode", tt0, slot=i, token=out[-1])
        self._commit_outputs(idxs, {i: [int(step_toks[i])] for i in idxs},
                             span)

    def _decode_tick_multi(self, idxs):
        """One multi-tick decode tick: ``decode_ticks`` steps in one
        model call (``decode_multi``), committed through one host sync.
        Each slot's budget is clamped to its remaining tokens and its
        capacity headroom, so the call never over-emits; eos and budget
        stops run on the device, and the host receives the (B, k) token
        block with its emission mask (one copy) and commits each slot's
        emitted prefix."""
        k, b = self.decode_ticks, self.max_slots
        toks = onp.zeros((b,), "i4")
        budgets = onp.zeros((b,), "i4")
        eos_ids = onp.full((b,), -1, "i4")
        for i in idxs:
            s = self._slots[i]
            toks[i] = s.last
            budgets[i] = min(k, s.left, self._s_cap - s.n_ctx)
            if s.eos_id is not None:
                eos_ids[i] = s.eos_id
        tt0 = self._span_start(idxs)
        t0 = telemetry.clock()
        fn = self.model.decode_multi_paged if self.paged \
            else self.model.decode_multi
        tok_blk, emit_blk, _, self._cache = fn(
            toks, budgets, self._cache, k, self._gens, self._temps,
            self._topks, self._topps, eos_ids,
            **self._akw(self._adapter_idx))
        blk = torch.cat((tok_blk, emit_blk.to(torch.int32)), dim=1) \
            .cpu().numpy()   # the tick's one sync
        telemetry.hist_since("serving.generate.decode", t0)
        self._tick_counters(1, k)
        outs = {i: [int(t) for t in blk[i, :int(blk[i, k:].sum())]]
                for i in idxs}

        def span(i, s, out):
            # one span for the whole block, with its token count
            s.stream._trace.add("decode", tt0, slot=i, tokens=len(out))
        self._commit_outputs(idxs, outs, span)

    def _span_start(self, idxs):
        """The tick's start stamp when a slot in it is traced, else 0."""
        if any(self._slots[i].stream._trace is not None for i in idxs):
            return time.perf_counter()
        return 0.0

    def _spec_tick(self):
        """One speculative iteration over every decoding slot: the draft
        proposes ``spec_k`` tokens per slot (its k chained steps, tokens
        fed on the device), the target verifies all ``k + 1`` positions,
        applies the accept rule and advances its ``len`` in one call,
        and the (B, k + 1) commit block with its counts reaches the host
        in the iteration's one sync. The host then cuts each slot's
        emission at its eos and clips it to its budget and capacity (a
        clipped slot is evicted, so the target's full-commit ``len`` is
        a dead row's), and the draft, which ran k steps on every row,
        rolls back to the accept point (``advance_len`` by ``n_commit -
        k``; rows not decoding by ``-k``). Greedy slots commit exactly
        the tokens the non-speculative engine would."""
        if self.paged:
            self._cow_sweep()
        idxs = self._decode_idxs()
        if not idxs:
            return
        k, b = self.spec_k, self.max_slots
        toks = onp.zeros((b,), "i4")
        active = onp.zeros((b,), "i4")
        for i in idxs:
            toks[i] = self._slots[i].last
            active[i] = 1
        tt0 = self._span_start(idxs)
        t0 = telemetry.clock()
        verify = self.model.verify_commit_paged if self.paged \
            else self.model.verify_commit
        # the draft proposes as the base model; the target verifies
        # each row under its adapter, so every committed token is the
        # adapted model's own
        akw = self._akw(self._adapter_idx)
        if self._n_sampling:
            knobs = dict(temps=self._temps, top_ks=self._topks,
                         top_ps=self._topps)
            dt, q, _, self._draft_cache = self.draft.propose_tokens(
                toks, self._draft_cache, k, generators=self._gens, **knobs)
            commit, n_commit, _, self._cache = verify(
                toks, dt, active, self._cache, q=q, generators=self._gens,
                **knobs, **akw)
        else:
            dt, self._draft_cache = self.draft.propose_tokens(
                toks, self._draft_cache, k)
            commit, n_commit, self._cache = verify(toks, dt, active,
                                                   self._cache, **akw)
        blk = torch.cat((commit, n_commit[:, None]), dim=1).cpu().numpy()
        telemetry.hist_since("serving.generate.decode", t0)
        ddelta = onp.full((b,), -k, "i4")
        outs, clipped = {}, {}
        proposed, accepted = len(idxs) * k, 0
        for i in idxs:
            s = self._slots[i]
            m = int(blk[i, k + 1])
            accepted += m - 1
            out = [int(t) for t in blk[i, :m]]
            if s.eos_id is not None and s.eos_id in out:
                out = out[:out.index(s.eos_id) + 1]
            out = out[:min(len(out), s.left, self._s_cap - s.n_ctx)]
            outs[i] = out
            clipped[i] = len(out) < m
            ddelta[i] += m
        self._draft_cache = self.draft.advance_len(ddelta, self._draft_cache)
        telemetry.counter("serving.generate.spec.proposed", proposed)
        telemetry.counter("serving.generate.spec.accepted", accepted)
        telemetry.counter("serving.generate.spec.rejected",
                          proposed - accepted)
        telemetry.gauge("serving.generate.spec.accept_rate",
                        accepted / proposed)
        # propose, verify-and-commit and the rollback: three calls and
        # one host sync for up to k + 1 tokens a slot
        self._tick_counters(3, k + 1)

        def span(i, s, out):
            s.stream._trace.add("verify", tt0, slot=i, proposed=k,
                                committed=len(out))
        n_emitted = self._commit_outputs(idxs, outs, span, clipped)
        telemetry.gauge("serving.generate.spec.tokens_per_step", n_emitted)

    def _tick_counters(self, dispatches, fused):
        """Once per decode tick: one host sync, the model calls
        (``dispatches``) behind it, and the steps it covers
        (``ticks_per_sync``: k, or ``spec_k + 1`` at most)."""
        telemetry.counter("serving.generate.host_syncs")
        telemetry.counter("serving.generate.dispatches", int(dispatches))
        telemetry.gauge("serving.generate.ticks_per_sync", int(fused))

    def _commit_outputs(self, idxs, outs, span_cb, clipped=None):
        """Emit each slot's tokens of the tick (``outs[slot]``), record
        its span (``span_cb``, traced slots only), advance its budget
        and length, then the eviction ladder: eos first, then
        budget/capacity (``clipped`` marks speculative slots whose
        emission was cut short of their commit: evicted even when the
        counters alone would not say so), then the deadline (checked
        once per tick). Returns the number of tokens emitted."""
        now = time.monotonic()
        n_emitted = 0
        for i in idxs:
            s = self._slots[i]
            out = outs[i]
            if s.stream._trace is not None:
                span_cb(i, s, out)
            s.stream._emit_many(out)
            n_emitted += len(out)
            if not out:   # an exhausted slot the checks below would
                self._evict(i, "length")   # have caught last tick
                continue
            s.last = out[-1]
            s.left -= len(out)
            s.n_ctx += len(out)
            if s.eos_id is not None and out[-1] == s.eos_id:
                self._evict(i, "eos")
            elif s.left <= 0 or s.n_ctx >= self._s_cap \
                    or (clipped is not None and clipped[i]):
                self._evict(i, "length")
            elif s.deadline is not None and now > s.deadline:
                telemetry.counter("serving.generate.timeouts")
                self._evict(i, "timeout")
        telemetry.counter("serving.generate.tokens", n_emitted)
        telemetry.gauge("serving.generate.slots", self._n_active)
        return n_emitted

    def _release_slot_refs(self, s):
        if self.paged and s.page_refs:
            self._release_pages(s.page_refs)
            s.page_refs = []

    def _free_slot(self, slot: int):
        self._release_slot_refs(self._slots[slot])
        self._slots[slot] = None
        self._disarm_slot(slot)
        self._n_active -= 1
        telemetry.counter("serving.generate.evictions")
        telemetry.gauge("serving.generate.slots", self._n_active)

    def _evict_exc(self, slot: int, exc):
        """Reject a slot whose stream has delivered nothing yet (a
        prefill-phase deadline): an exception, not a truncated
        result."""
        s = self._slots[slot]
        if s.stream._trace is not None:
            s.stream._trace.event("evict", slot=slot,
                                  error=f"{type(exc).__name__}: {exc}")
        tracing.flight.record("gen.evict", slot=slot,
                              error=type(exc).__name__,
                              trace_id=s.stream.trace_id)
        s.stream._finish(exc=exc)
        self._free_slot(slot)

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
        outcome stands) and free the slots. A paged slot still in its
        PREFILL phase has delivered nothing — it is rejected with
        :class:`EngineClosedError` like a queued request, never handed
        an empty 'successful' result. Paged mode also rejects
        page-starved blocked requests."""
        for i, s in enumerate(self._slots):
            if s is not None:
                if self.paged and s.state == "prefill":
                    s.stream._finish(exc=EngineClosedError(
                        "engine closed during chunked prefill (no tokens "
                        "were generated)"))
                else:
                    s.stream._finish(reason=reason)
                self._release_slot_refs(s)
                self._slots[i] = None
                self._disarm_slot(i)
        self._n_active = 0
        self._teardown_paged(EngineClosedError(
            "engine closed while the request awaited KV pages"))

    def _teardown_paged(self, exc):
        """Terminal paged cleanup shared by close and worker crash:
        reject every page-starved blocked request with ``exc`` and drain
        the prefix index — the pool must read fully free afterwards."""
        if not self.paged:
            return
        while self._blocked:
            self._blocked.popleft().stream._finish(exc=exc)
        if self._prefix is not None:
            self._prefix.release_all()

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
                self._release_slot_refs(s)
                self._slots[i] = None
                self._disarm_slot(i)
        self._n_active = 0
        self._teardown_paged(failure)
        if self._worker is not None:
            self._worker._stopped = True
            try:
                while True:
                    r = self._worker._queue.get_nowait()
                    r.stream._finish(exc=failure)
            except queue.Empty:
                pass
        _live_engines.discard(self)
