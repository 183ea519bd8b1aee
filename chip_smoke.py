#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc/`` (nvcc,
one process per source, seconds) and holds each kernel instance against
its plain PyTorch version on the card: K1 flash prefill (3xTF32 tensor
cores; causal up to the 1024-token context, head dims 16-128, strided
views, NaN past kv_len), K2 dense decode
and K3 paged decode (each in its fp32 and its int8-KV instance, with
garbage past every length and NaN in the scrap page, every unreferenced
page and their int8 scales; both also at lengths on either side of
their cluster ranks' ranges, K3 at a P_max that is not a multiple of
its cluster size, K2 at S = 1000, on a cache sliced from a longer
buffer and on a row-strided view), K4 int8 dequant-matmul (M = 1 to 512,
with and without the bias it adds in its epilogue), the bf16 and the
float16 instances of K1 (its own kernel, templated on the element
type: wgmma on tiles brought by TMA), K2 and K3 (every case of the fp32
phases on 16-bit inputs; K2 and K3 with a 16-bit and an fp32 q over
16-bit caches) and K5, the
runtime-compiled user kernels: one ``rtc.CudaModule`` compiled by NVRTC
for sm_90a (the JAX rtc tests' kernels, the example's ``scale2`` and a
shared-memory ``row_softmax``), each held against its plain torch
version, and K1-bwd, the flash attention backward (its dq and its
dk/dv launch, fp32, bf16 and float16: causal and not, 512 and 1024
tokens, head dims 16 and 128, kv_len below the key buffer and below the
query length, finite garbage past kv_len, the head split's strided views
and a transposed dO, a small dO whose dS falls under float16's smallest
normal, and 130 tokens, whose lse rows start off 16-byte boundaries),
held against its plain version with dk and dv exactly 0 past kv_len;
the build prints the registers, spills and wgmma serialization warnings
of its 16-bit instances (``build_flash_bwd_wg``). Then it drives the
imperative front end and serves generation at GPT-2-small widths
through ``GenerationEngine``:

- ``custom_op``: the flow of ``examples/custom_op.py`` on the card
  (a CustomOp through ``npx.custom``, an ``autograd.Function``,
  ``backward``, ``scale2`` through rtc), a kernel with ``grad=``, an
  opaque one and a numpy-backed CustomOp, held against closed forms,
  and ``np.matmul``/``np.dot`` of integer, bool and mixed-dtype
  operands held against the same calls on the CPU (``CARD_PRODUCTS``),
  and ``npx.topk`` on rows full of ties and the data movement of
  uint16/uint32 arrays in every dtype against the CPU
  (``_card_moves``);

- ``engine``: the dense fp32 engine, 24 greedy requests;
- ``bf16_engine``: the same requests on the dense engine with
  ``compute_dtype="bfloat16"`` at ``decode_ticks=4`` and then 1 (the
  same tokens), the reference's bf16 contract against the fp32 model
  on the card, and the card's bf16 logits against the CPU port's;
- ``paged_engine``: the paged engine with int8 weights (prefix sharing,
  peek, copy-on-write, chunked prefill), 24 greedy requests;
- ``int8_kv_engine``: the same traffic with int8 weights AND an int8 KV
  pool, 4 of the 24 requests sampled with fixed seeds (each repeated on
  a second engine: the same seed gives the same tokens; every sampled
  token inside its top-k set);
- ``paged_bf16_engine``: the paged int8-weight traffic under bf16
  compute at ``decode_ticks=4`` and then 1 (the same tokens), and the
  bf16 contract against the fp32 int8-weight model;
- ``dense_int8_kv_engine``: a dense int8-KV engine with fp32 weights, 8
  requests, then ``load_weights`` to another seed's weights and a
  second wave held against a fresh engine on those weights;
- ``spec_engine``, ``spec_paged_engine``, ``spec_sampled``: speculative
  decoding (``draft_model=``, ``spec_k=4``) with a damped 12-layer
  target and a 1-layer draft holding its embeddings, head and first
  block (``bench.py --spec``'s models): the model-level verify held to
  the decode chain (LOGIT_TOL; QNT_KV_TOL over an int8 pool) and one
  iteration's calls audited for host syncs and off-card tensors; 16 of
  the ``engine`` prompts on the dense engine and the paged int8-weight
  traffic, each against the non-speculative engine on the same target
  (every first divergence on a near-tie, below FLIP_GAP); 4 seeded
  sampled requests on two fresh engines (the same streams);
- ``lora_engine``: batched multi-tenant LoRA (``lora_rank=8,
  max_adapters=4``) on 16 of the ``engine`` prompts cycling base and
  three tenants, one refreshed and one unloaded while pinned during the
  traffic: base tokens equal the ``engine`` phase's, adapted ones
  against the CPU port (LOGIT_TOL, AGREE_MIN), the banks unmoved, a
  decode step profiled with and without LoRA;
- ``lora_paged_engine``: the paged int8-weight traffic with adapters
  on about half the requests: no adapted request reuses cached prefix
  pages, base ones do and keep the ``paged_engine`` phase's tokens;
- ``fp16_engine``: 16 of the ``engine`` prompts on
  ``GPTModel(dtype="float16")`` and the paged traffic at
  ``cache_dtype="float16"``, each against fp32 by the bf16 contract;

and holds the engines' tokens and logits against the same weights (and
int8 tables) run on the CPU. Last, ``train`` drives the training path:
``parallel.TrainStep`` on GPT-2 small, one seeded batch of 8 x 1024
tokens, 10 fp32 Adam steps, 10 at ``compute_dtype="bfloat16"`` and 3 on
a float16 model with fp32 masters, each with 12 K1 launches and 12 of
each K1-bwd launch a step, every parameter and state on the card; before
them the card's first two fp32 steps on a 2 x 128 batch against the CPU
port's, and after the fp32 and bf16 legs a profile of 3 steps. Every
phase prints one JSON line; any failure raises (exit code != 0) and no
result line is printed. The line
before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``.

Tolerances, with their reasons:
- rtc kernels vs their plain torch versions: the elementwise ones
  bitwise (the same fp32 operations, and ``2x + y`` rounds once either
  way: ``2x`` is exact); ``row_softmax`` max-abs-err <= 1e-6 (outputs
  in [0, 1], sums of 1024 terms in another order);
- kernel vs plain version on the same card inputs: max-abs-err of the
  attention output <= 2e-5 (fp32-accurate throughout: K1's products in
  3xTF32 keep about 22 bits, 2^-22 relative, and the two sum in
  different orders), of the log-sum-exp <= 1e-4 (a value of ~10 in fp32
  carries ~1e-6 per rounding, and exp/log add a few); K4's max-abs-err
  <= 2e-5 x max|ref| (fp32 sums of 768-3072 terms in another order;
  at M <= 8 x is split for the tensor cores as K1's operands are);
- a bf16 (float16) kernel vs its plain version run in fp32 on the
  widened inputs and rounded to its type: one step of the type, 2^-8
  (2^-10) x max(1, max|ref|) (both compute in fp32 before one rounding;
  see BF16_ULP, F16_ULP);
- a bf16 engine vs the fp32 model, teacher-forced: the reference's
  bounded-divergence contract, per-step logits within 0.25 and >= 90 %
  argmax agreement; the card's bf16 logits vs the CPU port's, both
  bf16: within 2 x 0.25 + 1e-3 (BF16_CARD_CPU_TOL), agreement >= 90 %,
  every disagreement on a gap below twice that;
- card logits vs the CPU forward of the same weights: <= 1e-3 (fp32
  reduction order over 12 layers of 768-wide products and a 50257-way
  head, on two devices and two BLAS libraries);
- greedy agreement of each engine with the CPU under teacher forcing:
  >= 99%, and every disagreement on a CPU top-1 vs engine-token logit
  gap below 2e-3 (two logits each within 1e-3 can only swap when their
  gap is below 2e-3). The int8 engines are held to the same weights AND
  the same int8 tables on the CPU, through the generation calls (the
  plain ``forward`` stays fp32, as in the reference);
- K1-bwd vs its plain version on the same card inputs: fp32 within
  1e-4 x max(1, max|ref|) (sums of up to 1024 products in another order);
  bf16 and float16 within two steps of their type, 2 x 2^-8 and
  2 x 2^-10 x max(1, max|ref|), of the plain version on the widened
  inputs rounded to the type (BWD_TOL); the small-dO case within the
  same BWD_TOL x max|ref| (its gradients are far below 1, where
  max(1, .) would make the gate absolute);
- training, card vs the CPU port (fp32, the same weights): losses within
  1e-4 relative, step-one gradients within 1e-3 x max|g| per tensor;
  bf16 losses within the reference's 0.15 of fp32's, and falling;
- the int8-KV engine: the reference's int8-KV gate (``bench.py
  --quant``), int8 KV against an fp32 KV with per-step logits within 0.6
  (the agreement of the two is reported; see
  ``phase_int8_kv_cpu_reference``), and card vs CPU agreement >= 99%
  with every disagreement on a gap below FLIP_GAP (derived there).

It imports torch, numpy and mxnet_tpu_torch only (never jax or the JAX
package). Without a CUDA device it exits with code 2 and prints no
result. ``--kernels-only`` stops after the kernel phases (a quick first
check of a kernel change) and prints no result line either.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet), used for bound_ms:
#: HBM3 bytes/s, fp32 FLOP/s outside the tensor cores, and the TF32
#: tensor cores' dense rate (K1 runs its products there in 3xTF32: three
#: TF32 products per fp32-accurate one), and the bf16 one (the bound of
#: the bf16 instances' work)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12

OUT_TOL = 2e-5
#: the train phase's attention, as ``_split_view`` takes it: batch 8 of
#: 1024 tokens, GPT-2 small's 12 heads of 64
TRAIN_SHAPE = (8, 1024, 12, 64)
LSE_TOL = 1e-4
LOGIT_TOL = 1e-3
AGREE_MIN = 0.99
#: the reference's int8-KV gate (bench.py --quant): per-step logit
#: max-abs-err of int8 KV against an fp32 KV, both with int8 weights
QNT_KV_TOL = 0.60
#: the share of int8 cache entries two implementations may quantize one
#: step apart (tests/test_torch_kvquant.py holds torch to XLA at it)
FLIP_FRAC = 1e-3
#: card vs CPU int8-KV disagreements sit on a logit gap below this
#: (derived in phase_int8_kv_cpu_reference)
FLIP_GAP = 2 * (LOGIT_TOL + 4 * FLIP_FRAC * QNT_KV_TOL)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(n_bytes, n_flops, peak_flops=PEAK_FP32_FLOPS):
    t_b, t_f = n_bytes / PEAK_BYTES_S, n_flops / peak_flops
    return (max(t_b, t_f) * 1e3,
            "bytes" if t_b >= t_f else "operations")


class Timer:
    """Per-call CUDA-event timing: median ms over ``iters`` calls after
    ``warm`` untimed ones. ``flush`` overwrites a 64 MiB buffer before
    every timed call, so the inputs come from HBM, not the 50 MB L2
    (a decode step finds its layer's cache cold: the other 11 layers
    ran in between).

    By default the events bracket the call's enqueue as well as its
    work: the card waits inside the interval for the host to enqueue
    the call through its Python wrapper, as it does in the engine's
    eager loop. This is the ``ms``, ``plain_ms`` and ``library_ms`` of
    the kernels line. A small kernel runs for less time than that
    enqueue, so ``device=True`` starts each timed call behind a
    device-side sleep (``torch.cuda._sleep``) long enough to cover it:
    the card reaches the first event only when the call's work is
    already queued, and the interval is device time (the ``*_device``
    fields)."""

    SLEEP_CYCLES = 5_000_000    # ~2.5 ms at the H100's ~2 GHz

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=30, warm=3, flush=False, device=False):
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            if flush:
                self.buf.zero_()
            if device:
                torch.cuda._sleep(self.SLEEP_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    def both(self, fn, flush=False):
        """``(enqueue-inclusive ms, device ms)`` of ``fn``."""
        return self(fn, flush=flush), self(fn, flush=flush, device=True)


TIMING_KEYS = ("kernel_ms", "kernel_ms_device", "plain_ms",
               "plain_ms_device", "library_ms", "library_ms_device")


def timings(timer, flush, kernel, plain, library):
    """The kernel's, its plain version's and the library call's times,
    each enqueue-inclusive (``*_ms``) and device-only
    (``*_ms_device``)."""
    out = {}
    for key, fn in (("kernel", kernel), ("plain", plain),
                    ("library", library)):
        out[f"{key}_ms"], out[f"{key}_ms_device"] = timer.both(fn, flush)
    return out


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", nvidia_smi=card, python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return card


def _wg_resources(lines, kernel="flash_bwd_wg_kernel"):
    """ptxas's registers and spill bytes of each instance of ``kernel``
    (head dim, element type, launch from its mangled name), and its
    performance warnings (wgmma serialized: C7512, C7515, C7520)."""
    pat = re.compile(kernel + r"ILi(\d+)E\w*?(bfloat16|half)Lb([01])E")
    out, cur = [], None
    for ln in lines:
        m = pat.search(ln)
        if "Compiling entry" in ln:
            cur = None
            if m:
                cur = {"head_dim": int(m.group(1)),
                       "type": "bf16" if m.group(2) == "bfloat16" else "f16",
                       "launch": "dkv" if m.group(3) == "1" else "dq"}
                out.append(cur)
        elif cur is not None and "spill stores" in ln:
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", ln)
            cur["spill_stores"], cur["spill_loads"] = map(int, st.groups())
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    warnings = [ln for ln in lines if "Performance Loss" in ln
                and kernel in ln]
    return out, warnings


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=_build.build_info)
    # K1-bwd's 16-bit instances: registers, spills and wgmma serialization
    inst, warnings = _wg_resources(
        _build.build_info.get("flash_attention_bwd", {}).get("ptxas", []))
    emit("build_flash_bwd_wg", instances=inst, ptxas_warnings=warnings)


def _rand(torch, rng, *shape):
    return torch.from_numpy(
        (rng.standard_normal(shape) * 0.5).astype("f4")).cuda()


def _split_view(torch, rng, b, s, h, d):
    """A (B, H, S, D) view of a (B, S, H*D) projection — the layout the
    model's head split hands the kernels (strided, not contiguous)."""
    return _rand(torch, rng, b, s, h * d).reshape(b, s, h, d).transpose(1, 2)


def phase_flash(torch, timer):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    rng = np.random.RandomState(0)
    b, h, d = 1, 12, 64
    scale = 1.0 / math.sqrt(d)
    cases, err_o, err_l = [], 0.0, 0.0

    def compare(q, k, v, causal, kv_len, tag):
        nonlocal err_o, err_l
        out, lse = at.flash_attention_fwd(q, k, v, causal, None, kv_len)
        # the plain version's p @ v would carry 0 * NaN from past kv_len
        k, v = torch.nan_to_num(k), torch.nan_to_num(v)
        ref, ref_lse = at._blockwise_fwd(q, k, v, causal,
                                         1.0 / math.sqrt(q.shape[-1]),
                                         kv_len=kv_len)
        torch.cuda.synchronize()
        eo = float((out - ref).abs().max())
        el = float((lse - ref_lse).abs().max())
        check(bool(torch.isfinite(out).all()), f"K1 non-finite out {tag}")
        cases.append({"case": tag, "out_err": eo, "lse_err": el})
        err_o, err_l = max(err_o, eo), max(err_l, el)

    for s in (1, 37, 128, 512, 1000):
        for causal in (False, True):
            q, k, v = (_rand(torch, rng, b, h, s, d) for _ in range(3))
            compare(q, k, v, causal, None, f"s={s} causal={causal}")
    kbuf, vbuf = (_rand(torch, rng, b, h, 96, d) for _ in range(2))
    for sq, kvl in ((16, 70), (1, 33), (70, 70)):
        q = _rand(torch, rng, b, h, sq, d)
        compare(q, kbuf, vbuf, True, kvl, f"sq={sq} kv_len={kvl}")
    for hd in (16, 32, 128):
        q, k, v = (_rand(torch, rng, 2, 3, 77, hd) for _ in range(3))
        compare(q, k, v, True, None, f"head_dim={hd}")
    # the model's full context (every q-tile at full depth, the
    # heaviest first), and a 1000-key buffer with NaN past kv_len = 999:
    # the zero-filled rows are never read
    full = [_rand(torch, rng, b, h, 1024, d) for _ in range(3)]
    compare(*full, True, None, "s=1024 causal")
    kn, vn = (_rand(torch, rng, b, h, 1000, d) for _ in range(2))
    kn[:, :, 999:], vn[:, :, 999:] = float("nan"), float("nan")
    q = _rand(torch, rng, b, h, 300, d)
    compare(q, kn, vn, True, 999, "sq=300 kv_len=999 NaN past it")
    # the prefill's own layout: strided views out of the head split
    sp = 512
    q, k, v = (_split_view(torch, rng, b, sp, h, 128) for _ in range(3))
    compare(q, k, v, True, None, f"strided s={sp} head_dim=128 causal")
    q, k, v = (_split_view(torch, rng, b, sp, h, d) for _ in range(3))
    check(not q.is_contiguous(), "strided case is contiguous")
    compare(q, k, v, True, None, f"strided s={sp} causal")
    qt, kt, vt = (_split_view(torch, rng, *TRAIN_SHAPE) for _ in range(3))
    compare(qt, kt, vt, True, None, "train shape strided causal")
    del qt, kt, vt
    emit("flash_attention_check", cases=cases)
    check(err_o <= OUT_TOL, f"K1 out max-abs-err {err_o} > {OUT_TOL}")
    check(err_l <= LSE_TOL, f"K1 lse max-abs-err {err_l} > {LSE_TOL}")

    def work(s, hd):
        pairs = s * (s + 1) // 2                     # visible (q, k) pairs
        n_flops = 4 * hd * b * h * pairs             # q.k and p.v
        n_bytes = 4 * (4 * b * h * s * hd + b * h * s)   # q, k, v, out, lse
        return n_bytes, n_flops

    # timing at the prefill shape (1, 12, 512, 64), causal, strided
    times = timings(
        timer, False,
        lambda: at.flash_attention_fwd(q, k, v, True),
        lambda: at._blockwise_fwd(q, k, v, True, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    n_bytes, n_flops = work(sp, d)
    # the least time for this fp32-accurate work: 3xTF32 on the tensor
    # cores; beside it the fp32 CUDA cores' figure (the bound of a
    # kernel that keeps off the tensor cores)
    bound_ms, bound_by = bound(n_bytes, 3 * n_flops, PEAK_TF32_FLOPS)
    fp32_ms, fp32_by = bound(n_bytes, n_flops)
    # the other full-depth shapes, device time beside SDPA's
    per_shape = []
    for s, hd, (qq, kk, vv) in ((1024, d, full), (sp, 128, (None,) * 3)):
        if qq is None:
            qq, kk, vv = (_split_view(torch, rng, b, s, h, hd)
                          for _ in range(3))
        nb, nf = work(s, hd)
        per_shape.append({
            "shape": [b, h, s, hd], "causal": True,
            "kernel_ms_device": timer(
                lambda: at.flash_attention_fwd(qq, kk, vv, True),
                device=True),
            "library_ms_device": timer(
                lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                       is_causal=True),
                device=True),
            "bound_ms": bound(nb, 3 * nf, PEAK_TF32_FLOPS)[0]})
    res = {"max_abs_err": err_o, "max_abs_err_lse": err_l, **times,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_fp32_cores": fp32_ms, "bound_by_fp32_cores": fp32_by,
           "bound_rule": "3 x FLOP at 495 TFLOP/s (3xTF32) vs bytes at "
                         "3.35 TB/s",
           "shape": [b, h, sp, d], "per_shape": per_shape}
    emit("flash_attention", **res)
    return res


#: K2's check sets beyond the timed shape: (tag, lengths, S, layout).
#: The split plan gives each of the 8 cluster ranks 128 keys at S = 1024
#: (and at S = 1000, where the last rank holds 104), so "edges" puts
#: lengths on either side of rank boundaries (128k - 1, 128k, 128k + 1).
#: "slice" is a cache that is a view k_big[:, :, :S] of a longer buffer
#: (rows contiguous, (slot, head) rows further apart); "strided" a view
#: k_big[:, :, ::2] whose rows are not contiguous, which takes the
#: kernel's copy-a-row path.
DENSE_CHECK_SETS = [
    ("edges", [0, 127, 128, 129, 511, 512, 513, 895, 896, 897], 1024,
     "dense"),
    ("S=1000", [0, 1, 127, 128, 129, 500, 999, 1000], 1000, "dense"),
    ("slice", [0, 1, 63, 64, 65, 500, 1023, 1024], 1024, "slice"),
    ("strided", [0, 1, 63, 64, 65, 500, 1023, 1024], 1024, "strided"),
]


def _dense_cache(torch, rng, lengths, h, s, d, layout="dense"):
    """A (B, H, S, D) fp32 cache laid out as ``layout`` (see
    DENSE_CHECK_SETS) with NaN past every length, and an int8 cache of
    the same values in the same layout: (B, H) scales from the live
    rows' amax, random int8 past every length and NaN scales on every
    empty slot. Returns the lengths, the live mask, the two fp32 views,
    the two int8 views and the scales."""
    from mxnet_tpu_torch.ops import quantized as qz
    b = len(lengths)
    rows = {"dense": s, "slice": s + 76, "strided": 2 * s}[layout]

    def view(t):
        return {"dense": t, "slice": t[:, :, :s],
                "strided": t[:, :, ::2]}[layout]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    live = (torch.arange(s, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, :, None]     # (B, 1, S, 1)
    kn, vn = (view(_rand(torch, rng, b, h, rows, d)) for _ in range(2))
    kz, vz = kn * live, vn * live
    for t in (kn, vn):
        t.masked_fill_(~live, float("nan"))    # in place: the view stays
    ks, vs = qz.kv_scale(kz, (2, 3)), qz.kv_scale(vz, (2, 3))
    kq, vq = (view(torch.from_numpy(rng.randint(-127, 128, (b, h, rows, d))
                                    .astype("i1")).cuda()) for _ in range(2))
    for t, z, sc in ((kq, kz, ks), (vq, vz, vs)):
        t.copy_(torch.where(live, qz.kv_quantize(z, sc[:, :, None, None]),
                            t))
    empty = lens == 0
    ks[empty], vs[empty] = float("nan"), float("nan")
    return lens, live, (kn, vn), (kq, vq), (ks, vs)


def phase_decode(torch, timer):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    rng = np.random.RandomState(1)
    b, h, s, d = 8, 12, 1024, 64
    scale = 1.0 / math.sqrt(d)
    lengths = [0, 1, 63, 64, 65, 500, 1023, 1024]
    lens, live, (kn, vn), (kq, vq), (ks, vs) = _dense_cache(
        torch, rng, lengths, h, s, d)
    kz, vz = kn.nan_to_num(0.0), vn.nan_to_num(0.0)   # garbage zeroed
    # every case through both instances: the timed shape at sq = 1, 4
    # and 5, then each check set at sq = 1 and 4
    sets = [(lens, (kn, vn), (kq, vq, ks, vs),
             [(f"sq={sq}", _split_view(torch, rng, b, sq, h, d))
              for sq in (1, 4, 5)])]
    for tag, lns, s2, layout in DENSE_CHECK_SETS:
        l2, _, kv, kv8, sc8 = _dense_cache(torch, rng, lns, h, s2, d,
                                           layout)
        sets.append((l2, kv, (*kv8, *sc8), [
            (f"{tag} sq={sq}", _split_view(torch, rng, len(lns), sq, h, d))
            for sq in (1, 4)]))
    cases, cases8, err, err8 = [], [], 0.0, 0.0
    for ln, (k2, v2), (kq2, vq2, ks2, vs2), runs in sets:
        zero = [i for i, n in enumerate(ln.tolist()) if n == 0]
        for tag, q in runs:
            out = at.decode_attention(q, k2, v2, ln)
            ref = at._decode_fwd_torch(q, k2, v2, ln, scale)
            out8 = at.decode_attention(q, kq2, vq2, ln, k_scale=ks2,
                                       v_scale=vs2)
            ref8 = at._decode_fwd_torch(q, at._dequantize(kq2, ks2),
                                        at._dequantize(vq2, vs2), ln, scale)
            torch.cuda.synchronize()
            for inst, o, r, acc in (("K2", out, ref, cases),
                                    ("K2-int8", out8, ref8, cases8)):
                check(bool(torch.isfinite(o).all()),
                      f"{inst} non-finite output with NaN past the lengths "
                      f"({tag})")
                check(all(float(o[i].abs().max()) == 0.0 for i in zero),
                      f"{inst} len=0 row not zero ({tag})")
                acc.append({"case": tag, "out_err": float((o - r).abs().max()),
                            "lengths": ln.tolist(), "S": int(k2.shape[2]),
                            "k_strides": list(k2.stride())})
            err = max(err, cases[-1]["out_err"])
            err8 = max(err8, cases8[-1]["out_err"])
    emit("decode_attention_check", cases=cases)
    check(err <= OUT_TOL, f"K2 max-abs-err {err} > {OUT_TOL}")
    emit("decode_attention_int8_check", cases=cases8)
    check(err8 <= OUT_TOL, f"K2-int8 max-abs-err {err8} > {OUT_TOL}")

    q = _split_view(torch, rng, b, 1, h, d)    # the decode step's layout
    mask = live[:, :, :, 0][:, :, None, :]     # (B, 1, 1, S) bool
    times = timings(
        timer, True,
        lambda: at.decode_attention(q, kn, vn, lens),
        lambda: at._decode_fwd_torch(q, kn, vn, lens, scale),
        lambda: F.scaled_dot_product_attention(q, kz, vz, attn_mask=mask))
    total = sum(lengths)                        # K/V rows this data needs
    n_bytes = 4 * (2 * total * h * d + 2 * b * h * d) + 4 * b
    n_flops = 4 * d * h * total
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"max_abs_err": err, **times, "bound_ms": bound_ms,
           "bound_by": bound_by, "shape": [b, h, s, d], "lengths": lengths}
    emit("decode_attention", **res)

    # the int8 instance: per-(slot, head) scales from the live rows'
    # amax, random int8 garbage past every length and a NaN scale on
    # the empty slot
    kd, vd = at._dequantize(kq, ks), at._dequantize(vq, vs)
    q = _split_view(torch, rng, b, 1, h, d)
    kdz, vdz = kd * live, vd * live           # for the library yardstick
    kdz[0], vdz[0] = 0.0, 0.0
    times8 = timings(
        timer, True,
        lambda: at.decode_attention(q, kq, vq, lens, k_scale=ks, v_scale=vs),
        lambda: at._decode_fwd_torch(q, at._dequantize(kq, ks),
                                     at._dequantize(vq, vs), lens, scale),
        lambda: F.scaled_dot_product_attention(q, kdz, vdz, attn_mask=mask))
    n_bytes = 2 * total * h * d + 4 * (2 * b * h * d + 2 * b * h) + 4 * b
    bound8 = bound(n_bytes, n_flops)
    res8 = {"max_abs_err": err8, **times8, "bound_ms": bound8[0],
            "bound_by": bound8[1],
            "library": "scaled_dot_product_attention over the dequantized "
                       "fp32 view (dequantize not timed)",
            "shape": [b, h, s, d], "lengths": lengths}
    emit("decode_attention_int8", **res8)
    return res, res8


def _paged_inputs(torch, rng, lengths, h, ps, d, p_max, n_pages):
    """Pools of ``n_pages`` pages with each slot's pages at shuffled
    places: rows before each slot's length hold data; the scrap page 0,
    every unreferenced page and every row at or past a length hold NaN.
    Returns the table, the lengths, the NaN pools and the gathered
    dense views with the garbage zeroed (for the library yardstick)."""
    b = len(lengths)
    need = [-(-n // ps) for n in lengths]
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, p_max), "i4")
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n]
        at += n
    shape = (n_pages, h, ps, d)
    kp = np.full(shape, np.nan, "f4")
    vp = np.full(shape, np.nan, "f4")
    for i, n in enumerate(lengths):
        for t in range(n):
            pg, r = table[i, t // ps], t % ps
            kp[pg, :, r] = rng.standard_normal((h, d)) * 0.5
            vp[pg, :, r] = rng.standard_normal((h, d)) * 0.5
    tbl = torch.from_numpy(table).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kn, vn = torch.from_numpy(kp).cuda(), torch.from_numpy(vp).cuda()
    return tbl, lens, kn, vn


def _int8_paged(torch, rng, table, lengths, ps, shape):
    """Random int8 pools over ``shape`` (every row, the garbage past
    each length included), per-page scales on the pages the lengths
    reach and NaN scales on the scrap page and every unreferenced
    page."""
    n_pages, h = shape[0], shape[1]
    tbl = table.cpu().numpy()
    used = sorted({int(tbl[i, j]) for i, n in enumerate(lengths)
                   for j in range(-(-n // ps))})
    kq8, vq8 = (torch.from_numpy(rng.randint(-127, 128, shape)
                                 .astype("i1")).cuda() for _ in range(2))
    ksc, vsc = (torch.full((n_pages, h), float("nan"), device="cuda")
                for _ in range(2))
    idx = torch.tensor(used, device="cuda")
    for sc in (ksc, vsc):
        sc[idx] = torch.from_numpy(
            (rng.random_sample((len(used), h)) * 0.02 + 0.005)
            .astype("f4")).cuda()
    return kq8, vq8, ksc, vsc


#: K3's check sets beyond the timed shape: (tag, lengths, P_max). The
#: split plan gives each of the 8 cluster ranks 8 pages (128 keys) at
#: P_max = 64, so "edges" puts lengths on either side of rank
#: boundaries (128k - 1, 128k, 128k + 1); at P_max = 61 the last rank
#: holds 5 pages. Lengths that end mid-page (500, 129, 975, ...) leave
#: NaN in that page's tail rows.
PAGED_CHECK_SETS = [
    ("edges", [0, 127, 128, 129, 511, 512, 513, 895, 896, 897], 64),
    ("p_max=61", [0, 1, 500, 975, 976], 61),
]


def phase_paged_decode(torch, timer):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    rng = np.random.RandomState(3)
    b, h, ps, d, p_max, n_pages = 8, 12, 16, 64, 64, 513
    scale = 1.0 / math.sqrt(d)
    lengths = [0, 1, 15, 16, 17, 500, 1023, 1024]
    tbl, lens, kn, vn = _paged_inputs(torch, rng, lengths, h, ps, d, p_max,
                                      n_pages)
    kq8, vq8, ksc, vsc = _int8_paged(torch, rng, tbl, lengths, ps, kn.shape)

    def plain8(q, table, ln, kq8, vq8, ksc, vsc):
        return at._decode_fwd_torch(q, _int8_view(at, kq8, ksc, table, ps),
                                    _int8_view(at, vq8, vsc, table, ps), ln,
                                    scale)

    # every case through both instances: the timed shape at sq = 1 and
    # 4 and the peek (one slot, B = 1, its own (1, P_max) table row),
    # then each check set at sq = 1 and 4
    sets = [((kn, vn), (kq8, vq8, ksc, vsc), [
        ("sq=1", _split_view(torch, rng, b, 1, h, d), tbl, lens),
        ("sq=4", _split_view(torch, rng, b, 4, h, d), tbl, lens),
        ("peek b=1 len=500", _split_view(torch, rng, 1, 1, h, d),
         tbl[5:6].contiguous(), lens[5:6].contiguous())])]
    for tag, lns, pm in PAGED_CHECK_SETS:
        t2, l2, k2, v2 = _paged_inputs(torch, rng, lns, h, ps, d, pm,
                                       n_pages)
        i8 = _int8_paged(torch, rng, t2, lns, ps, k2.shape)
        sets.append(((k2, v2), i8, [
            (f"{tag} sq={sq}", _split_view(torch, rng, len(lns), sq, h, d),
             t2, l2) for sq in (1, 4)]))
    cases, cases8, err, err8 = [], [], 0.0, 0.0
    for (kp, vp), i8, runs in sets:
        for tag, q, table, ln in runs:
            zero = [i for i, n in enumerate(ln.tolist()) if n == 0]
            out = at.paged_decode_attention(q, kp, vp, table, ln)
            ref = at._decode_fwd_torch(q, at.gather_pages(kp, table),
                                       at.gather_pages(vp, table), ln, scale)
            out8 = at.paged_decode_attention(q, i8[0], i8[1], table, ln,
                                             k_scale=i8[2], v_scale=i8[3])
            ref8 = plain8(q, table, ln, *i8)
            torch.cuda.synchronize()
            for inst, o, r, acc in (("K3", out, ref, cases),
                                    ("K3-int8", out8, ref8, cases8)):
                check(bool(torch.isfinite(o).all()),
                      f"{inst} non-finite output with NaN garbage ({tag})")
                check(all(float(o[i].abs().max()) == 0.0 for i in zero),
                      f"{inst} len=0 row not zero ({tag})")
                e = float((o - r).abs().max())
                acc.append({"case": tag, "out_err": e,
                            "lengths": ln.tolist(),
                            "P_max": int(table.shape[1])})
            err = max(err, cases[-1]["out_err"])
            err8 = max(err8, cases8[-1]["out_err"])
    emit("paged_decode_attention_check", cases=cases)
    check(err <= OUT_TOL, f"K3 max-abs-err {err} > {OUT_TOL}")
    emit("paged_decode_attention_int8_check", cases=cases8)
    check(err8 <= OUT_TOL, f"K3-int8 max-abs-err {err8} > {OUT_TOL}")

    q = _split_view(torch, rng, b, 1, h, d)     # the decode step's layout
    kz = torch.nan_to_num(at.gather_pages(kn, tbl), nan=0.0)
    vz = torch.nan_to_num(at.gather_pages(vn, tbl), nan=0.0)
    live = torch.arange(p_max * ps, device="cuda")[None, :] \
        < lens.long()[:, None]
    mask = live[:, None, None, :]               # (B, 1, 1, S) bool
    times = timings(
        timer, True,
        lambda: at.paged_decode_attention(q, kn, vn, tbl, lens),
        lambda: at._decode_fwd_torch(q, at.gather_pages(kn, tbl),
                                     at.gather_pages(vn, tbl), lens, scale),
        lambda: F.scaled_dot_product_attention(q, kz, vz, attn_mask=mask))
    total = sum(lengths)
    n_bytes = 4 * (2 * total * h * d + 2 * b * h * d) + 4 * b * (p_max + 1)
    n_flops = 4 * d * h * total
    bound_ms, bound_by = bound(n_bytes, n_flops)
    shape = {"B": b, "H": h, "page_size": ps, "D": d, "P_max": p_max,
             "n_pages": n_pages}
    res = {"max_abs_err": err, **times,
           "library": "scaled_dot_product_attention on the pre-gathered "
                      "dense view with a bool mask (gather not timed)",
           "bound_ms": bound_ms, "bound_by": bound_by, "shape": shape,
           "lengths": lengths}
    emit("paged_decode_attention", **res)

    q = _split_view(torch, rng, b, 1, h, d)
    kd, vd = (torch.nan_to_num(_int8_view(at, pool, sc, tbl, ps), nan=0.0)
              * live[:, None, :, None]
              for pool, sc in ((kq8, ksc), (vq8, vsc)))
    times8 = timings(
        timer, True,
        lambda: at.paged_decode_attention(q, kq8, vq8, tbl, lens,
                                          k_scale=ksc, v_scale=vsc),
        lambda: plain8(q, tbl, lens, kq8, vq8, ksc, vsc),
        lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
    n_used = sum(-(-n // ps) for n in lengths)
    n_bytes = (2 * total * h * d + 4 * (2 * b * h * d) + 4 * b * (p_max + 1)
               + 4 * 2 * h * n_used)
    bound8 = bound(n_bytes, n_flops)
    res8 = {"max_abs_err": err8, **times8, "bound_ms": bound8[0],
            "bound_by": bound8[1],
            "library": "scaled_dot_product_attention over the gathered, "
                       "dequantized fp32 view (gather and dequantize not "
                       "timed)",
            "shape": shape, "lengths": lengths}
    emit("paged_decode_attention_int8", **res8)
    return res, res8


def _int8_view(at, pool, scales, table, ps):
    """The gathered, dequantized fp32 view of an int8 pool: the plain
    version's input."""
    return at._dequantize(at.gather_pages(pool, table),
                          at.expand_page_scales(scales, table, ps))


# ---- the 16-bit (bf16 and float16) instances of K1, K2 and K3 -----------
#: a 16-bit kernel (bf16 or float16) vs its plain version run in fp32
#: on the widened inputs and rounded to the 16-bit type: the kernels
#: compute in fp32 from the 16-bit bytes (as the reference's Pallas
#: kernels do), so the two differ by fp32 rounding before the output's
#: one rounding, which may then land one step apart: at most 2^-8 of the
#: output's magnitude in bf16 (8 significant bits), 2^-10 in float16
#: (11), taken as max(1, max|ref|). The lse stays fp32 (LSE_TOL).
BF16_ULP = 2.0 ** -8
F16_ULP = 2.0 ** -10
#: the 16-bit instances: their tag in kernel and phase names, and ULP
HALF_TYPES = {"bf16": ("bfloat16", BF16_ULP), "f16": ("float16", F16_ULP)}


def _half_err(out, ref, ulp):
    """max|out - ref| over the 16-bit tolerance of ``ref``'s
    magnitude."""
    e = float((out.float() - ref.float()).abs().max())
    return e, ulp * max(1.0, float(ref.float().abs().max()))


def phase_flash_half(torch, timer, tag):
    """K1's bf16 or float16 instance (``tag``): the fp32 phase's cases on
    16-bit q/k/v, each against the plain version on the widened inputs
    rounded to the 16-bit type (and, reported, against the plain version
    run on the 16-bit inputs)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    name, ulp = HALF_TYPES[tag]
    dt = getattr(torch, name)
    rng = np.random.RandomState(10)
    kind = tag
    b, h, d = 1, 12, 64
    scale = 1.0 / math.sqrt(d)
    cases, worst, err_o, err_l, gap_plain = [], 0.0, 0.0, 0.0, 0.0

    def compare(q, k, v, causal, kv_len, tag, scale=None):
        nonlocal worst, err_o, err_l, gap_plain
        out, lse = at.flash_attention_fwd(q, k, v, causal, scale, kv_len)
        k, v = torch.nan_to_num(k), torch.nan_to_num(v)
        sc = scale or 1.0 / math.sqrt(q.shape[-1])
        ref, ref_lse = at._blockwise_fwd(q.float(), k.float(), v.float(),
                                         causal, sc, kv_len=kv_len)
        plain = at._blockwise_fwd(q, k, v, causal, sc, kv_len=kv_len)[0]
        torch.cuda.synchronize()
        check(out.dtype == dt and lse.dtype == torch.float32,
              f"K1-{kind} output types {out.dtype}, {lse.dtype}")
        check(bool(torch.isfinite(out).all()), f"K1-{kind} non-finite {tag}")
        eo, tol = _half_err(out, ref.to(dt), ulp)
        el = float((lse - ref_lse).abs().max())
        ep = float((out.float() - plain.float()).abs().max())
        cases.append({"case": tag, "out_err": eo, "tol": tol, "lse_err": el,
                      "vs_plain_16bit": ep})
        worst, err_o = max(worst, eo / tol), max(err_o, eo)
        err_l, gap_plain = max(err_l, el), max(gap_plain, ep)

    for s in (1, 37, 128, 512, 1000):
        for causal in (False, True):
            q, k, v = (_rand(torch, rng, b, h, s, d).to(dt)
                       for _ in range(3))
            compare(q, k, v, causal, None, f"s={s} causal={causal}")
    kbuf, vbuf = (_rand(torch, rng, b, h, 96, d).to(dt) for _ in range(2))
    for sq, kvl in ((16, 70), (1, 33), (70, 70)):
        q = _rand(torch, rng, b, h, sq, d).to(dt)
        compare(q, kbuf, vbuf, True, kvl, f"sq={sq} kv_len={kvl}")
    for hd in (16, 32, 128):
        q, k, v = (_rand(torch, rng, 2, 3, 77, hd).to(dt)
                   for _ in range(3))
        compare(q, k, v, True, None, f"head_dim={hd}")
    full = [_rand(torch, rng, b, h, 1024, d).to(dt) for _ in range(3)]
    compare(*full, True, None, "s=1024 causal")
    kn, vn = (_rand(torch, rng, b, h, 1000, d).to(dt) for _ in range(2))
    kn[:, :, 999:], vn[:, :, 999:] = float("nan"), float("nan")
    q = _rand(torch, rng, b, h, 300, d).to(dt)
    compare(q, kn, vn, True, 999, "sq=300 kv_len=999 NaN past it")
    sp = 512
    q, k, v = (_split_view(torch, rng, b, sp, h, 128).to(dt)
               for _ in range(3))
    compare(q, k, v, True, None, f"strided s={sp} head_dim=128 causal")
    q, k, v = (_split_view(torch, rng, b, sp, h, d).to(dt)
               for _ in range(3))
    check(not q.is_contiguous(), "strided case is contiguous")
    compare(q, k, v, True, None, f"strided s={sp} causal")
    qt, kt, vt = (_split_view(torch, rng, *TRAIN_SHAPE).to(dt)
                  for _ in range(3))
    compare(qt, kt, vt, True, None, "train shape strided causal")
    del qt, kt, vt
    # a negative scale takes the kernel's other softmax path (scale, mask
    # to -1e30, re-mask after the exp)
    qn, kn2, vn2 = (_rand(torch, rng, b, 4, n, d).to(dt)
                    for n in (200, 300, 300))
    compare(qn, kn2, vn2, True, 250, "scale=-0.2 sq=200 kv_len=250",
            scale=-0.2)
    emit(f"flash_attention_{tag}_check", cases=cases)
    check(worst <= 1.0, f"K1-{tag} off its widened plain version by "
          f"{worst} {tag} tolerances")
    check(err_l <= LSE_TOL, f"K1-{tag} lse max-abs-err {err_l} > {LSE_TOL}")

    times = timings(
        timer, False,
        lambda: at.flash_attention_fwd(q, k, v, True),
        lambda: at._blockwise_fwd(q, k, v, True, scale),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    pairs = sp * (sp + 1) // 2
    n_flops = 4 * d * b * h * pairs
    n_bytes = 2 * 4 * b * h * sp * d + 4 * b * h * sp   # q k v out; lse
    bound_ms, bound_by = bound(n_bytes, n_flops, PEAK_BF16_FLOPS)
    # the kernel's own products: Q K^T once, P V twice (P in 16-bit hi +
    # lo)
    products_ms, _ = bound(n_bytes, 1.5 * n_flops, PEAK_BF16_FLOPS)
    kk = full
    per_shape = [{
        "shape": [b, h, 1024, d], "causal": True,
        "kernel_ms_device": timer(
            lambda: at.flash_attention_fwd(*kk, True), device=True),
        "library_ms_device": timer(
            lambda: F.scaled_dot_product_attention(*kk, is_causal=True),
            device=True),
        "bound_ms": bound(2 * 4 * b * h * 1024 * d + 4 * b * h * 1024,
                          4 * d * b * h * 1024 * 1025 // 2,
                          PEAK_BF16_FLOPS)[0]}]
    res = {"max_abs_err": err_o, "max_tol_ratio": worst,
           "max_abs_err_lse": err_l, f"max_gap_to_plain_{tag}": gap_plain,
           **times, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_ms_kernel_products": products_ms,
           "bound_rule": f"{tag} FLOP at 989 TFLOP/s vs bytes at 3.35 "
                         f"TB/s (the kernel's products, Q K^T once and P "
                         f"V twice, 1.5 x FLOP: bound_ms_kernel_products)",
           "library": f"scaled_dot_product_attention on the same {tag} "
                      f"tensors, causal",
           "shape": [b, h, sp, d], "per_shape": per_shape}
    emit(f"flash_attention_{tag}", **res)
    return res


def _decode_half_check(torch, dt, ulp, kern, plain_fp32, plain_half, q, ln,
                       tag, cases):
    """One 16-bit decode case: the kernel's output type (``dt``, the
    cache's) and finiteness, exact zeros at len 0, and its distance to
    the widened plain version rounded to ``dt`` (in ``ulp`` tolerances)
    and to the plain path on the 16-bit inputs."""
    out = kern(q)
    ref = plain_fp32(q.float()).to(dt)
    pl = plain_half(q)
    torch.cuda.synchronize()
    check(out.dtype == dt, f"{tag}: output {out.dtype}")
    check(bool(torch.isfinite(out).all()), f"{tag}: non-finite output "
          "with NaN past the lengths")
    zero = [i for i, n in enumerate(ln.tolist()) if n == 0]
    check(all(float(out[i].abs().max()) == 0.0 for i in zero),
          f"{tag}: len=0 row not zero")
    e, tol = _half_err(out, ref, ulp)
    cases.append({"case": tag, "q": str(q.dtype).replace("torch.", ""),
                  "out_err": e, "tol": tol,
                  "vs_plain_16bit": float((out.float() - pl.float())
                                          .abs().max()),
                  "lengths": ln.tolist()})


def _half_summary(cases, tag):
    """The worst case of a 16-bit check: its max-abs-err, its ratio to
    the tolerance and the widest gap to the plain 16-bit path."""
    return {"max_abs_err": max(c["out_err"] for c in cases),
            "max_tol_ratio": max(c["out_err"] / c["tol"] for c in cases),
            f"max_gap_to_plain_{tag}": max(c["vs_plain_16bit"]
                                           for c in cases)}


def phase_decode_half(torch, timer, tag):
    """K2's bf16 or float16 instance (``tag``) over caches of that type:
    the fp32 phase's cases (the timed shape at sq = 1, 4, 5 and every
    check set at sq = 1, 4), each with a q of the cache's type (the
    16-bit model) and an fp32 q (int8 weights, or an fp32 model, over a
    16-bit cache)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    name, ulp = HALF_TYPES[tag]
    dt = getattr(torch, name)
    rng = np.random.RandomState(11)
    kind = tag
    b, h, s, d = 8, 12, 1024, 64
    scale = 1.0 / math.sqrt(d)
    lengths = [0, 1, 63, 64, 65, 500, 1023, 1024]
    lens, live, (kn, vn), _, _ = _dense_cache(torch, rng, lengths, h, s, d)
    kb, vb = kn.to(dt), vn.to(dt)
    sets = [(lens, (kb, vb), [(f"sq={sq}", _split_view(torch, rng, b, sq, h,
                                                       d))
                              for sq in (1, 4, 5)])]
    for tag, lns, s2, layout in DENSE_CHECK_SETS:
        l2, _, (k2, v2), _, _ = _dense_cache(torch, rng, lns, h, s2, d,
                                             layout)
        if layout != "dense":   # the same view of a 16-bit buffer
            k2, v2 = (t._base.to(dt).as_strided(t.shape, t.stride(),
                                                t.storage_offset())
                      for t in (k2, v2))
        else:
            k2, v2 = k2.to(dt), v2.to(dt)
        sets.append((l2, (k2, v2), [
            (f"{tag} sq={sq}", _split_view(torch, rng, len(lns), sq, h, d))
            for sq in (1, 4)]))
    cases = []
    for ln, (k2, v2), runs in sets:
        for tag, q in runs:
            for qq in (q.to(dt), q):
                _decode_half_check(
                    torch, dt, ulp,
                    lambda x: at.decode_attention(x, k2, v2, ln),
                    lambda x: at._decode_fwd_torch(x, k2.float(), v2.float(),
                                                   ln, scale),
                    lambda x: at._decode_fwd_torch(x, k2, v2, ln, scale),
                    qq, ln, f"K2-{kind} {tag}", cases)
    emit(f"decode_attention_{kind}_check", cases=cases)
    summary = _half_summary(cases, kind)
    check(summary["max_tol_ratio"] <= 1.0, f"K2-{kind} off its widened "
          f"plain version by {summary['max_tol_ratio']} {kind} tolerances")

    q = _split_view(torch, rng, b, 1, h, d).to(dt)
    mask = live[:, :, :, 0][:, :, None, :]
    kz, vz = kb.nan_to_num(0.0), vb.nan_to_num(0.0)
    times = timings(
        timer, True,
        lambda: at.decode_attention(q, kb, vb, lens),
        lambda: at._decode_fwd_torch(q, kb, vb, lens, scale),
        lambda: F.scaled_dot_product_attention(q, kz, vz, attn_mask=mask))
    total = sum(lengths)
    n_bytes = 2 * (2 * total * h * d + 2 * b * h * d) + 4 * b
    bound_ms, bound_by = bound(n_bytes, 4 * d * h * total, PEAK_BF16_FLOPS)
    q32 = _split_view(torch, rng, b, 1, h, d)
    res = {**summary, **times,
           "kernel_fp32_q_ms_device": timer(
               lambda: at.decode_attention(q32, kb, vb, lens), flush=True,
               device=True),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library": f"scaled_dot_product_attention on the {kind} cache "
                      f"with a bool mask",
           "shape": [b, h, s, d], "lengths": lengths}
    emit(f"decode_attention_{kind}", **res)
    return res


def phase_paged_decode_half(torch, timer, tag):
    """K3's bf16 or float16 instance (``tag``) over pools of that type:
    the fp32 phase's cases (sq = 1 and 4, the peek, every check set),
    each with a q of the pool's type and an fp32 q, NaN in the scrap
    page, every unreferenced page and past every length."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    name, ulp = HALF_TYPES[tag]
    dt = getattr(torch, name)
    kind = tag
    rng = np.random.RandomState(13)
    b, h, ps, d, p_max, n_pages = 8, 12, 16, 64, 64, 513
    scale = 1.0 / math.sqrt(d)
    lengths = [0, 1, 15, 16, 17, 500, 1023, 1024]
    tbl, lens, kn, vn = _paged_inputs(torch, rng, lengths, h, ps, d, p_max,
                                      n_pages)
    kb, vb = kn.to(dt), vn.to(dt)
    sets = [((kb, vb), [
        ("sq=1", _split_view(torch, rng, b, 1, h, d), tbl, lens),
        ("sq=4", _split_view(torch, rng, b, 4, h, d), tbl, lens),
        ("peek b=1 len=500", _split_view(torch, rng, 1, 1, h, d),
         tbl[5:6].contiguous(), lens[5:6].contiguous())])]
    for tag, lns, pm in PAGED_CHECK_SETS:
        t2, l2, k2, v2 = _paged_inputs(torch, rng, lns, h, ps, d, pm,
                                       n_pages)
        sets.append(((k2.to(dt), v2.to(dt)), [
            (f"{tag} sq={sq}", _split_view(torch, rng, len(lns), sq, h, d),
             t2, l2) for sq in (1, 4)]))
    cases = []
    for (kp, vp), runs in sets:
        for tag, q, table, ln in runs:
            kg, vg = at.gather_pages(kp, table), at.gather_pages(vp, table)
            for qq in (q.to(dt), q):
                _decode_half_check(
                    torch, dt, ulp,
                    lambda x: at.paged_decode_attention(x, kp, vp, table,
                                                        ln),
                    lambda x: at._decode_fwd_torch(x, kg.float(),
                                                   vg.float(), ln, scale),
                    lambda x: at._decode_fwd_torch(x, kg, vg, ln, scale),
                    qq, ln, f"K3-{kind} {tag}", cases)
    emit(f"paged_decode_attention_{kind}_check", cases=cases)
    summary = _half_summary(cases, kind)
    check(summary["max_tol_ratio"] <= 1.0, f"K3-{kind} off its widened "
          f"plain version by {summary['max_tol_ratio']} {kind} tolerances")

    q = _split_view(torch, rng, b, 1, h, d).to(dt)
    kz = torch.nan_to_num(at.gather_pages(kb, tbl), nan=0.0)
    vz = torch.nan_to_num(at.gather_pages(vb, tbl), nan=0.0)
    live = torch.arange(p_max * ps, device="cuda")[None, :] \
        < lens.long()[:, None]
    mask = live[:, None, None, :]
    times = timings(
        timer, True,
        lambda: at.paged_decode_attention(q, kb, vb, tbl, lens),
        lambda: at._decode_fwd_torch(q, at.gather_pages(kb, tbl),
                                     at.gather_pages(vb, tbl), lens, scale),
        lambda: F.scaled_dot_product_attention(q, kz, vz, attn_mask=mask))
    total = sum(lengths)
    n_bytes = 2 * (2 * total * h * d + 2 * b * h * d) + 4 * b * (p_max + 1)
    bound_ms, bound_by = bound(n_bytes, 4 * d * h * total, PEAK_BF16_FLOPS)
    q32 = _split_view(torch, rng, b, 1, h, d)
    res = {**summary, **times,
           "kernel_fp32_q_ms_device": timer(
               lambda: at.paged_decode_attention(q32, kb, vb, tbl, lens),
               flush=True, device=True),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library": f"scaled_dot_product_attention on the pre-gathered "
                      f"{kind} view with a bool mask (gather not timed)",
           "shape": {"B": b, "H": h, "page_size": ps, "D": d,
                     "P_max": p_max, "n_pages": n_pages},
           "lengths": lengths}
    emit(f"paged_decode_attention_{kind}", **res)
    return res


#: the projections of one GPT-2-small layer, (N, K): q, k, v, out,
#: ffn1, ffn2
LAYER_PROJECTIONS = [(768, 768)] * 4 + [(3072, 768), (768, 3072)]
DEQUANT_REL_TOL = 2e-5


def _library_dequant(torch, x, wq, scales):
    """One PyTorch call computing the same product: the int8
    weight-only product where this build runs it on the card, else
    ``F.linear`` on a weight dequantized ahead of time (4x the bytes).
    A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    try:
        torch._weight_int8pack_mm(x, wq, scales)
        torch.cuda.synchronize()
        return (lambda: torch._weight_int8pack_mm(x, wq, scales),
                "torch._weight_int8pack_mm")
    except (RuntimeError, AttributeError, NotImplementedError):
        wf = wq.float() * scales[:, None]
        return (lambda: F.linear(x, wf),
                "F.linear on a pre-dequantized fp32 weight")


def phase_dequant(torch, timer):
    from mxnet_tpu_torch.ops import quantized as qz
    rng = np.random.RandomState(4)
    cases, err_abs, err_rel = [], 0.0, 0.0
    tables, biases = {}, {}
    for n, k in sorted(set(LAYER_PROJECTIONS)):
        w = torch.from_numpy(
            (rng.standard_normal((n, k)) * 0.02).astype("f4")).cuda()
        w[n // 3] = 0.0                          # an all-zero channel
        tables[(n, k)] = qz.quantize_channelwise(w)
        biases[(n, k)] = _rand(torch, rng, n)
        wq, sc = tables[(n, k)]
        check(int(wq[n // 3].abs().max()) == 0, "zero channel not zero")
        for m in (1, 3, 8, 9, 32, 40, 512):
            x = _rand(torch, rng, m, k)
            for bias in (None, biases[(n, k)]):
                out = qz.dequant_matmul(x, wq, sc, bias=bias)
                ref = qz._dequant_matmul_torch(x, wq, sc, bias=bias)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      "K4 non-finite output")
                e = float((out - ref).abs().max())
                rel = e / float(ref.abs().max())
                cases.append({"M": m, "N": n, "K": k,
                              "bias": bias is not None, "max_abs_err": e,
                              "rel": rel})
                err_abs, err_rel = max(err_abs, e), max(err_rel, rel)
    emit("dequant_matmul_check", cases=cases)
    check(err_rel <= DEQUANT_REL_TOL,
          f"K4 max-abs-err {err_rel} x max|ref| > {DEQUANT_REL_TOL}")

    # timing at the decode shape, M = 8 (the kernels line), and at M = 1
    # (peek), M = 32 (a prefill chunk) and M = 40 (a speculative verify
    # of 8 slots x (SPEC_K + 1) positions), each projection of one layer;
    # bias=None, as the library call and earlier kernels had none, with
    # the path's bias epilogue timed beside it
    per_shape, lib_name = {}, None
    for m in (1, 8, 32, 40):
        for n, k in sorted(set(LAYER_PROJECTIONS)):
            wq, sc = tables[(n, k)]
            bias = biases[(n, k)]
            x = _rand(torch, rng, m, k)
            lib, lib_name = _library_dequant(torch, x, wq, sc)
            per_shape[(m, n, k)] = {
                **timings(timer, True,
                          lambda: qz.dequant_matmul(x, wq, sc),
                          lambda: qz._dequant_matmul_torch(x, wq, sc), lib),
                "kernel_bias_ms_device": timer(
                    lambda: qz.dequant_matmul(x, wq, sc, bias=bias),
                    flush=True, device=True),
                "bound": bound(n * k + 4 * (m * k + n + m * n),
                               2 * m * n * k)}

    def layer(m, key):
        return sum(per_shape[(m, n, k)][key] for n, k in LAYER_PROJECTIONS)

    def layer_bound(m):
        return bound(sum(n * k + 4 * (m * k + n + m * n)
                         for n, k in LAYER_PROJECTIONS),
                     sum(2 * m * n * k for n, k in LAYER_PROJECTIONS))
    m = 8
    bound_ms, bound_by = layer_bound(m)
    res = {"max_abs_err": err_abs, "max_rel_err": err_rel,
           **{key: layer(m, key) for key in TIMING_KEYS},
           "kernel_bias_ms_device": layer(m, "kernel_bias_ms_device"),
           "library": lib_name, "bound_ms": bound_ms, "bound_by": bound_by,
           "timed": "the 6 projections of one layer at M=8, summed",
           "per_m": {mm: {"kernel_ms": layer(mm, "kernel_ms"),
                          "kernel_ms_device": layer(mm, "kernel_ms_device"),
                          "library_ms_device": layer(mm, "library_ms_device"),
                          "plain_ms_device": layer(mm, "plain_ms_device"),
                          "bound_ms": layer_bound(mm)[0],
                          "bound_by": layer_bound(mm)[1]}
                     for mm in (1, 8, 32, 40)},
           "per_shape": [{"M": mm, "N": n, "K": k,
                          **{kk: vv for kk, vv in r.items()
                             if kk != "bound"},
                          "bound_ms": r["bound"][0]}
                         for (mm, n, k), r in per_shape.items()]}
    emit("dequant_matmul", **res)
    return res


def phase_engine(torch):
    """GPT-2-small widths, 12 layers, random weights from a seed, 24
    prompts of 16..512 tokens from 4 client threads; then the CPU
    reference on the same weights."""
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    from mxnet_tpu_torch.serving import GenerationEngine

    vocab, n_layers, n_req, max_new = 50257, 12, 24, 64
    t0 = time.perf_counter()
    model = GPTModel(vocab_size=vocab, units=768, num_layers=n_layers,
                     num_heads=12, max_length=1024).initialize(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = GenerationEngine(model, max_slots=8, max_new_tokens=max_new,
                           eos_id=50256)
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0

    rng = np.random.RandomState(2)
    lens = rng.randint(16, 513, size=n_req)
    prompts = [rng.randint(0, vocab - 1, size=n).astype("i4") for n in lens]
    results, eng_res, _ = _serve_traffic(torch, eng, prompts)
    launches, steps = eng_res["launches"], eng_res["decode_steps"]
    check(launches["flash_attention_fwd"] >= n_layers * n_req,
          f"K1 launched {launches['flash_attention_fwd']} times")
    check(launches["decode_attention"] >= steps * n_layers > 0,
          f"K2 launched {launches['decode_attention']} times for "
          f"{steps} decode steps")
    eng_res.update(init_s=init_s, warmup_s=warmup_s)
    emit("engine", **eng_res)

    # the card's own prefill + decode logits for request 0, teacher-forced
    # on the engine's tokens, then the same weights on the CPU
    p0, g0 = prompts[0], results[0].tokens
    cache = model.init_cache(1, 1024)
    sb = eng.policy.bucket(len(p0))
    padded = np.zeros((1, sb), "i4")
    padded[0, :len(p0)] = p0
    lg, cache = model.prefill(padded, [len(p0)], cache, slots=[0])
    card_logits = [lg[0].cpu()]
    for tok in g0[:-1]:
        lg, cache = model.decode_step(np.array([tok], "i4"), cache)
        card_logits.append(lg[0].cpu())
    eng.close()
    del eng, cache
    torch.cuda.empty_cache()

    model.to("cpu")
    agree = total = 0
    flips, logit_err = [], None
    for j in range(4):
        p, g = prompts[j], results[j].tokens
        seq = np.concatenate([p, np.asarray(g[:-1], "i4")])
        full = model(seq[None])[0]                     # (n + T - 1, V)
        lg_cpu = full[len(p) - 1:]                     # predicts g[0..]
        pred = lg_cpu.argmax(dim=-1).numpy()
        for i, tok in enumerate(g):
            total += 1
            if pred[i] == tok:
                agree += 1
            else:
                gap = float(lg_cpu[i].max() - lg_cpu[i, tok])
                flips.append({"request": j, "pos": i, "gap": gap})
        if j == 0:
            logit_err = float((torch.stack(card_logits)
                               - lg_cpu).abs().max())
    rate = agree / total
    emit("cpu_reference", requests=4, tokens=total, agreement=rate,
         disagreements=flips, card_vs_cpu_logit_max_abs_err=logit_err,
         logit_tol=LOGIT_TOL)
    check(rate >= AGREE_MIN, f"greedy agreement {rate} < {AGREE_MIN}")
    check(all(f["gap"] < 2 * LOGIT_TOL for f in flips),
          f"a disagreement on a gap >= {2 * LOGIT_TOL}: {flips}")
    check(logit_err <= LOGIT_TOL,
          f"card vs CPU logits {logit_err} > {LOGIT_TOL}")
    return eng_res, model, prompts, results


#: the reference's bf16 contract (tests/test_multitick.py:305-348):
#: teacher-forced on the fp32 model's greedy tokens, the bf16 model's
#: per-step logits within 0.25 of the fp32 ones, and argmax agreement
#: >= 90 %
BF16_TOL = 0.25
BF16_AGREE_MIN = 0.90
#: card vs CPU, both in bf16, teacher-forced on the card's tokens: each
#: is within BF16_TOL of the fp32 model (the contract above, held on the
#: card here and in tests/test_torch_bf16.py on the CPU), and the fp32
#: models of the two devices within LOGIT_TOL of each other, so the two
#: bf16 runs are within 2 * BF16_TOL + LOGIT_TOL; two logits can swap
#: only on a gap below twice that, and the agreement floor is the bf16
#: contract's
BF16_CARD_CPU_TOL = 2 * BF16_TOL + LOGIT_TOL
BF16_CPU_REQUESTS = (0, 1)
#: decode steps per tick of the multi-tick phases
TICKS = 4


def _teacher_forced_dense(model, prompts, gens, policy, adapters=None):
    """Logits of every generated position of several requests through
    the dense generation calls, teacher-forced on their tokens ``gens``:
    each prompt prefilled into its own slot at the engine's bucket, then
    decode steps over all slots at once (a slot whose tokens ran out
    idles). ``adapters`` gives each request's LoRA bank slot on an armed
    model. Returns one (len(gen), V) CPU tensor per request."""
    import torch
    cache = model.init_cache(len(prompts), PAGED_MODEL["max_length"])
    akw = (lambda sl: {"adapters": np.asarray(adapters, "i4")[sl]}) \
        if adapters is not None else (lambda sl: {})
    out = []
    for b, p in enumerate(prompts):
        padded = np.zeros((1, policy.bucket(len(p))), "i4")
        padded[0, :len(p)] = p
        lg, cache = model.prefill(padded, [len(p)], cache, slots=[b],
                                  **akw(slice(b, b + 1)))
        out.append([lg[0].cpu()])
    for t in range(max(len(g) for g in gens) - 1):
        toks = np.array([g[t] if t < len(g) - 1 else 0 for g in gens], "i4")
        lg, cache = model.decode_step(toks, cache, **akw(slice(None)))
        lg = lg.cpu()
        for b, g in enumerate(gens):
            if t < len(g) - 1:
                out[b].append(lg[b])
    return [torch.stack(o) for o in out]


def _bf16_contract(bf, fp, gens):
    """The reference's bf16 measures over teacher-forced logit pairs
    (bf16, fp32) on tokens ``gens``: the per-step logit max-abs-err and
    how often the two argmaxes agree."""
    err, agree, total = 0.0, 0, 0
    for lb, lf in zip(bf, fp):
        err = max(err, float((lb - lf).abs().max()))
        agree += int((lb.argmax(-1) == lf.argmax(-1)).sum())
        total += lb.shape[0]
    return {"tokens": total, "logit_max_abs_err": err,
            "agreement": agree / total, "tol": BF16_TOL,
            "agree_min": BF16_AGREE_MIN}


def phase_bf16_engine(torch, cpu_model, prompts, fp32_results):
    """``compute_dtype="bfloat16", decode_ticks=TICKS`` on the dense
    engine at GPT-2-small widths (seed 0, the ``engine`` phase's weights
    and 24 prompts), then the same engine at ``decode_ticks=1``: the
    tokens must be the same. Then the reference's bf16 contract on the
    card, teacher-forced on the fp32 engine's tokens, and the card's
    bf16 logits against the CPU port's bf16 logits (``cpu_model``, the
    same weights) on the bf16 engine's tokens."""
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    model = _gpt2_small(seed=0)
    runs = {}
    for k in (TICKS, 1):
        torch.cuda.reset_peak_memory_stats()
        eng = GenerationEngine(model, max_slots=8, max_new_tokens=64,
                               eos_id=50256, compute_dtype="bfloat16",
                               decode_ticks=k)
        check(eng.precision == "bf16", f"precision {eng.precision!r}")
        check(eng._cache["k"][0].dtype == torch.bfloat16,
              f"the bf16 engine's cache is {eng._cache['k'][0].dtype}")
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        results, res, _ = _serve_traffic(torch, eng, prompts)
        pol = eng.policy
        kv = _kv_pool_bytes(eng._cache)
        res.update(decode_ticks_knob=k, warmup_s=warmup_s,
                   kv_cache_bytes=kv,
                   kv_cache_bytes_fp32=2 * kv,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        launches, ticks = res["launches"], res["decode_steps"]
        check(launches["flash_attention_fwd_bf16"] >= n_layers * len(prompts),
              f"K1-bf16 launched {launches['flash_attention_fwd_bf16']} "
              f"times")
        check(launches["decode_attention_bf16"] >= ticks * n_layers > 0,
              f"K2-bf16 launched {launches['decode_attention_bf16']} times "
              f"for {ticks} ticks")
        check(launches["flash_attention_fwd"] == 0
              and launches["decode_attention"] == 0,
              "an fp32 instance ran on the bf16 path")
        eng.close()
        del eng
        runs[k] = (results, res)
    toks = {k: [r.tokens for r in runs[k][0]] for k in runs}
    same = toks[TICKS] == toks[1]
    main = runs[TICKS][1]
    main["k1"] = {key: runs[1][1][key] for key in (
        "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "decode_steps",
        "decode_step_ms_p50", "host_syncs_per_token", "wall_s")}
    main["tokens_equal_k1"] = same

    # the reference's bf16 contract on the card: bf16 teacher-forced on
    # the fp32 engine's greedy tokens, against the fp32 model
    picks = list(range(4))
    ps_, g32 = [prompts[j] for j in picks], [fp32_results[j].tokens
                                              for j in picks]
    bf = _teacher_forced_dense(model, ps_, g32, pol)
    model.cast_compute_params(None)
    fp = _teacher_forced_dense(model, ps_, g32, pol)
    contract = _bf16_contract(bf, fp, g32)

    # card vs CPU, both bf16, on the bf16 engine's tokens
    cpu_picks = list(BF16_CPU_REQUESTS)
    gb = [runs[TICKS][0][j].tokens for j in cpu_picks]
    pb = [prompts[j] for j in cpu_picks]
    model.cast_compute_params("bfloat16")
    card = _teacher_forced_dense(model, pb, gb, pol)
    model.cast_compute_params(None)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_model.cast_compute_params("bfloat16")
    cpu = _teacher_forced_dense(cpu_model, pb, gb, pol)
    cpu_model.cast_compute_params(None)
    cpu_s = time.perf_counter() - t0
    flips, agree, total, err = [], 0, 0, 0.0
    for j, lc, lp, g in zip(cpu_picks, card, cpu, gb):
        err = max(err, float((lc - lp).abs().max()))
        pred = lp.argmax(-1).numpy()
        for i, tok in enumerate(g):
            total += 1
            if pred[i] == tok:
                agree += 1
            else:
                flips.append({"request": j, "pos": i,
                              "gap": float(lp[i].max() - lp[i, tok])})
    main.update(bf16_vs_fp32_on_card=dict(contract, requests=picks),
                card_vs_cpu_bf16={
                    "requests": cpu_picks, "tokens": total,
                    "logit_max_abs_err": err, "tol": BF16_CARD_CPU_TOL,
                    "agreement": agree / total, "disagreements": flips,
                    "cpu_s": cpu_s})
    emit("bf16_engine", **main)
    check(same, f"decode_ticks={TICKS} tokens differ from decode_ticks=1")
    check(contract["logit_max_abs_err"] <= BF16_TOL,
          f"bf16 vs fp32 logits {contract['logit_max_abs_err']} > "
          f"{BF16_TOL}")
    check(contract["agreement"] >= BF16_AGREE_MIN,
          f"bf16 vs fp32 agreement {contract['agreement']} < "
          f"{BF16_AGREE_MIN}")
    check(err <= BF16_CARD_CPU_TOL,
          f"card vs CPU bf16 logits {err} > {BF16_CARD_CPU_TOL}")
    check(agree / total >= BF16_AGREE_MIN,
          f"card vs CPU bf16 agreement {agree / total} < {BF16_AGREE_MIN}")
    check(all(f["gap"] < 2 * BF16_CARD_CPU_TOL for f in flips),
          f"a card vs CPU bf16 disagreement on a gap >= "
          f"{2 * BF16_CARD_CPU_TOL}: {flips}")
    return main


def _paged_prompts(rng, vocab):
    """The shape of ``bench.py --prefix``: 19 prompts share one
    192-token system prompt followed by a unique tail of 16-256 tokens,
    3 are unshared (16-512 tokens, one short enough for a single fresh
    prefill), and 2 repeat an earlier prompt exactly, at a length that
    is not a multiple of the page size. Returns the prompts and, for
    each repeat, the index of its original."""
    sys_prompt = rng.randint(0, vocab - 1, size=192).astype("i4")
    tails = rng.randint(16, 257, size=19)
    tails[16:18] = [37, 101]          # the originals of the repeats
    prompts = [np.concatenate([sys_prompt,
                               rng.randint(0, vocab - 1, size=n)
                               .astype("i4")]) for n in tails]
    for n in (rng.randint(16, 33), rng.randint(33, 257),
              rng.randint(257, 513)):
        prompts.append(rng.randint(0, vocab - 1, size=n).astype("i4"))
    repeats = {22: 16, 23: 17}
    for j, orig in repeats.items():
        prompts.append(prompts[orig].copy())
    return prompts, repeats


#: the paged phases' model: GPT-2-small widths (docs/SERVING.md)
PAGED_MODEL = dict(vocab_size=50257, units=768, num_layers=12, num_heads=12,
                   max_length=1024)


def _gpt2_small(seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    return GPTModel(**PAGED_MODEL, device="cuda").initialize(seed=seed)


def _serve_traffic(torch, eng, prompts, repeats=None, submit_kw=None,
                   during=None):
    """Serve ``prompts`` from 4 client threads, each sending its share
    back to back, except that a repeat (``repeats``: index -> its
    original) is sent once its original's result is in (a user
    re-sending a prompt); ``submit_kw[j]`` adds request j's keywords
    (sampling knobs, an adapter, a trace); ``during()``, when given,
    runs on this thread while the clients do (an operator's action on
    the live engine). The launch counters and telemetry cover exactly
    this run.
    ``decode_steps`` counts the engine's decode ticks (host syncs), each
    of ``ticks_per_sync`` steps. Returns (results, metrics, telemetry
    snapshot)."""
    from mxnet_tpu_torch import ops, telemetry
    n_req = len(prompts)
    repeats, submit_kw = repeats or {}, submit_kw or {}
    results, ttft, errors = [None] * n_req, [None] * n_req, []
    streams, sent = [None] * n_req, [threading.Event() for _ in prompts]

    def client(c):
        try:
            mine = []
            for j in range(c, n_req, 4):
                if j in repeats:
                    sent[repeats[j]].wait(600)
                    streams[repeats[j]].result(timeout=600)
                st = eng.submit(prompts[j], **submit_kw.get(j, {}))
                streams[j] = st
                sent[j].set()
                mine.append((j, time.perf_counter(), st))
            for j, t, st in mine:
                results[j] = st.result(timeout=600)
                ttft[j] = (st.first_token_at - t) * 1e3
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    telemetry.reset()
    ops.reset_launch_counts()          # the main path's run starts here
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in clients:
        th.start()
    if during is not None:
        during()
    for th in clients:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()     # ... and ends here
    snap = telemetry.snapshot()
    steps = int(snap["counters"].get("serving.generate.host_syncs", 0))
    decode_hist = telemetry.hist_quantiles("serving.generate.decode")
    if errors:
        raise errors[0]
    check(all(r is not None for r in results), "a request did not finish")
    check(all(r.finish_reason in ("eos", "length") for r in results),
          f"finish reasons {[r.finish_reason for r in results]}")
    gen_tokens = sum(len(r.tokens) for r in results)
    tt = np.array(ttft)
    res = {"requests": n_req, "generated_tokens": gen_tokens,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "ttft_ms_p50": float(np.percentile(tt, 50)),
           "ttft_ms_p99": float(np.percentile(tt, 99)),
           "decode_steps": steps,
           "decode_step_ms_p50": decode_hist["p50"],
           "decode_step_ms_avg": decode_hist["avg"],
           "ticks_per_sync": snap["gauges"].get(
               "serving.generate.ticks_per_sync", {}).get("value"),
           "host_syncs_per_token": steps / gen_tokens,
           "launches": launches,
           "launches_per_decode_step": {
               k: v / steps for k, v in launches.items()} if steps else {},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    return results, res, snap


def _serve_paged_traffic(torch, eng, prompts, repeats, submit_kw=None):
    """``_serve_traffic`` on a paged engine, with its page counters and
    the checks its traffic must pass: one prefill chunk an iteration at
    most, a prefix hit, a copy-on-write and K4 on every projection (on
    an int8-weight engine). Returns (results, metrics)."""
    results, res, snap = _serve_traffic(torch, eng, prompts, repeats,
                                        submit_kw)
    cnt = snap["counters"]
    res.update(
        prefix_hits=int(cnt.get("serving.generate.prefix_hits", 0)),
        cow_copies=int(cnt.get("serving.generate.pages.cow_copies", 0)),
        pages_shared=int(cnt.get("serving.generate.pages.shared", 0)),
        prefill_chunks=int(cnt.get("serving.generate.prefill_chunks", 0)),
        prefill_chunks_per_iter_peak=snap["gauges"][
            "serving.generate.prefill_chunks_per_iter"]["peak"])
    check(res["prefill_chunks_per_iter_peak"] == 1,
          f"prefill chunks per iteration peak "
          f"{res['prefill_chunks_per_iter_peak']} != 1")
    check(res["prefix_hits"] > 0, "no prefix hit (peek) ran")
    check(res["cow_copies"] > 0, "no copy-on-write ran")
    steps = res["decode_steps"]
    check(eng.quantize is None or res["launches"]["dequant_matmul"]
          >= 6 * PAGED_MODEL["num_layers"] * steps,
          f"K4 launched {res['launches']['dequant_matmul']} times for "
          f"{steps} decode steps")
    return results, res


def phase_paged_engine(torch):
    """GPT-2-small widths, 12 layers, random weights from seed 0,
    ``paged=True, quantize="int8_weights"``, 8 slots, page 16, default
    chunk and pool; the 24 prompts of ``_paged_prompts``."""
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    t0 = time.perf_counter()
    model = _gpt2_small()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(model, max_slots=8, max_new_tokens=64,
                           eos_id=50256, paged=True, page_size=16,
                           quantize="int8_weights")
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    prompts, repeats = _paged_prompts(np.random.RandomState(5),
                                      PAGED_MODEL["vocab_size"])
    results, res = _serve_paged_traffic(torch, eng, prompts, repeats)
    res.update(init_s=init_s, warmup_s=warmup_s)
    emit("paged_engine", **res)
    launches, steps = res["launches"], res["decode_steps"]
    check(launches["flash_attention_fwd"] > 0, "K1 never launched")
    check(launches["paged_decode_attention"] >= steps * n_layers > 0,
          f"K3 launched {launches['paged_decode_attention']} times for "
          f"{steps} decode steps")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return res, model, prompts, results, repeats


#: the sampled requests of the int8-KV phase (none is a repeat or the
#: original of one, nor one the CPU reference replays) and their knobs
SAMPLED = {1: 101, 6: 106, 11: 111, 18: 118}
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
#: the greedy requests the CPU reference replays: a prefix hit, its COW'd
#: original, an unshared prompt and a shared-system-prompt one
CPU_PICKS = (22, 16, 20, 3)


def _kv_pool_bytes(cache):
    return sum(t.numel() * t.element_size()
               for key in ("k", "v", "k_scale", "v_scale")
               for t in cache.get(key, ()))


def phase_int8_kv_engine(torch, model, prompts, repeats):
    """``paged=True, quantize="int8_weights", kv_dtype="int8"`` at
    GPT-2-small widths on ``model`` (seed 0), 8 slots, 64 new tokens,
    the prompts of ``_paged_prompts``; 4 of the 24 requests are sampled
    with fixed seeds. Then the sampled requests again, alone, on a second
    engine of the same configuration (the same seed gives the same
    tokens), and the card's teacher-forced int8-KV logits of the CPU
    reference's greedy requests and of the sampled ones (each sampled
    token must lie inside its top-k set)."""
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    cfg = dict(max_slots=8, max_new_tokens=64, eos_id=50256, paged=True,
               page_size=16, quantize="int8_weights", kv_dtype="int8")
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(model, **cfg)
    check(eng.precision == "int8_weights+int8_kv",
          f"precision {eng.precision!r}")
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    kw = {j: dict(SAMPLING, seed=seed) for j, seed in SAMPLED.items()}
    results, res = _serve_paged_traffic(torch, eng, prompts, repeats, kw)
    launches, steps = res["launches"], res["decode_steps"]
    pool = _kv_pool_bytes(eng._cache)
    fp32_pool = sum(t.numel() * 4 for key in ("k", "v")
                    for t in eng._cache[key])
    res.update(warmup_s=warmup_s, sampled_requests=sorted(SAMPLED),
               sampling=SAMPLING, kv_pool_bytes=pool,
               fp32_kv_pool_bytes=fp32_pool,
               kv_pool_ratio=pool / fp32_pool)
    eng.close()
    del eng
    check(launches["paged_decode_attention_int8"] >= steps * n_layers > 0,
          f"K3-int8 launched {launches['paged_decode_attention_int8']} "
          f"times for {steps} decode steps")
    check(launches["paged_decode_attention"] == 0,
          "the fp32 K3 ran on the int8-KV path")

    # the same seeds again, alone, on a fresh engine
    eng2 = GenerationEngine(model, **cfg)
    again = {j: eng2.submit(prompts[j], **kw[j]) for j in SAMPLED}
    again = {j: st.result(timeout=600).tokens for j, st in again.items()}
    eng2.close()
    del eng2
    same = {j: again[j] == results[j].tokens for j in SAMPLED}
    res["sampled_repeat_identical"] = same

    # teacher-forced logits on the card: every request over an int8
    # pool, the greedy ones over an fp32 pool too (int8 weights in both)
    gens = [r.tokens for r in results]
    card = dict(enumerate(_teacher_forced(model, prompts, gens,
                                          kv_dtype="int8")))
    greedy = [j for j in range(len(prompts)) if j not in SAMPLED]
    card32 = _teacher_forced(model, [prompts[j] for j in greedy],
                             [gens[j] for j in greedy])
    kv = _kv_contract([(card[j], lg32, gens[j])
                       for j, lg32 in zip(greedy, card32)])
    outside = []
    for j in SAMPLED:
        lg, g = card[j], gens[j]
        for i, tok in enumerate(g):
            rank = int((lg[i] > lg[i, tok]).sum())
            if rank >= SAMPLING["top_k"]:
                outside.append({"request": j, "pos": i, "rank": rank})
    res["sampled_tokens_outside_top_k"] = outside
    res["int8_kv_vs_fp32_kv_on_card"] = dict(kv, requests=greedy)
    emit("int8_kv_engine", **res)
    check(all(same.values()), f"a seeded sampled request did not repeat: "
          f"{same}")
    check(not outside, f"sampled tokens outside their top-k: {outside}")
    check(kv["kv_logit_max_abs_err"] <= QNT_KV_TOL,
          f"int8 KV vs fp32 KV logits on the card "
          f"{kv['kv_logit_max_abs_err']} > {QNT_KV_TOL}")
    torch.cuda.empty_cache()
    return res, results, card


def phase_paged_bf16_engine(torch, model, prompts, repeats, fp32_results):
    """The ``paged_engine`` traffic (int8 weights, ``model`` of seed 0,
    the same 24 prompts) with ``compute_dtype="bfloat16",
    decode_ticks=TICKS``, then at ``decode_ticks=1`` (the same tokens):
    a bf16 page pool read by K3's bf16 instance, the int8 projections
    (K4) on widened inputs. Then the reference's bf16 contract on the
    card, teacher-forced through the paged calls on the fp32 int8-weight
    engine's tokens (``fp32_results``)."""
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    runs = {}
    for k in (TICKS, 1):
        torch.cuda.reset_peak_memory_stats()
        eng = GenerationEngine(model, max_slots=8, max_new_tokens=64,
                               eos_id=50256, paged=True, page_size=16,
                               quantize="int8_weights",
                               compute_dtype="bfloat16", decode_ticks=k)
        check(eng.precision == "bf16+int8_weights",
              f"precision {eng.precision!r}")
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        results, res = _serve_paged_traffic(torch, eng, prompts, repeats)
        pool = _kv_pool_bytes(eng._cache)
        res.update(warmup_s=warmup_s, decode_ticks_knob=k,
                   kv_pool_bytes=pool, kv_pool_bytes_fp32=2 * pool,
                   host_syncs_per_token=res["decode_steps"]
                   / res["generated_tokens"])
        eng.close()
        del eng
        launches, ticks = res["launches"], res["decode_steps"]
        check(launches["paged_decode_attention_bf16"] >= ticks * n_layers > 0,
              f"K3-bf16 launched {launches['paged_decode_attention_bf16']} "
              f"times for {ticks} ticks")
        check(launches["paged_decode_attention"] == 0,
              "the fp32 K3 ran on the bf16 path")
        runs[k] = (results, res)
    results, res = runs[TICKS]
    same = [r.tokens for r in results] == [r.tokens for r in runs[1][0]]
    res["tokens_equal_k1"] = same
    res["k1"] = {key: runs[1][1][key] for key in (
        "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "decode_steps",
        "decode_step_ms_p50", "host_syncs_per_token", "wall_s")}
    check(same, f"decode_ticks={TICKS} tokens differ from decode_ticks=1")
    picks = list(CPU_PICKS)
    ps_ = [prompts[j] for j in picks]
    g32 = [fp32_results[j].tokens for j in picks]
    bf = _teacher_forced(model, ps_, g32, kv_dtype="bfloat16")
    model.cast_compute_params(None)    # the later phases run fp32
    fp = _teacher_forced(model, ps_, g32)
    contract = _bf16_contract(bf, fp, g32)
    res["bf16_vs_fp32_on_card"] = dict(contract, requests=picks)
    emit("paged_bf16_engine", **res)
    check(contract["logit_max_abs_err"] <= BF16_TOL,
          f"paged bf16 vs fp32 logits {contract['logit_max_abs_err']} > "
          f"{BF16_TOL}")
    check(contract["agreement"] >= BF16_AGREE_MIN,
          f"paged bf16 vs fp32 agreement {contract['agreement']} < "
          f"{BF16_AGREE_MIN}")
    torch.cuda.empty_cache()
    return res


def _kv_contract(runs):
    """The reference's int8-KV measures over ``runs`` of (int8-KV logits,
    fp32-KV logits, the int8-KV engine's tokens), all teacher-forced on
    those tokens: the per-step logit max-abs-err, how often the fp32-KV
    argmax is the engine's token, and the fp32-KV logit gap (its top-1
    minus the token's) at each position where it is not."""
    err, agree, total, gaps = 0.0, 0, 0, []
    for lg8, lg32, g in runs:
        err = max(err, float((lg8 - lg32).abs().max()))
        p32 = lg32.argmax(dim=-1).numpy()
        for i, tok in enumerate(g):
            total += 1
            if p32[i] == tok:
                agree += 1
            else:
                gaps.append(float(lg32[i].max() - lg32[i, tok]))
    return {"tokens": total, "kv_logit_max_abs_err": err,
            "agreement": agree / total, "disagreements": len(gaps),
            "disagreement_gap_max": max(gaps, default=0.0),
            "disagreement_gap_median": float(np.median(gaps)) if gaps
            else 0.0}


def _teacher_forced(model, prompts, gens, chunk=32, ps=16, kv_dtype=None):
    """Logits of every generated position of several requests through
    the port's paged generation calls, teacher-forced on their tokens
    ``gens``: each request's own prefill plan (one fresh prefill when
    its padded prompt fits a chunk, else chunks from 0 — the engine's
    chunk boundaries, since a shared prefix ends on a chunk boundary)
    into its own slot of one pool of ``kv_dtype``, then decode steps
    over all slots at once (a slot whose tokens ran out idles). Returns
    one (len(gen), V) CPU tensor per request."""
    import torch
    s_max = PAGED_MODEL["max_length"]
    caps = [-(-(len(p) + len(g)) // ps) for p, g in zip(prompts, gens)]
    cache = model.init_paged_cache(len(prompts), sum(caps) + 1, ps, s_max,
                                   dtype=kv_dtype)
    first = 1
    out = []
    for b, (prompt, cap) in enumerate(zip(prompts, caps)):
        n = len(prompt)
        row = np.zeros(s_max // ps, "i4")
        row[:cap] = np.arange(first, first + cap)
        first += cap
        w = max(ps, 1 << (n - 1).bit_length())
        if w <= chunk:
            toks = np.zeros((1, w), "i4")
            toks[0, :n] = prompt
            lg, cache = model.prefill_paged(toks, n, b, row, cache,
                                            fresh=True)
        else:
            for pos in range(0, n, chunk):
                nv = min(chunk, n - pos)
                toks = np.zeros((1, chunk), "i4")
                toks[0, :nv] = prompt[pos:pos + nv]
                lg, cache = model.prefill_paged(toks, nv, b, row, cache,
                                                start=pos)
        out.append([lg[0].cpu()])
    for t in range(max(len(g) for g in gens) - 1):
        live = np.array([t < len(g) - 1 for g in gens], "i4")
        toks = np.array([g[t] if t < len(g) - 1 else 0 for g in gens], "i4")
        lg, cache = model.decode_step_paged(toks, live, cache)
        lg = lg.cpu()
        for b in np.flatnonzero(live):
            out[b].append(lg[b])
    return [torch.stack(o) for o in out]


def phase_paged_cpu_reference(torch, model, prompts, results):
    """The paged int8 engine's tokens held against the same weights and
    int8 tables on the CPU, teacher-forced through the port's
    generation calls (not ``forward``, which stays fp32), for 4
    requests: a prefix hit, its COW'd original, an unshared prompt and
    a shared-system-prompt one; the card's own teacher-forced logits
    against the CPU's; and, reported without a gate, how often the fp32
    model would have picked the int8 engine's token."""
    picks = list(CPU_PICKS)
    ps_, gs_ = [prompts[j] for j in picks], [results[j].tokens for j in picks]
    card = _teacher_forced(model, ps_, gs_)
    model.to("cpu")
    fp32 = _teacher_forced(model.quantize_params(include=()), ps_, gs_)
    model.quantize_params()            # the int8 tables, made on the CPU
    cpu = _teacher_forced(model, ps_, gs_)
    agree = total = agree32 = 0
    flips, logit_err = [], 0.0
    for j, lg_card, lg32, lg in zip(picks, card, fp32, cpu):
        g = results[j].tokens
        pred = lg.argmax(dim=-1).numpy()
        pred32 = lg32.argmax(dim=-1).numpy()
        logit_err = max(logit_err, float((lg_card - lg).abs().max()))
        for i, tok in enumerate(g):
            total += 1
            agree32 += int(pred32[i] == tok)
            if pred[i] == tok:
                agree += 1
            else:
                flips.append({"request": j, "pos": i,
                              "gap": float(lg[i].max() - lg[i, tok])})
    rate = agree / total
    emit("paged_cpu_reference", requests=picks, tokens=total,
         agreement=rate, disagreements=flips,
         card_vs_cpu_logit_max_abs_err=logit_err, logit_tol=LOGIT_TOL,
         int8_vs_fp32_agreement=agree32 / total)
    check(rate >= AGREE_MIN, f"greedy agreement {rate} < {AGREE_MIN}")
    check(all(f["gap"] < 2 * LOGIT_TOL for f in flips),
          f"a disagreement on a gap >= {2 * LOGIT_TOL}: {flips}")
    check(logit_err <= LOGIT_TOL,
          f"card vs CPU logits {logit_err} > {LOGIT_TOL}")


def phase_int8_kv_cpu_reference(torch, model, prompts, results, card):
    """The int8-KV engine's greedy requests ``CPU_PICKS`` (a prefix hit,
    its COW'd original, an unshared prompt and a shared-system-prompt
    one) replayed on the CPU, teacher-forced on the engine's tokens
    through the port's plain paths, with the same weights and int8
    tables (``model`` is on the CPU, its int8 weight tables armed):

    (a) the reference's int8-KV contract (``bench.py --quant``): int8 KV
        against int8 weights with an fp32 KV, per-step logit max-abs-err
        <= QNT_KV_TOL. The agreement of the fp32-KV argmax with the
        engine's tokens is reported, not gated: the reference gates its
        98 % agreement floor on the int8-WEIGHTS replay against fp32
        only, and on this random-weight GPT-2-small head (50257 tokens,
        logits of standard deviation ~0.17) the top-2 logit gaps are a
        few hundredths, so a perturbation a hundredth in size moves some
        argmaxes: the int8-weight engine's tokens agree with the fp32
        model's at a like rate (``paged_cpu_reference``). The same replay
        on the card over all 20 greedy requests is in the
        ``int8_kv_engine`` line;
    (b) card against CPU in the same configuration: the CPU's int8-KV
        argmax agrees with the card's token at >= AGREE_MIN of the
        positions, every disagreement on a logit gap below FLIP_GAP. The
        bound: quantizing every K/V entry (an error of at most half a
        step, a quarter on average) moves the logits by at most
        QNT_KV_TOL. The card and the CPU compute K/V in another order,
        so an entry next to a rounding tie may land one step apart — a
        whole step on at most FLIP_FRAC of the entries (the bound the
        CPU tests hold torch and XLA to), i.e. at most 4 * FLIP_FRAC of
        the whole quantization's perturbation, which moves a logit by at
        most 4 * FLIP_FRAC * QNT_KV_TOL. With the fp32 difference
        LOGIT_TOL on top, two logits can swap only when their gap is
        below twice the sum: FLIP_GAP = 2 * (1e-3 + 4e-3 * 0.6) =
        6.8e-3, well under 0.6.

    The card's own teacher-forced int8-KV logits are held against the
    CPU's (reported)."""
    picks = list(CPU_PICKS)
    ps_ = [prompts[j] for j in picks]
    gs_ = [results[j].tokens for j in picks]
    t0 = time.perf_counter()
    kv8 = _teacher_forced(model, ps_, gs_, kv_dtype="int8")
    kv32 = _teacher_forced(model, ps_, gs_)
    cpu_s = time.perf_counter() - t0
    kv = _kv_contract(list(zip(kv8, kv32, gs_)))
    total = agree8 = 0
    flips, card_err = [], 0.0
    for j, lg8, g in zip(picks, kv8, gs_):
        card_err = max(card_err, float((card[j] - lg8).abs().max()))
        p8 = lg8.argmax(dim=-1).numpy()
        for i, tok in enumerate(g):
            total += 1
            if p8[i] == tok:
                agree8 += 1
            else:
                flips.append({"request": j, "pos": i,
                              "gap": float(lg8[i].max() - lg8[i, tok])})
    res = {"requests": picks, "tokens": total, "cpu_s": cpu_s,
           "int8_kv_vs_fp32_kv": kv, "kv_logit_tol": QNT_KV_TOL,
           "card_vs_cpu_agreement": agree8 / total,
           "disagreements": flips, "flip_gap_bound": FLIP_GAP,
           "card_vs_cpu_logit_max_abs_err": card_err}
    emit("int8_kv_cpu_reference", **res)
    check(kv["kv_logit_max_abs_err"] <= QNT_KV_TOL,
          f"int8 KV vs fp32 KV logits {kv['kv_logit_max_abs_err']} > "
          f"{QNT_KV_TOL}")
    check(agree8 / total >= AGREE_MIN,
          f"card vs CPU agreement {agree8 / total} < {AGREE_MIN}")
    check(all(f["gap"] < FLIP_GAP for f in flips),
          f"a disagreement on a gap >= {FLIP_GAP}: {flips}")
    return res


def phase_dense_int8_kv(torch):
    """``kv_dtype="int8"`` with fp32 weights on a dense cache at
    GPT-2-small widths (seed 0): 8 requests of 16..512 tokens, so that
    K2's int8 instance runs on the engine path; then ``load_weights`` to
    seed 1's weights between waves, and a second wave's greedy tokens
    held against a fresh engine on those weights."""
    from mxnet_tpu_torch import ops, telemetry
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    cfg = dict(max_slots=8, max_new_tokens=64, eos_id=50256, kv_dtype="int8")
    model = _gpt2_small(seed=0)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(model, **cfg)
    check(eng.precision == "int8_kv", f"precision {eng.precision!r}")
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    rng = np.random.RandomState(7)
    vocab = PAGED_MODEL["vocab_size"]

    def wave():
        return [rng.randint(0, vocab - 1, size=n).astype("i4")
                for n in rng.randint(16, 513, size=8)]

    first = wave()
    telemetry.reset()
    ops.reset_launch_counts()          # the main path's run starts here
    t0 = time.perf_counter()
    streams = [(time.perf_counter(), eng.submit(p)) for p in first]
    results = [st.result(timeout=600) for _t, st in streams]
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()     # ... and ends here
    steps = int(telemetry.counter_value("serving.generate.host_syncs"))
    decode_hist = telemetry.hist_quantiles("serving.generate.decode")
    tt = np.array([(st.first_token_at - t) * 1e3 for t, st in streams])
    gen_tokens = sum(len(r.tokens) for r in results)
    check(launches["decode_attention_int8"] >= steps * n_layers > 0,
          f"K2-int8 launched {launches['decode_attention_int8']} times for "
          f"{steps} decode steps")
    check(launches["decode_attention"] == 0,
          "the fp32 K2 ran on the int8-KV path")

    donor = _gpt2_small(seed=1)
    t0 = time.perf_counter()
    eng.load_weights({k: p.data() for k, p in
                      donor.collect_params().items()})
    swap_ms = (time.perf_counter() - t0) * 1e3
    second = wave()
    after = [st.result(timeout=600).tokens
             for st in [eng.submit(p) for p in second]]
    eng.close()
    fresh = GenerationEngine(donor, **cfg)
    expect = [st.result(timeout=600).tokens
              for st in [fresh.submit(p) for p in second]]
    fresh.close()
    res = {"requests": len(first), "generated_tokens": gen_tokens,
           "prompt_tokens": int(sum(len(p) for p in first)),
           "wall_s": wall, "tokens_per_s": gen_tokens / wall,
           "ttft_ms_p50": float(np.percentile(tt, 50)),
           "ttft_ms_p99": float(np.percentile(tt, 99)),
           "decode_steps": steps,
           "decode_step_ms_p50": decode_hist["p50"],
           "decode_step_ms_avg": decode_hist["avg"],
           "launches": launches,
           "launches_per_decode_step": {
               k: v / steps for k, v in launches.items()},
           "kv_cache_bytes": _kv_pool_bytes(eng._cache),
           "warmup_s": warmup_s, "load_weights_ms": swap_ms,
           "rollover_requests": len(second),
           "rollover_tokens_equal_fresh_engine": after == expect,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit("dense_int8_kv_engine", **res)
    check(after == expect, "after load_weights the engine's tokens differ "
          "from a fresh engine's on the new weights")
    del eng, fresh, model, donor
    torch.cuda.empty_cache()
    return res


#: speculative decoding (docs/SERVING.md "Speculative decoding &
#: sampling"): draft tokens an iteration, and the factor on every block
#: weight and bias of the target and the draft (``bench.py --spec``'s
#: models, ``_spc_models``: damped blocks give peaky logits, a real
#: greedy gap, and a draft holding the target's embeddings, head and
#: first block gives a real acceptance rate)
SPEC_K = 4
SPEC_DAMP = 0.3
#: the dense speculative traffic: the first 16 of the engine phase's
#: prompts (16..512 tokens), from 4 client threads
SPEC_DENSE_REQUESTS = 16


def _spec_models(torch):
    """(target, draft) at GPT-2-small widths: the target of 12 layers
    from seed 0, the draft of 1 layer from seed 1, each block weight and
    bias of both times ``SPEC_DAMP``, ``lm_head`` a copy of
    ``word_embed``; then the target's embeddings, position weights,
    block 0, ``ln_f`` and head copied into the draft."""
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel

    def build(layers, seed):
        net = GPTModel(**dict(PAGED_MODEL, num_layers=layers),
                       device="cuda").initialize(seed=seed)
        params = net.collect_params()
        params["lm_head.weight"].set_data(params["word_embed.weight"].data())
        for name, p in params.items():
            if name.startswith("layers.") and name.endswith((".weight",
                                                             ".bias")):
                p.set_data(p.data() * SPEC_DAMP)
        return net

    target, draft = build(PAGED_MODEL["num_layers"], 0), build(1, 1)
    tp = target.collect_params()
    for name, p in draft.collect_params().items():
        p.set_data(tp[name].data())
    return target, draft


def _audit(torch, dev, fn):
    """Run ``fn()`` under a dispatch mode that counts, per aten op, the
    host syncs (a scalar read, a copy from ``dev`` to the host) and the
    calls that touch a tensor off ``dev`` other than staging a host
    array onto it. Returns (fn's result, syncs, off-device calls)."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    staging = ("aten.lift_fresh", "aten._to_copy", "aten.copy_",
               "aten.detach", "aten.alias", "aten.view")
    syncs, off = collections.Counter(), collections.Counter()

    class Audit(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            on = [t.device == dev for t in ins + outs]
            if name.startswith("aten._local_scalar_dense") or (
                    any(t.device == dev for t in ins)
                    and any(t.device != dev for t in outs)):
                syncs[name] += 1
            elif not all(on) and not name.startswith(staging):
                off[name] += 1
            return out

    with Audit():
        res = fn()
    return res, dict(syncs), dict(off)


def _spec_model_parity(torch, target, draft, paged, kv_dtype=None,
                       lengths=(94, 45)):
    """Model-level speculative calls on the card, two prompts whose
    ``SPEC_K + 1`` verified positions cross a page boundary: the verify
    logits at every position against the decode chain of the same
    tokens, one more decode step after a full commit against the
    never-speculated cache, and one greedy and one sampled iteration
    (``propose_tokens``, ``verify_commit[_paged]``, the draft's
    rollback) audited for host syncs and off-card tensors. Returns the
    measures."""
    rng = np.random.RandomState(11)
    vocab, s_max, ps = (PAGED_MODEL["vocab_size"],
                        PAGED_MODEL["max_length"], 16)
    b, r, p_max = len(lengths), SPEC_K + 1, s_max // ps
    prompts = [rng.randint(0, vocab - 1, size=n).astype("i4")
               for n in lengths]
    act = np.ones(b, "i4")

    def prefilled(net, dense=False):
        if paged and not dense:
            cache = net.init_paged_cache(b, b * p_max + 1, ps, s_max,
                                         dtype=kv_dtype)
        else:
            cache = net.init_cache(b, s_max,
                                   dtype=None if dense else kv_dtype)
        firsts = []
        for j, p in enumerate(prompts):
            toks = np.zeros((1, max(ps, 1 << (len(p) - 1).bit_length())),
                            "i4")
            toks[0, :len(p)] = p
            if paged and not dense:
                row = np.arange(1 + j * p_max, 1 + (j + 1) * p_max,
                                dtype="i4")
                lg, cache = net.prefill_paged(toks, len(p), j, row, cache,
                                              fresh=True)
            else:
                lg, cache = net.prefill(toks, [len(p)], cache, slots=[j])
            firsts.append(int(lg[0].argmax()))
        return cache, np.asarray(firsts, "i4")

    def decode(toks, cache):
        if paged:
            return target.decode_step_paged(toks, act, cache)
        return target.decode_step(toks, cache)

    cache_a, firsts = prefilled(target)
    chain = np.concatenate([firsts[:, None], rng.randint(
        0, vocab - 1, size=(b, r - 1)).astype("i4")], axis=1)
    ref = []
    for t in range(r):
        lg, cache_a = decode(chain[:, t], cache_a)
        ref.append(lg)
    ref = torch.stack(ref, 1)
    cache_b, _ = prefilled(target)
    verify = target.verify_step_paged if paged else target.verify_step
    vl, cache_b = verify(chain, act, cache_b) if paged \
        else verify(chain, cache_b)
    err = float((vl - ref).abs().max())
    cache_b = target.advance_len(np.full(b, r, "i4"), cache_b)
    lens_equal = cache_b["len"].tolist() == cache_a["len"].tolist()
    nxt = ref[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
    la, _ = decode(nxt, cache_a)
    lb, _ = decode(nxt, cache_b)
    err_next = float((la - lb).abs().max())

    # one greedy and one sampled iteration, audited
    dcache, dfirsts = prefilled(draft, dense=True)
    vcommit = target.verify_commit_paged if paged else target.verify_commit
    dev = target.device
    gens = [torch.Generator(device=dev).manual_seed(j) for j in range(b)]
    knobs = dict(temps=np.full(b, SAMPLING["temperature"], "f4"),
                 top_ks=np.full(b, SAMPLING["top_k"], "i4"),
                 top_ps=np.full(b, SAMPLING["top_p"], "f4"))

    def iteration(sampled):
        kw = dict(generators=gens, **knobs) if sampled else {}
        out = draft.propose_tokens(dfirsts, dcache, SPEC_K, **kw)
        vkw = dict(q=out[1], **kw) if sampled else {}
        res = vcommit(firsts, out[0], act, cache_b, **vkw)
        draft.advance_len(np.full(b, -SPEC_K, "i4"), dcache)
        return res[1]
    audit = {}
    n_commit = []
    for sampled in (False, True):
        n, syncs, off = _audit(torch, dev, lambda: iteration(sampled))
        n_commit.append(n.tolist())
        audit["sampled" if sampled else "greedy"] = {
            "host_syncs": syncs, "off_card_ops": off}
    return {"lengths": list(lengths), "kv_dtype": kv_dtype or "float32",
            "verify_vs_decode_chain_max_abs_err": err,
            "after_commit_max_abs_err": err_next,
            "lens_equal_after_commit": lens_equal,
            "n_commit_greedy_sampled": n_commit, "audit": audit}


def _check_spec_model(res, tol, what):
    check(res["verify_vs_decode_chain_max_abs_err"] <= tol,
          f"{what}: verify vs decode chain "
          f"{res['verify_vs_decode_chain_max_abs_err']} > {tol}")
    check(res["after_commit_max_abs_err"] <= tol,
          f"{what}: decode after a full commit "
          f"{res['after_commit_max_abs_err']} > {tol}")
    check(res["lens_equal_after_commit"], f"{what}: lengths after commit")
    check(all(1 <= n <= SPEC_K + 1 for ns in res["n_commit_greedy_sampled"]
              for n in ns), f"{what}: n_commit outside [1, k + 1]")
    for kind, a in res["audit"].items():
        check(not a["host_syncs"], f"{what} {kind}: host syncs inside an "
              f"iteration's calls: {a['host_syncs']}")
        check(not a["off_card_ops"], f"{what} {kind}: off-card tensors on "
              f"the path: {a['off_card_ops']}")


def _spec_divergences(forced_fn, prompts, spec, plain):
    """The card's greedy identity rule: for every request whose
    speculative tokens differ from its non-speculative ones, the
    non-speculative logits at the first difference (teacher-forced
    through ``forced_fn(prompts, gens)``) and their top-2 gap. Returns
    one row per diverging request."""
    rows = []
    for j, (a, b) in enumerate(zip(spec, plain)):
        if a == b:
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)) - 1)
        lg = forced_fn([prompts[j]], [b])[0][i]
        top2 = lg.topk(2).values
        rows.append({"request": j, "pos": i, "spec": a[i], "plain": b[i],
                     "gap": float(top2[0] - top2[1])})
    return rows


def _spec_run(torch, eng, prompts, paged, repeats=None):
    """Serve ``prompts`` through ``eng`` (4 client threads) and add the
    speculative measures from its telemetry."""
    if paged:
        results, res = _serve_paged_traffic(torch, eng, prompts, repeats)
        snap = None
    else:
        results, res, snap = _serve_traffic(torch, eng, prompts)
    if eng.speculative:
        from mxnet_tpu_torch import telemetry
        c = telemetry.snapshot()["counters"] if snap is None \
            else snap["counters"]
        prop = c["serving.generate.spec.proposed"]
        acc = c["serving.generate.spec.accepted"]
        iters = res["decode_steps"]
        res.update(
            accept_rate=acc / prop, proposed=prop, accepted=acc,
            iterations=iters,
            committed_per_slot_iteration=(prop / SPEC_K + acc)
            / (prop / SPEC_K),
            decode_tokens_per_iteration=(res["generated_tokens"]
                                         - len(prompts)) / iters,
            launches_per_iteration=res.pop("launches_per_decode_step"))
    return results, res


def phase_spec_engine(torch, dense_prompts):
    """Speculative decoding at GPT-2-small widths (``_spec_models``: a
    damped 12-layer target and a 1-layer draft sharing its embeddings,
    head and first block), ``spec_k=SPEC_K``, 8 slots, 64 new tokens:

    - model level, dense fp32 and then paged with int8 weights:
      ``verify_step[_paged]`` against the decode chain and a full commit
      continued, within LOGIT_TOL, and one iteration's calls audited
      (no host sync, no off-card tensor); then over an int8 KV pool
      across a page boundary, within QNT_KV_TOL;
    - the dense fp32 engine, greedy, the first SPEC_DENSE_REQUESTS of
      the engine phase's prompts, non-speculative and speculative;
    - the paged int8-weight engine, greedy, ``_paged_prompts``'s traffic
      (prefix sharing, repeats: K3's peek, K4's verify at M = 40, the
      draft's dense prefill at decode entry), non-speculative and
      speculative;
    - the SAMPLED requests with the SAMPLING knobs on two fresh
      speculative paged engines: the same streams, and every commit
      count in [1, SPEC_K + 1].

    Greedy identity on the card: verify runs the plain masked attention
    and products at M = 8 x (SPEC_K + 1), decode K2 and products at
    M = 8, so a near-tie may flip: every first divergence between a
    request's two streams must sit on a non-speculative top-2 gap below
    FLIP_GAP (teacher-forced on the card). Returns (dense phase
    result, paged phase result, sampled phase result)."""
    import collections
    from mxnet_tpu_torch.ops import quantized as qz
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    t0 = time.perf_counter()
    target, draft = _spec_models(torch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec_kw = dict(draft_model=draft, spec_k=SPEC_K)
    cfg = dict(max_slots=8, max_new_tokens=64, eos_id=50256)
    dense_model = _spec_model_parity(torch, target, draft, paged=False)
    _check_spec_model(dense_model, LOGIT_TOL, "dense fp32")

    def serve(prompts, spec, repeats=None, warm=None, **kw):
        eng = GenerationEngine(target, **cfg, **kw,
                               **(spec_kw if spec else {}))
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        if warm is not None:
            warm()
        results, res = _spec_run(torch, eng, prompts, eng.paged, repeats)
        res["warmup_s"] = warmup_s
        if spec:
            check(eng.speculation == f"k={SPEC_K}:draft=GPTModel:1L-768u",
                  f"speculation {eng.speculation!r}")
        policy = eng.policy
        eng.close()
        return [r.tokens for r in results], res, policy

    prompts = dense_prompts[:SPEC_DENSE_REQUESTS]
    plain, plain_res, policy = serve(prompts, False)
    spec, dense, _ = serve(prompts, True)
    launches, iters = dense["launches"], dense["iterations"]
    check(launches["decode_attention"] == SPEC_K * 1 * iters > 0,
          f"K2 launched {launches['decode_attention']} times for {iters} "
          f"iterations of {SPEC_K} one-layer draft steps")
    check(launches["flash_attention_fwd"] >= (n_layers + 1) * len(prompts),
          f"K1 launched {launches['flash_attention_fwd']} times")
    div = _spec_divergences(
        lambda p, g: _teacher_forced_dense(target, p, g, policy),
        prompts, spec, plain)
    dense.update(init_s=init_s, model_level=dense_model,
                 requests_diverged=len(div), divergences=div,
                 flip_gap=FLIP_GAP,
                 non_spec={k: plain_res[k] for k in (
                     "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
                     "decode_steps", "host_syncs_per_token", "wall_s",
                     "launches_per_decode_step")})
    emit("spec_engine", **dense)
    check(all(d["gap"] < FLIP_GAP for d in div),
          f"a spec vs non-spec divergence on a gap >= {FLIP_GAP}: {div}")

    # paged, int8 weights
    pcfg = dict(paged=True, page_size=16, quantize="int8_weights")
    target.quantize_params()
    paged_model = _spec_model_parity(torch, target, draft, paged=True)
    _check_spec_model(paged_model, LOGIT_TOL, "paged int8 weights")
    kv8_model = _spec_model_parity(torch, target, draft, paged=True,
                                   kv_dtype="int8")
    _check_spec_model(kv8_model, QNT_KV_TOL, "paged int8 weights, int8 KV")
    pprompts, repeats = _paged_prompts(np.random.RandomState(5),
                                       PAGED_MODEL["vocab_size"])
    plain, plain_res, _ = serve(pprompts, False, repeats, **pcfg)
    k4_rows = collections.Counter()
    k4 = qz._dequant_matmul_cuda

    def counted(x2, *a, **kw):
        k4_rows[int(x2.shape[0])] += 1
        return k4(x2, *a, **kw)
    qz._dequant_matmul_cuda = counted
    try:
        spec, paged, _ = serve(pprompts, True, repeats, warm=k4_rows.clear,
                               **pcfg)
    finally:
        qz._dequant_matmul_cuda = k4
    launches, iters = paged["launches"], paged["iterations"]
    m_verify = 8 * (SPEC_K + 1)
    check(launches["decode_attention"] == SPEC_K * 1 * iters > 0,
          f"K2 launched {launches['decode_attention']} times for {iters} "
          f"iterations")
    check(launches["paged_decode_attention"]
          == n_layers * paged["prefix_hits"],
          f"K3 launched {launches['paged_decode_attention']} times for "
          f"{paged['prefix_hits']} whole-prompt hits")
    check(k4_rows[m_verify] == 6 * n_layers * iters,
          f"K4 at M = {m_verify}: {k4_rows[m_verify]} launches for {iters} "
          f"verifies")
    check(launches["flash_attention_fwd"] >= len(pprompts),
          f"K1 launched {launches['flash_attention_fwd']} times")
    div = _spec_divergences(
        lambda p, g: _teacher_forced(target, p, g), pprompts, spec, plain)
    paged.update(model_level=paged_model, model_level_int8_kv=kv8_model,
                 k4_launches_by_rows=dict(sorted(k4_rows.items())),
                 requests_diverged=len(div), divergences=div,
                 flip_gap=FLIP_GAP,
                 non_spec={k: plain_res[k] for k in (
                     "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
                     "decode_steps", "host_syncs_per_token", "wall_s",
                     "launches_per_decode_step")})
    emit("spec_paged_engine", **paged)
    check(all(d["gap"] < FLIP_GAP for d in div),
          f"a spec vs non-spec divergence on a gap >= {FLIP_GAP}: {div}")

    # sampled: the same seeds on two fresh engines
    n_commits, streams = [], []
    inner = target.verify_commit_paged

    def recorded(*a, **kw):
        out = inner(*a, **kw)
        n_commits.append(out[1])
        return out
    target.verify_commit_paged = recorded
    try:
        for _ in range(2):
            eng = GenerationEngine(target, **cfg, **pcfg, **spec_kw)
            sts = {j: eng.submit(pprompts[j], **SAMPLING, seed=seed)
                   for j, seed in SAMPLED.items()}
            streams.append({j: st.result(timeout=600).tokens
                            for j, st in sts.items()})
            eng.close()
    finally:
        del target.verify_commit_paged
    n_all = torch.cat(n_commits)
    sampled = {"requests": sorted(SAMPLED), "sampling": SAMPLING,
               "streams_identical": streams[0] == streams[1],
               "tokens": sum(len(t) for t in streams[0].values()),
               "n_commit_min": int(n_all.min()),
               "n_commit_max": int(n_all.max()),
               "n_commit_mean": float(n_all.float().mean())}
    emit("spec_sampled", **sampled)
    check(sampled["streams_identical"],
          "a seeded sampled speculative stream did not repeat")
    check(1 <= sampled["n_commit_min"] and sampled["n_commit_max"]
          <= SPEC_K + 1, f"n_commit outside [1, {SPEC_K + 1}]")
    del target, draft
    torch.cuda.empty_cache()
    return dense, paged, sampled


# ---- batched multi-tenant LoRA and float16 serving --------------------------
#: the LoRA phases: the engine's rank and bank (adapters beside the base
#: slot), the seeded tenants (factors ~ N(0, LORA_SCALE^2), alpha = rank,
#: so each moves an attention projection's output by about a fifth of its
#: own size at GPT-2-small widths), the dense traffic's tenants in turn
#: (None: the base model) and its adapted requests replayed on the CPU
LORA_RANK, LORA_MAX, LORA_SCALE = 8, 4, 0.05
LORA_SEEDS = {"t1": 201, "t2": 202, "t3": 203, "t4": 204}
LORA_TENANTS = (None, "t1", "t2", "t3")
LORA_REQUESTS = 16
LORA_CPU_PICKS = (1, 3)
#: decode steps each profile of ``_step_profile`` times
PROFILE_STEPS = 10


def _lora_factors(model, name):
    """Seeded factors of tenant ``name`` for every armed projection."""
    rng = np.random.RandomState(LORA_SEEDS[name])
    out = {}
    for li, tab in enumerate(model._lora):
        for proj in sorted(tab):
            for half in ("A", "B"):
                shape = tuple(tab[proj][half].shape[1:])
                out[f"layers.{li}.{proj}.{half}"] = (
                    rng.standard_normal(shape) * LORA_SCALE).astype("f4")
    return out


def _bank_ptrs(model):
    return [t.data_ptr() for st in model._lora_stack.values()
            for t in st.values()]


def _busy_ms(intervals):
    """The union length of [start, end) intervals (microseconds in, ms
    out)."""
    total, cur = 0.0, None
    for s0, e0 in sorted(intervals):
        if cur is None or s0 > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s0, e0]
        else:
            cur[1] = max(cur[1], e0)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def _step_profile(torch, model, prompts, adapters=None):
    """One dense decode step over 8 slots (the engine's: ``decode_step``,
    argmax on the card, the tokens read by the host), ``PROFILE_STEPS``
    of them under ``torch.profiler``: wall ms, device-busy ms (the union
    of the card's kernel intervals; None when the profiler sees no
    device activity) and the kernels a step launches."""
    from torch.profiler import ProfilerActivity, profile
    cache = model.init_cache(8, PAGED_MODEL["max_length"])
    akw = {} if adapters is None else {"adapters": adapters}
    last = np.zeros(8, "i4")
    for b, p in enumerate(prompts[:8]):
        toks = np.zeros((1, 1 << (len(p) - 1).bit_length()), "i4")
        toks[0, :len(p)] = p
        lg, cache = model.prefill(toks, [len(p)], cache, slots=[b],
                                  **({} if adapters is None else
                                     {"adapters": adapters[b:b + 1]}))
        last[b] = int(lg[0].argmax())
    state = {"toks": last}

    def step():
        lg, _ = model.decode_step(state["toks"], cache, **akw)
        state["toks"] = lg.argmax(dim=-1).cpu().numpy().astype("i4")
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms([(e.time_range.start, e.time_range.end) for e in kern])
    return {"wall_ms": wall,
            "device_busy_ms": busy / PROFILE_STEPS if kern else None,
            "kernels_per_step": len(kern) / PROFILE_STEPS}


def phase_lora_engine(torch, cpu_model, prompts, fp32_results):
    """Batched multi-tenant LoRA on the dense engine at GPT-2-small
    widths (seed 0, the ``engine`` phase's weights and its first
    LORA_REQUESTS prompts), ``lora_rank=LORA_RANK,
    max_adapters=LORA_MAX``, three seeded tenants, the requests cycling
    base, t1, t2, t3. While the traffic runs, t1 is refreshed (with the
    same factors, so its streams stay comparable) and t2 is unloaded
    while requests pin it (deferred until they finish); a fourth tenant
    loads afterwards into the freed slot. Checks: the base requests'
    tokens are the ``engine`` phase's; the adapted ones agree with the
    CPU port under teacher forcing (LOGIT_TOL, AGREE_MIN, flips below
    2 x LOGIT_TOL), the card's logits too; the banks never move
    (``data_ptr()``). The same prompts first go through a LoRA-free
    engine (the same-traffic baseline, also the float16 phase's), and a
    decode step is profiled with and without LoRA."""
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    ps = prompts[:LORA_REQUESTS]
    model = _gpt2_small(seed=0)
    eng = GenerationEngine(model, max_slots=8, max_new_tokens=64,
                           eos_id=50256)
    eng.warmup()
    _, plain, _ = _serve_traffic(torch, eng, ps)
    eng.close()
    del eng
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(model, max_slots=8, max_new_tokens=64,
                           eos_id=50256, lora_rank=LORA_RANK,
                           max_adapters=LORA_MAX)
    banks = _bank_ptrs(model)
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    alpha = float(LORA_RANK)
    factors = {n: _lora_factors(model, n) for n in LORA_TENANTS if n}
    for n, f in factors.items():
        eng.load_adapter(n, f, alpha=alpha)
    slot = {n: eng._lora_reg[n].idx for n in factors}
    tenant = [LORA_TENANTS[j % len(LORA_TENANTS)] for j in range(len(ps))]
    live = {}

    def operate():
        # once t2 is pinned by a request in flight: refresh t1, unload t2
        deadline = time.monotonic() + 60
        while eng._lora_reg["t2"].refs == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        live["t2_pins"] = eng._lora_reg["t2"].refs
        eng.load_adapter("t1", factors["t1"], alpha=alpha)
        live["t2_unload_immediate"] = eng.unload_adapter("t2")
        live["t2_after_unload"] = eng.adapters

    results, res, snap = _serve_traffic(
        torch, eng, ps, submit_kw={j: {"adapter": t}
                                   for j, t in enumerate(tenant) if t},
        during=operate)
    t2_evicted = "t2" not in eng._lora_reg
    eng.load_adapter("t4", _lora_factors(model, "t4"), alpha=alpha)
    pol = eng.policy
    cnt = snap["counters"]
    res.update(warmup_s=warmup_s, live_actions=live,
               plain_same_traffic={k: plain[k] for k in (
                   "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99",
                   "decode_steps", "decode_step_ms_p50", "wall_s")},
               t2_evicted_after_traffic=t2_evicted,
               t4_slot=eng._lora_reg["t4"].idx, t2_slot=slot["t2"],
               lora_requests=int(cnt.get("serving.generate.lora.requests",
                                         0)),
               adapters_loaded=int(cnt.get(
                   "serving.generate.lora.adapters_loaded", 0)),
               adapters_evicted=int(cnt.get(
                   "serving.generate.lora.adapters_evicted", 0)),
               lora_bank_bytes=model.lora_bank_bytes(),
               banks_unmoved=_bank_ptrs(model) == banks)
    eng.close()
    del eng
    launches, steps = res["launches"], res["decode_steps"]
    check(launches["flash_attention_fwd"] >= n_layers * len(ps),
          f"K1 launched {launches['flash_attention_fwd']} times")
    check(launches["decode_attention"] >= steps * n_layers > 0,
          f"K2 launched {launches['decode_attention']} times for "
          f"{steps} decode steps")
    base = [j for j, t in enumerate(tenant) if t is None]
    res["base_tokens_equal_engine"] = all(
        results[j].tokens == fp32_results[j].tokens for j in base)
    res["adapted_tokens_differ_from_base_model"] = sum(
        results[j].tokens != fp32_results[j].tokens
        for j, t in enumerate(tenant) if t)

    # the adapted requests teacher-forced on the card and on the CPU
    picks = list(LORA_CPU_PICKS)
    pp, gg = [ps[j] for j in picks], [results[j].tokens for j in picks]
    ad = [slot[tenant[j]] for j in picks]
    card = _teacher_forced_dense(model, pp, gg, pol, adapters=ad)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_model.arm_lora(LORA_MAX + 1, LORA_RANK)
    for j in picks:
        cpu_model.set_adapter(slot[tenant[j]], factors[tenant[j]],
                              alpha=alpha)
    cpu = _teacher_forced_dense(cpu_model, pp, gg, pol, adapters=ad)
    cpu_s = time.perf_counter() - t0
    flips, agree, total, err = [], 0, 0, 0.0
    for j, lc, lp, g in zip(picks, card, cpu, gg):
        err = max(err, float((lc - lp).abs().max()))
        pred = lp.argmax(-1).numpy()
        for i, tok in enumerate(g):
            total += 1
            if pred[i] == tok:
                agree += 1
            else:
                flips.append({"request": j, "pos": i,
                              "gap": float(lp[i].max() - lp[i, tok])})
    res["card_vs_cpu"] = {"requests": picks, "tenants":
                          [tenant[j] for j in picks], "tokens": total,
                          "agreement": agree / total,
                          "disagreements": flips,
                          "logit_max_abs_err": err, "logit_tol": LOGIT_TOL,
                          "cpu_s": cpu_s}

    # a decode step with and without LoRA, on the card
    armed = _gpt2_small(seed=0)
    armed.arm_lora(LORA_MAX + 1, LORA_RANK)
    for n in ("t1", "t3"):
        armed.set_adapter(slot[n], factors[n], alpha=alpha)
    mix = np.array([0, slot["t1"], slot["t3"], 0, slot["t1"], 0,
                    slot["t3"], 0], "i4")
    res["decode_step_profile"] = {
        "lora": _step_profile(torch, armed, prompts, adapters=mix),
        "lora_all_base": _step_profile(torch, armed, prompts,
                                       adapters=np.zeros(8, "i4"))}
    del armed
    plain = _gpt2_small(seed=0)
    res["decode_step_profile"]["no_lora"] = _step_profile(torch, plain,
                                                          prompts)
    del plain
    torch.cuda.empty_cache()
    emit("lora_engine", **res)
    check(res["banks_unmoved"], "the LoRA banks moved (data_ptr changed)")
    check(live["t2_unload_immediate"] is False,
          f"t2 unloaded at once with {live['t2_pins']} pins")
    check("t2" not in live["t2_after_unload"], "an unloading t2 still listed")
    check(t2_evicted, "t2's deferred unload never completed")
    check(res["base_tokens_equal_engine"],
          "a base request's tokens differ from the LoRA-free engine's")
    check(res["adapted_tokens_differ_from_base_model"] > 0,
          "no adapter changed a token")
    check(agree / total >= AGREE_MIN,
          f"LoRA card vs CPU agreement {agree / total} < {AGREE_MIN}")
    check(all(f["gap"] < 2 * LOGIT_TOL for f in flips),
          f"a LoRA disagreement on a gap >= {2 * LOGIT_TOL}: {flips}")
    check(err <= LOGIT_TOL, f"LoRA card vs CPU logits {err} > {LOGIT_TOL}")
    return res


def _trace_prefix_tokens(trace):
    """The cached prefix tokens a request's admission reused (its trace's
    ``admission`` event)."""
    for sp in trace.spans():
        if sp["name"] == "admission":
            return int(sp.get("attrs", {}).get("prefix_tokens", 0))
    raise AssertionError("a traced request has no admission event")


def phase_lora_paged_engine(torch, prompts, repeats, fp32_results):
    """The ``paged_engine`` traffic (int8 weights, page 16, the same 24
    prompts) with ``lora_rank=LORA_RANK`` and an adapter on about half
    the requests (the odd ones, repeats and their originals left base so
    the prefix hits and copy-on-write still run), every request traced.
    Checks: no adapted request reuses a cached prefix (its K/V differ)
    and base requests do; the base requests' tokens are the
    ``paged_engine`` phase's, or each first divergence sits on a
    near-tie (below FLIP_GAP, teacher-forced on the card: a request's
    prefix may now be its own prefill instead of a shared page)."""
    from mxnet_tpu_torch import tracing
    from mxnet_tpu_torch.serving import GenerationEngine

    model = _gpt2_small(seed=0)
    eng = GenerationEngine(model, max_slots=8, max_new_tokens=64,
                           eos_id=50256, paged=True, page_size=16,
                           quantize="int8_weights", lora_rank=LORA_RANK,
                           max_adapters=LORA_MAX)
    eng.warmup()
    alpha = float(LORA_RANK)
    names = [n for n in LORA_TENANTS if n]
    for n in names:
        eng.load_adapter(n, _lora_factors(model, n), alpha=alpha)
    pinned = set(repeats) | set(repeats.values())
    tenant = {j: names[(j // 2) % len(names)] for j in range(len(prompts))
              if j % 2 and j not in pinned}
    traces = {j: tracing.Trace() for j in range(len(prompts))}
    kw = {j: {"trace": traces[j],
              **({"adapter": tenant[j]} if j in tenant else {})}
          for j in range(len(prompts))}
    results, res = _serve_paged_traffic(torch, eng, prompts, repeats, kw)
    eng.close()
    del eng
    reused = {j: _trace_prefix_tokens(traces[j]) for j in traces}
    base = [j for j in range(len(prompts)) if j not in tenant]
    diff = [j for j in base if results[j].tokens != fp32_results[j].tokens]
    div = _spec_divergences(
        lambda p, g: _teacher_forced(model, p, g),
        [prompts[j] for j in diff], [results[j].tokens for j in diff],
        [fp32_results[j].tokens for j in diff])
    for row in div:
        row["request"] = diff[row["request"]]
    del model
    torch.cuda.empty_cache()
    res.update(adapted_requests=sorted(tenant),
               adapted_prefix_tokens_reused=sum(reused[j] for j in tenant),
               base_requests_reusing_prefix=sum(reused[j] > 0 for j in base),
               base_tokens_differing=diff, base_divergences=div,
               flip_gap=FLIP_GAP)
    emit("lora_paged_engine", **res)
    check(res["adapted_prefix_tokens_reused"] == 0,
          "an adapted request reused cached prefix pages")
    check(res["base_requests_reusing_prefix"] > 0,
          "no base request reused a cached prefix")
    check(all(r["gap"] < FLIP_GAP for r in div),
          f"a base request diverged from the LoRA-free engine off a "
          f"near-tie: {div}")
    return res


def phase_fp16_engine(torch, dense_prompts, dense_results, paged_model,
                      paged_prompts, paged_repeats, paged_results):
    """float16 serving at GPT-2-small widths: the dense ``engine``
    traffic (its first LORA_REQUESTS prompts) on ``GPTModel(dtype=
    "float16")`` from seed 0's weights (K1-f16 and K2-f16), and the
    ``paged_engine`` traffic at ``cache_dtype="float16"`` (int8 weights:
    K3-f16 with an fp32 q). Each is held to the fp32 engine of this run
    by the reference's bounded-divergence contract (the bf16 one: 0.25,
    >= 90 % agreement), teacher-forced on the fp32 engine's tokens."""
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    from mxnet_tpu_torch.serving import GenerationEngine

    n_layers = PAGED_MODEL["num_layers"]
    ps = dense_prompts[:LORA_REQUESTS]
    m16 = GPTModel(**PAGED_MODEL, dtype="float16",
                   device="cuda").initialize(seed=0)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(m16, max_slots=8, max_new_tokens=64,
                           eos_id=50256)
    check(eng._cache["k"][0].dtype == torch.float16,
          f"the float16 model's cache is {eng._cache['k'][0].dtype}")
    eng.warmup()
    _, dense, _ = _serve_traffic(torch, eng, ps)
    pol = eng.policy
    dense["kv_cache_bytes"] = _kv_pool_bytes(eng._cache)
    eng.close()
    del eng
    launches, steps = dense["launches"], dense["decode_steps"]
    check(launches["flash_attention_fwd_f16"] >= n_layers * len(ps),
          f"K1-f16 launched {launches['flash_attention_fwd_f16']} times")
    check(launches["decode_attention_f16"] >= steps * n_layers > 0,
          f"K2-f16 launched {launches['decode_attention_f16']} times for "
          f"{steps} decode steps")
    check(launches["flash_attention_fwd"] == 0
          and launches["decode_attention"] == 0,
          "an fp32 instance ran on the float16 path")
    picks = list(range(4))
    g32 = [dense_results[j].tokens for j in picks]
    f16 = _teacher_forced_dense(m16, [ps[j] for j in picks], g32, pol)
    del m16
    m32 = _gpt2_small(seed=0)
    fp = _teacher_forced_dense(m32, [ps[j] for j in picks], g32, pol)
    del m32
    torch.cuda.empty_cache()
    dense["f16_vs_fp32_on_card"] = dict(_bf16_contract(f16, fp, g32),
                                        requests=picks)

    eng = GenerationEngine(paged_model, max_slots=8, max_new_tokens=64,
                           eos_id=50256, paged=True, page_size=16,
                           quantize="int8_weights", cache_dtype="float16")
    eng.warmup()
    _, paged = _serve_paged_traffic(torch, eng, paged_prompts,
                                    paged_repeats)
    paged["kv_pool_bytes"] = _kv_pool_bytes(eng._cache)
    eng.close()
    del eng
    launches, steps = paged["launches"], paged["decode_steps"]
    check(launches["paged_decode_attention_f16"] >= steps * n_layers > 0,
          f"K3-f16 launched {launches['paged_decode_attention_f16']} "
          f"times for {steps} decode steps")
    check(launches["paged_decode_attention"] == 0,
          "the fp32 K3 ran on the float16 path")
    picks = list(CPU_PICKS)
    pp = [paged_prompts[j] for j in picks]
    g32 = [paged_results[j].tokens for j in picks]
    f16 = _teacher_forced(paged_model, pp, g32, kv_dtype="float16")
    fp = _teacher_forced(paged_model, pp, g32)
    paged["f16_vs_fp32_on_card"] = dict(_bf16_contract(f16, fp, g32),
                                        requests=picks)
    launches = {k: dense["launches"].get(k, 0) + paged["launches"].get(k, 0)
                for k in dense["launches"]}
    res = {"dense_f16_model": dense, "paged_f16_cache": paged,
           "launches": launches}
    emit("fp16_engine", **res)
    for tag, part in (("dense", dense), ("paged", paged)):
        c = part["f16_vs_fp32_on_card"]
        check(c["logit_max_abs_err"] <= BF16_TOL,
              f"{tag} float16 vs fp32 logits {c['logit_max_abs_err']} > "
              f"{BF16_TOL}")
        check(c["agreement"] >= BF16_AGREE_MIN,
              f"{tag} float16 vs fp32 agreement {c['agreement']} < "
              f"{BF16_AGREE_MIN}")
    return res


#: the rtc module of the K5 phases: the JAX rtc tests' kernels
#: (tests/test_extensions.py: scale_add, negate, double, ident), the
#: example's scale2 (examples/custom_op.py), and row_softmax — one
#: block per row, dynamic shared memory for the max and sum reductions,
#: the row width from ``-DCOLS=...`` (grid, block and shared_mem given)
RTC_SOURCE = r'''
extern "C" __global__ void scale_add(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     float* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f + y[i];
}
extern "C" __global__ void negate(const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = -x[i];
}
extern "C" __global__ void double_it(const float* __restrict__ x,
                                     float* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f;
}
extern "C" __global__ void ident(const float* __restrict__ x,
                                 float* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i];
}
extern "C" __global__ void scale2(const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f;
}
// one block per row of COLS floats; blockDim.x a power of two and
// blockDim.x floats of dynamic shared memory for the reductions
extern "C" __global__ void row_softmax(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       long long n) {
    extern __shared__ float red[];
    const long long base = blockIdx.x * (long long)COLS;
    if (base >= n) return;
    const float* xr = x + base;
    float* orow = out + base;
    const int t = threadIdx.x;
    float m = __int_as_float(0xff800000);            // -inf
    for (int c = t; c < COLS; c += blockDim.x) m = fmaxf(m, xr[c]);
    red[t] = m;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (t < s) red[t] = fmaxf(red[t], red[t + s]);
        __syncthreads();
    }
    m = red[0];
    __syncthreads();
    float sum = 0.0f;
    for (int c = t; c < COLS; c += blockDim.x) sum += expf(xr[c] - m);
    red[t] = sum;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (t < s) red[t] += red[t + s];
        __syncthreads();
    }
    sum = red[0];
    for (int c = t; c < COLS; c += blockDim.x)
        orow[c] = expf(xr[c] - m) / sum;
}
'''
RTC_COLS = 1024
RTC_OPTIONS = (f"-DCOLS={RTC_COLS}",)
#: the plain torch version of each rtc kernel
RTC_PLAIN = {
    "scale_add": lambda x, y: x * 2.0 + y,
    "negate": lambda x: -x,
    "double_it": lambda x: x * 2.0,
    "ident": lambda x: x.clone(),
    "scale2": lambda x: x * 2.0,
}
RTC_SOFTMAX_TOL = 1e-6
SCALE_ADD_N = 1 << 26


def _plain_row_softmax(x):
    e = (x - x.max(dim=1, keepdim=True).values).exp()
    return e / e.sum(dim=1, keepdim=True)


def phase_rtc(torch, timer):
    """K5: compile one ``rtc.CudaModule`` with NVRTC for sm_90a, hold
    each of its kernels against its plain torch version on the card
    (elementwise bitwise, row_softmax within 1e-6), check the refusals
    (a compile error raises with NVRTC's log; a dtype or arity mismatch
    raises before launch), and time scale_add at 2^26 fp32 elements and
    row_softmax at (4096, 1024)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops, rtc

    t0 = time.perf_counter()
    mod = mx.rtc.CudaModule(RTC_SOURCE, options=RTC_OPTIONS).load()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mx.rtc.CudaModule(RTC_SOURCE, options=RTC_OPTIONS).load()
    cached_s = time.perf_counter() - t0
    info = rtc.nvrtc_info()
    check(mod.list_kernels() == sorted(
        [*RTC_PLAIN, "row_softmax"]), f"kernels {mod.list_kernels()}")

    bad = 'extern "C" __global__ void bad(float* o, long long n) ' \
          '{ o[0] = no_such_name; }'
    try:
        mx.rtc.CudaModule(bad).load()
        raise AssertionError("a broken rtc source compiled")
    except RuntimeError as e:
        check("no_such_name" in str(e), f"no NVRTC log in: {e}")

    rng = np.random.RandomState(11)
    cases, err = [], 0.0
    with mx.gpu(0):
        for n in (1, 3, 255, 257, (8, 128), (4, 8), 1 << 20):
            shape = n if isinstance(n, tuple) else (n,)
            xa = rng.standard_normal(shape).astype("f4")
            ya = rng.standard_normal(shape).astype("f4")
            x, y = mx.np.array(xa), mx.np.array(ya)
            for name, plain in RTC_PLAIN.items():
                k = mod.get_kernel(name)
                args = (x, y) if name == "scale_add" else (x,)
                out = k(*args)
                ref = plain(*[a._data for a in args])
                torch.cuda.synchronize()
                check(out._data.is_cuda and out.shape == tuple(shape),
                      f"{name} output {out.shape} on {out._data.device}")
                diff = int((out._data != ref).sum())
                err = max(err, float((out._data - ref).abs().max()))
                cases.append({"kernel": name, "shape": list(shape),
                              "mismatches": diff})
                check(diff == 0, f"rtc {name} differs from its plain "
                      f"version in {diff} elements at {shape}")
        # dtype and arity refusals happen before any launch
        before = ops.launch_counts()["rtc"]
        x64 = mx.NDArray(torch.ones(4, dtype=torch.float64,
                                    device="cuda"))
        for bad_args in ((x64,), (mx.np.ones((4,)), mx.np.ones((4,)))):
            try:
                mod.get_kernel("negate")(*bad_args)
                raise AssertionError(f"negate ran on {bad_args}")
            except TypeError:
                pass
        check(ops.launch_counts()["rtc"] == before,
              "a refused rtc call launched")

        rows = 4096
        sm = mod.get_kernel("row_softmax", grid=(rows,), block=(256,),
                            shared_mem=256 * 4)
        xs = mx.np.array(rng.standard_normal((rows, RTC_COLS))
                         .astype("f4") * 4)
        out = sm(xs)
        ref = _plain_row_softmax(xs._data)
        torch.cuda.synchronize()
        sm_err = float((out._data - ref).abs().max())
        check(bool(torch.isfinite(out._data).all()),
              "row_softmax non-finite")
        check(sm_err <= RTC_SOFTMAX_TOL,
              f"row_softmax max-abs-err {sm_err} > {RTC_SOFTMAX_TOL}")
        emit("rtc_check", nvrtc=info, compile_s_cold=cold_s,
             compile_s_cached=cached_s, cases=cases,
             row_softmax_max_abs_err=sm_err)

        # timing: scale_add at 2^26 fp32 (3 x 256 MiB streams, past L2)
        sa = mod.get_kernel("scale_add")
        x = mx.np.array(rng.standard_normal(SCALE_ADD_N).astype("f4"))
        y = mx.np.array(rng.standard_normal(SCALE_ADD_N).astype("f4"))
        xt, yt = x._data, y._data
        times = timings(timer, False, lambda: sa(x, y),
                        lambda: xt * 2.0 + yt,
                        lambda: torch.add(yt, xt, alpha=2.0))
        bound_ms, bound_by = bound(3 * 4 * SCALE_ADD_N, 2 * SCALE_ADD_N)
        st = timings(timer, True, lambda: sm(xs),
                     lambda: _plain_row_softmax(xs._data),
                     lambda: torch.softmax(xs._data, dim=1))
        sm_bound = bound(2 * 4 * rows * RTC_COLS, 5 * rows * RTC_COLS)

        # the host's cost of one launch through the NDArray wrapper on a
        # 3-element input, beside an mx.np op and a bare torch op
        x3 = mx.np.array([1.0, 2.0, 3.0])
        k3 = mod.get_kernel("scale2")
        host_us = {}
        for key, fn in (("rtc_launch", lambda: k3(x3)),
                        ("mx_np_multiply", lambda: x3 * 2.0),
                        ("torch_mul", lambda: x3._data * 2.0)):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            host_us[key] = (time.perf_counter() - t0) / 2000 * 1e6
            torch.cuda.synchronize()
    res = {"max_abs_err": max(err, sm_err),
           "elementwise_mismatches": sum(c["mismatches"] for c in cases),
           "row_softmax_max_abs_err": sm_err, **times,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "timed": f"scale_add at {SCALE_ADD_N} fp32 elements",
           "library": "torch.add(y, x, alpha=2.0)",
           "row_softmax": {**st, "shape": [rows, RTC_COLS],
                           "bound_ms": sm_bound[0],
                           "bound_by": sm_bound[1],
                           "library": "torch.softmax"},
           "host_us_per_call": host_us, "compile_s_cold": cold_s,
           "compile_s_cached": cached_s, "nvrtc": info}
    emit("rtc", **res)
    return res


#: the front end's products held on the card against the CPU: integer
#: operands (the card has no integer matrix product: the exact int64
#: route), two dtypes (promoted to the reference's result type) and
#: dot's tensordot form. (tag, function, a's dtype and shape, b's)
CARD_PRODUCTS = [
    ("int32@int32", "matmul", ("i4", (33, 70)), ("i4", (70, 17))),
    ("uint8@int8", "matmul", ("u1", (8, 40)), ("i1", (40, 9))),
    ("bool@bool", "matmul", ("?", (6, 20)), ("?", (20, 5))),
    ("int16@int32 dot 3d", "dot", ("i2", (2, 3, 30)), ("i4", (30, 4))),
    ("int32@float16", "matmul", ("i4", (16, 24)), ("f2", (24, 8))),
    ("float16@float32", "matmul", ("f2", (16, 64)), ("f4", (64, 32))),
    ("bool@float32", "dot", ("?", (12, 32)), ("f4", (32, 6))),
]


def _card_products(torch, mx):
    """Each of CARD_PRODUCTS on the card and on the CPU, on the same
    numpy-seeded operands: the same dtype, integer and bool results
    equal, float ones within 2^-10 (a float16 result's step) or 1e-5
    (float32, another summation order) of max(1, max|cpu|)."""
    rs = np.random.RandomState(14)

    def operand(dt, shape):
        if dt == "?":
            return rs.rand(*shape) > 0.5
        if dt[0] == "f":
            return rs.uniform(-1, 1, shape).astype(dt)
        return rs.randint(0 if dt[0] == "u" else -60, 60, shape).astype(dt)

    out = {}
    for tag, fn, (da, sa), (db, sb) in CARD_PRODUCTS:
        a, b = operand(da, sa), operand(db, sb)
        card = getattr(mx.np, fn)(mx.np.array(a), mx.np.array(b))
        with mx.cpu():
            host = getattr(mx.np, fn)(mx.np.array(a), mx.np.array(b))
        check(card._data.is_cuda, f"product {tag} is not on the card")
        check(card.dtype == host.dtype and card.shape == host.shape,
              f"product {tag}: card {card.dtype}{card.shape} vs CPU "
              f"{host.dtype}{host.shape}")
        c, h = card.asnumpy().astype("f8"), host.asnumpy().astype("f8")
        err = float(np.abs(c - h).max())
        kind = np.dtype(card.dtype).kind
        tol = (0.0 if kind in "biu" else
               (2.0 ** -10 if card.dtype == np.float16 else 1e-5)
               * max(1.0, float(np.abs(h).max())))
        out[tag] = {"dtype": str(np.dtype(card.dtype)),
                    "shape": list(card.shape), "max_abs_err": err,
                    "tol": tol}
        check(err <= tol, f"product {tag} on the card off the CPU by {err}")
    return out


#: the dtypes of the data-movement checks on the card (torch's CPU and
#: CUDA kernels differ in tie order and in dtype coverage)
CARD_MOVE_DTYPES = ("bool", "uint8", "uint16", "uint32", "int8", "int16",
                    "int32", "float16", "float32")


def _card_moves(torch, mx):
    """``npx.topk`` on rows full of ties (the reference keeps the lower
    index first: a stable sort), and the data movement of wide unsigned
    arrays (``flip``, negative-step slices read and written, ``pick``,
    ``eye``; ``concatenate`` and ``where`` beside another integer type),
    each on the card and on the CPU on the same numpy-seeded values, in
    every dtype of CARD_MOVE_DTYPES: equal results (the same dtype,
    shape and values). Also the row [5, 5, 0, 5] at k = 2: indices
    [0, 1]."""
    rs = np.random.RandomState(15)
    out = {}

    def both(fn):
        card = fn()
        with mx.cpu():
            host = fn()
        cs = card if isinstance(card, (list, tuple)) else [card]
        hs = host if isinstance(host, (list, tuple)) else [host]
        for c, h in zip(cs, hs):
            check(c._data.is_cuda, "a data-movement result is not on the "
                  "card")
            check(c.dtype == h.dtype and c.shape == h.shape
                  and np.array_equal(c.asnumpy(), h.asnumpy()),
                  f"card {c.dtype}{c.shape} vs CPU {h.dtype}{h.shape}")
        return cs[0]

    for dt in CARD_MOVE_DTYPES:
        a = rs.randint(0, 4, (6, 33)).astype(dt)    # every row has ties
        for kw in ({"k": 5, "ret_typ": "indices"},
                   {"k": 5, "ret_typ": "both"},
                   {"k": 3, "ret_typ": "mask"},
                   {"k": 4, "ret_typ": "indices", "is_ascend": True},
                   {"k": 2, "axis": 0, "ret_typ": "indices"}):
            both(lambda: mx.npx.topk(mx.np.array(a), **kw))
        w = rs.randint(0, 100, (4, 6)).astype(dt)
        if dt in ("uint16", "uint32"):
            w[1, 2] = np.iinfo(dt).max

        def written():
            x = mx.np.array(w)
            x[::-2, 1:] = mx.np.array(np.ascontiguousarray(w[1::2, 1:]))
            return x
        for fn in (lambda: mx.np.flip(mx.np.array(w), axis=0),
                   lambda: mx.np.array(w)[::-1, ::-2],
                   written,
                   lambda: mx.npx.pick(mx.np.array(w), mx.np.array(
                       np.array([0, 5, 3, 1], "i4")), axis=1),
                   lambda: mx.np.eye(4, 6, k=1, dtype=dt)):
            both(fn)
        for wide in ("uint16", "uint32"):
            u = rs.randint(0, 100, (4, 6)).astype(wide)
            c = rs.rand(4, 6) > 0.5
            both(lambda: mx.np.concatenate([mx.np.array(u),
                                            mx.np.array(w)], axis=1))
            both(lambda: mx.np.where(mx.np.array(c), mx.np.array(u),
                                     mx.np.array(w)))
        out[dt] = "equal"
    tie = both(lambda: mx.npx.topk(mx.np.array(np.array([5, 5, 0, 5], "i4")),
                                   k=2, ret_typ="indices", dtype="int32"))
    check(tie.asnumpy().tolist() == [0, 1],
          f"topk of [5, 5, 0, 5] gave {tie.asnumpy().tolist()}")
    out["topk [5, 5, 0, 5] k=2"] = tie.asnumpy().tolist()
    return out


def phase_custom_op(torch):
    """The flow of examples/custom_op.py on the card through
    ``import mxnet_tpu_torch as mx``: the softsign CustomOp via
    ``npx.custom``, ``ClipGrad`` (an ``autograd.Function``), backward,
    and ``scale2`` through rtc; then ``double`` with ``grad=``, ``ident``
    opaque and the ``sigmoid_x2`` CustomOp of
    tests/test_operator_custom.py. Every array, output and grad lives on
    the card; each value is held against its closed form computed by
    numpy on the host (fp32 elementwise within 1e-6, gradients within
    rtol 1e-5: ``(1+|x|)**2`` and the sigmoid are rounded differently
    by torch and numpy)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, operator, ops

    @operator.register("softsign_x")
    class SoftsignProp(operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Softsign()

    class Softsign(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x / (1 + abs(x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] / (1 + abs(x)) ** 2)

    @operator.register("sigmoid_x2")
    class SigmoidX2Prop(operator.CustomOpProp):
        def list_outputs(self):
            return ["out"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SigmoidX2()

    class SigmoidX2(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0],
                        mx.np.array(2.0 / (1.0 + np.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            s = out_data[0].asnumpy() / 2.0
            g = out_grad[0].asnumpy() * 2.0 * s * (1.0 - s)
            self.assign(in_grad[0], req[0], mx.np.array(g))

    class ClipGrad(autograd.Function):
        def forward(self, x):
            return x

        def backward(self, dy):
            return mx.np.clip(dy, -0.1, 0.1)

    mod = mx.rtc.CudaModule(RTC_SOURCE, options=RTC_OPTIONS)
    xs = np.linspace(-3, 3, 8, dtype="float32")
    xd = np.random.RandomState(12).uniform(-1, 1, (4, 8)).astype("f4")
    xg = np.linspace(-2, 2, 12, dtype="float32").reshape(3, 4)
    on_card = []

    ops.reset_launch_counts()          # the main path's run starts here
    x = mx.np.array(xs)                # default context: gpu(0)
    x.attach_grad()
    with autograd.record():
        y = mx.npx.custom(x, op_type="softsign_x")
        z = ClipGrad()(y * 4.0)
        loss = z.sum()
    loss.backward()
    s2 = mod.get_kernel("scale2")(mx.np.array([1.0, 2.0, 3.0]))
    d = mx.np.array(xd)
    d.attach_grad()
    with autograd.record():
        dout = mod.get_kernel("double_it",
                              grad=lambda ct, v: (ct * 2.0,))(d).sum()
    dout.backward()
    i = mx.np.array(xd[0])
    i.attach_grad()
    with autograd.record():
        iout = (mod.get_kernel("ident")(i) * 2.0).sum()
    iout.backward()
    g = mx.np.array(xg)
    g.attach_grad()
    with autograd.record():
        sg = mx.operator.custom(g, op_type="sigmoid_x2")
        sg.sum().backward()
    mx.waitall()
    launches = ops.launch_counts()     # ... and ends here

    for name, arr in (("x", x), ("y", y), ("z", z), ("x.grad", x.grad),
                      ("scale2", s2), ("d.grad", d.grad),
                      ("ident.grad", i.grad), ("sigmoid_x2", sg),
                      ("sigmoid_x2.grad", g.grad)):
        on_card.append(name)
        check(arr._data.is_cuda and arr.ctx == mx.gpu(0),
              f"{name} is on {arr._data.device} ({arr.ctx})")
    sig = 1.0 / (1.0 + np.exp(-xg))
    soft = xs / (1 + np.abs(xs))
    errs = {
        "softsign": float(np.abs(y.asnumpy() - soft).max()),
        "clip_forward": float(np.abs(z.asnumpy() - 4 * soft).max()),
        "x.grad_rel": float(np.abs(x.grad.asnumpy()
                                   / (0.4 / (1 + np.abs(xs)) ** 2)
                                   - 1).max()),
        "scale2": float(np.abs(s2.asnumpy() - [2.0, 4.0, 6.0]).max()),
        "double.grad": float(np.abs(d.grad.asnumpy() - 2.0).max()),
        "ident.grad": float(np.abs(i.grad.asnumpy()).max()),
        "sigmoid_x2_rel": float(np.abs(sg.asnumpy() / (2 * sig)
                                       - 1).max()),
        "sigmoid_x2.grad_rel": float(np.abs(
            g.grad.asnumpy() / (2 * sig * (1 - sig)) - 1).max()),
    }
    prods = _card_products(torch, mx)
    moves = _card_moves(torch, mx)
    res = {"launches": launches, "on_card": on_card, "errors": errs,
           "products": prods, "data_movement": moves}
    emit("custom_op", **res)
    for key in ("softsign", "clip_forward", "scale2", "double.grad",
                "ident.grad"):
        check(errs[key] <= 1e-6, f"custom_op {key} off by {errs[key]}")
    for key in ("x.grad_rel", "sigmoid_x2_rel", "sigmoid_x2.grad_rel"):
        check(errs[key] <= 1e-5, f"custom_op {key} off by {errs[key]}")
    check(launches["rtc"] == 3, f"rtc launched {launches['rtc']} times "
          "in the custom_op flow (scale2, double, ident)")
    return res


# ---------------------------------------------------------------------------
# K1-bwd: the flash attention backward
# ---------------------------------------------------------------------------
#: K1-bwd vs its plain version: fp32 within 1e-4 x max(1, max|ref|) (the
#: kernel sums s, dp and the gradients in fp32 in another order than the
#: plain version's blocked einsums: sums of up to 1024 terms of p * ds);
#: a 16-bit instance within two steps of its type of the plain version
#: run on the widened inputs and rounded to the type (both compute in
#: fp32 from the same 16-bit values; two steps, as the gradient is
#: rounded once and its fp32 value may sit a step away across a rounding
#: boundary)
BWD_TOL = {"": 1e-4, "bf16": 2 * BF16_ULP, "f16": 2 * F16_ULP}
#: the train phase's attention as (B, H, S, D)
BWD_SHAPE = tuple(TRAIN_SHAPE[i] for i in (0, 2, 1, 3))
#: finite garbage for K and V past kv_len, by instance (the reference's
#: own backward reads V there, and a NaN would poison its dq; the kernel
#: never reads it). float16's is smaller: a causal row that sees no key
#: takes the reference's mean of V over the whole buffer, whose float16
#: sum must not overflow (its inf would give the reference's, and the
#: kernel's, ds = 0 * inf = NaN for that row)
BWD_GARBAGE = {"": (1e4, -3e4), "bf16": (1e4, -3e4), "f16": (1e2, -3e2)}
#: the small-dO case, (B, H, S, D) causal with dO scaled by 2^-12: max |dS|
#: falls under float16's smallest normal, 2^-14, while max |dq|, |dk| and
#: |dv| stay normal (tests/test_torch_flash_bwd_wg.py: a float16 dS split
#: without its power-of-two scale misses BWD_TOL there). It is gated
#: relative to max|ref|, not max(1, max|ref|), whose floor of 1 would turn
#: a 16-bit tolerance into an absolute one far above these gradients.
BWD_SMALL_DO = ((1, 2, 256, 64), 2.0 ** -12)
F16_MIN_NORMAL = 2.0 ** -14


def _bwd_work(b, h, sq, d, el, causal=True):
    """(bytes, FLOP) of K1-bwd's dq and dkv launches at (b, h, sq, d),
    keys = queries: each input read once and each output written once
    (q, k, v, out, dO and dq; q, k, v, dO, dk and dv; lse and delta in
    fp32), and per visible (query, key) pair s, dp and dq (6 d FLOP) or
    s, dp, dv and dk (8 d), plus delta's 2 d per query row."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sq)
    nbytes = 6 * b * h * sq * d * el + 2 * 4 * b * h * sq
    return ((nbytes, pairs * 6 * d + 2 * d * b * h * sq),
            (nbytes, pairs * 8 * d))


def _small_do_regime(torch, q, k, v, do):
    """max |dS| and the smallest of max |dq|, |dk|, |dv| of a causal
    attention on the card in fp32, dense (the small-dO case's regime)."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = q.shape[2]
    sc = 1.0 / math.sqrt(q.shape[-1])
    mask = torch.full((s, s), -math.inf, device=q.device).triu(1)
    p = torch.softmax(qf @ kf.transpose(-1, -2) * sc + mask, -1)
    out = p @ vf
    ds = p * (dof @ vf.transpose(-1, -2)
              - (dof * out).sum(-1, keepdim=True)) * sc
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof)
    return {"ds_max": float(ds.abs().max()),
            "grad_min_of_max": min(float(g.abs().max()) for g in grads)}


def phase_flash_bwd(torch, timer, tag):
    """K1-bwd's fp32 instance (``tag`` "") or its bf16 or float16 one,
    both launches, against the plain version (``_flash_bwd``) on the card:
    (1, 12, 512, 64) causal and not and (2, 12, 1024, 64) causal on the
    head split's strided views, head dims 16 and 128, kv_len below the key
    buffer (causal and not) and below the query length (the unseen rows),
    finite garbage past kv_len, a transposed dO, and the train phase's
    shape (BWD_SHAPE, causal, strided); the small-dO case (BWD_SMALL_DO),
    gated relative to max|ref|; and (1, 2, 130, 64) causal, whose lse and
    delta rows start off 16-byte boundaries. dk and dv past kv_len must
    be exactly 0. Then each launch is timed at BWD_SHAPE beside its plain
    half, and the backward of ``scaled_dot_product_attention`` on the
    same tensors (the work of both launches: ``pair_ms_device``, the sum
    of the two launches' device ms, stands beside it)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    dt = getattr(torch, HALF_TYPES[tag][0]) if tag else torch.float32
    tol = BWD_TOL[tag]
    sfx = f"_{tag}" if tag else ""
    rng = np.random.RandomState(20)
    cases, worst, worst_abs = [], 0.0, 0.0

    def mk(b, h, s, d, strided=True):
        x = _split_view(torch, rng, b, s, h, d) if strided \
            else _rand(torch, rng, b, h, s, d)
        return x.to(dt)

    def compare(q, k, v, do, causal, kv_len, what, rel=False):
        nonlocal worst, worst_abs
        out, lse = at.flash_attention_fwd(q, k, v, causal, None, kv_len)
        got = at.flash_attention_bwd(q, k, v, out, lse, do, causal, None,
                                     kv_len)
        w = [t.float() for t in (q, k, v, out)]
        ref = at._flash_bwd(*w, lse, do.float(), causal,
                            1.0 / math.sqrt(q.shape[-1]), kv_len)
        torch.cuda.synchronize()
        kl = kv_len or k.shape[2]
        errs = {}
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            check(g.dtype == dt, f"K1-bwd{sfx} {name} is {g.dtype}")
            check(bool(torch.isfinite(g).all()),
                  f"K1-bwd{sfx} non-finite {name} {what}")
            r = r.to(dt).float()
            e = float((g.float() - r).abs().max())
            worst_abs = max(worst_abs, e)
            m = float(r.abs().max())
            errs[name] = e / (m if rel else max(1.0, m))
            errs[f"{name}_max"] = m
        tail = all(bool((g[:, :, kl:] == 0).all()) for g in got[1:])
        check(tail, f"K1-bwd{sfx} dk/dv past kv_len not 0 {what}")
        cases.append({"case": what,
                      "gate": "x max|ref|" if rel else "x max(1, max|ref|)",
                      **errs})
        worst = max(worst, *(errs[n] for n in ("dq", "dk", "dv")))

    b, h, d = 1, 12, 64
    for causal in (True, False):
        q, k, v, do = (mk(b, h, 512, d) for _ in range(4))
        check(not q.is_contiguous(), "strided case is contiguous")
        compare(q, k, v, do, causal, None, f"s=512 causal={causal} strided")
    q, k, v, do = (mk(2, h, 1024, d) for _ in range(4))
    compare(q, k, v, do, True, None, "b=2 s=1024 causal strided")
    q, k, v, do = (mk(1, 4, 300, 16, strided=False) for _ in range(4))
    compare(q, k, v, do, True, None, "head_dim=16 s=300 causal")
    q, k, v, do = (mk(1, 4, 200, 128) for _ in range(4))
    compare(q, k, v, do, False, None, "head_dim=128 s=200 strided")
    for sq, sk, kvl, causal in ((256, 600, 500, False),
                                (256, 600, 500, True),
                                (300, 320, 200, True)):
        q, do = mk(b, h, sq, d), mk(b, h, sq, d)
        k, v = mk(b, h, sk, d), mk(b, h, sk, d)
        k[:, :, kvl:], v[:, :, kvl:] = BWD_GARBAGE[tag]
        compare(q, k, v, do, causal, kvl,
                f"sq={sq} kv_len={kvl} of {sk} causal={causal} garbage")
    q, k, v = (mk(b, h, 512, d) for _ in range(3))
    do = _rand(torch, rng, b, h, d, 512).to(dt).transpose(2, 3)
    compare(q, k, v, do, True, None, "transposed dO")
    b, h, s, d = BWD_SHAPE
    q, k, v, do = (mk(b, h, s, d) for _ in range(4))
    compare(q, k, v, do, True, None, "train shape strided causal")
    (sb, sh, ss, sd), do_scale = BWD_SMALL_DO
    rs = np.random.RandomState(21)
    sq_, sk_, sv_, sdo = (_split_view(torch, rs, sb, ss, sh, sd).to(dt)
                          for _ in range(4))
    sdo = (sdo.float() * do_scale).to(dt)
    regime = _small_do_regime(torch, sq_, sk_, sv_, sdo)
    if tag == "f16":
        check(regime["ds_max"] < F16_MIN_NORMAL
              and regime["grad_min_of_max"] >= F16_MIN_NORMAL,
              f"the small-dO case is not in its regime: {regime}")
    compare(sq_, sk_, sv_, sdo, True, None,
            f"small dO (x {do_scale}) causal strided", rel=True)
    cases[-1].update(regime)
    # B H Sq rows of lse and delta whose (b, h) rows start off a 16-byte
    # boundary (Sq = 130): the 16-bit dkv launch's TMA boxes start early
    rs = np.random.RandomState(22)
    aq, ak, av, ado = (_split_view(torch, rs, 1, 130, 2, 64).to(dt)
                       for _ in range(4))
    compare(aq, ak, av, ado, True, None, "s=130 h=2 causal strided")
    emit(f"flash_attention_bwd{sfx}_check", cases=cases, tol=tol)
    check(worst <= tol, f"K1-bwd{sfx} off its plain version by {worst} "
          f"(x max(1, max|ref|); the small-dO case x max|ref|) > {tol}")

    # timing at the train phase's shape
    sc = 1.0 / math.sqrt(d)
    out, lse = at.flash_attention_fwd(q, k, v, True)
    dq, delta = at._flash_bwd_launch("dq", q, k, v, out, lse, do, True, sc,
                                     s)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib_ms, lib_dev = timer.both(lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do, retain_graph=True))
    el = 4 if dt == torch.float32 else 2
    res = {}
    for kind, work, kern, plain in (
            ("dq", _bwd_work(b, h, s, d, el)[0],
             lambda: at._flash_bwd_launch("dq", q, k, v, out, lse, do, True,
                                          sc, s),
             lambda: at._flash_bwd_dq(q, k, v, out, lse, do, True, sc, s)),
            ("dkv", _bwd_work(b, h, s, d, el)[1],
             lambda: at._flash_bwd_launch("dkv", q, k, v, out, lse, do,
                                          True, sc, s, delta),
             lambda: at._flash_bwd_dkv(q, k, v, lse, do, delta, True, sc,
                                       s))):
        nbytes, flops = work
        if dt == torch.float32:
            # the fp32-accurate work on the tensor cores: 3xTF32, as K1's
            # bound; the fp32 CUDA cores' figure beside it
            bound_ms, bound_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
            extra = {"bound_ms_fp32_cores": bound(nbytes, flops)[0],
                     "bound_rule": "3 x FLOP at 495 TFLOP/s (3xTF32) vs "
                                   "bytes at 3.35 TB/s"}
        else:
            bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
            extra = {"bound_rule": f"{tag} FLOP at 989 TFLOP/s vs bytes "
                                   f"at 3.35 TB/s"}
        k_ms, k_dev = timer.both(kern)
        p_ms, p_dev = timer.both(plain)
        res[kind] = {
            "max_abs_err": worst_abs, "max_err_rel": worst, "tol": tol,
            "kernel_ms": k_ms,
            "kernel_ms_device": k_dev, "plain_ms": p_ms,
            "plain_ms_device": p_dev, "library_ms": lib_ms,
            "library_ms_device": lib_dev,
            "library": "backward of scaled_dot_product_attention "
                       "(causal) on the same tensors: dq, dk and dv, the "
                       "work of both K1-bwd launches",
            "bound_ms": bound_ms, "bound_by": bound_by, "flop": flops,
            "bytes": nbytes, "shape": list(BWD_SHAPE), "causal": True,
            **extra}
    for key in ("ms", "ms_device"):
        pair = res["dq"][f"kernel_{key}"] + res["dkv"][f"kernel_{key}"]
        for r in res.values():
            r[f"pair_{key}"] = pair
    emit(f"flash_attention_bwd{sfx}", **res)
    return res["dq"], res["dkv"]


# ---------------------------------------------------------------------------
# train: TrainStep on GPT-2 small (the slice's main path)
# ---------------------------------------------------------------------------
TRAIN_ROWS, TRAIN_COLS = 8, 1024
TRAIN_STEPS = 10
TRAIN_LR = 3e-4
TRAIN_F16_STEPS = 3
TRAIN_PROFILE_STEPS = 3
TRAIN_CPU_ROWS, TRAIN_CPU_COLS, TRAIN_CPU_STEPS = 2, 128, 2
#: card vs CPU port, fp32: step-one gradients per tensor within 1e-3 x
#: its max|g| (12 layers of 768-wide fp32 products and a 50257-way head
#: summed in other orders by two BLAS libraries and two attention
#: backwards); losses within 1e-4 relative
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_REL = 1e-4
#: the reference's bf16 contract: bf16 losses within 0.15 of fp32's
TRAIN_BF16_TOL = 0.15
#: K1 and K1-bwd launches a step: one of each per layer
TRAIN_ATTN = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


def _train_batch(rows, cols, seed):
    x = np.random.RandomState(seed).randint(
        0, PAGED_MODEL["vocab_size"], (rows, cols + 1))
    return x[:, :-1].astype("i4"), x[:, 1:].astype("i4")


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state]


def _train_leg(torch, step, data, label, steps):
    """``steps`` training steps on one batch, counted from zero: the
    losses, each step's wall ms (the loss read back ends it) and the
    kernels' launches."""
    from mxnet_tpu_torch import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(data, label)))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    return losses, ms, launches


def _kernel_class(name):
    low = name.lower()
    if "flash_fwd" in low:
        return "K1"
    if "flash_bwd_dq" in low:
        return "K1-bwd dq"
    if "flash_bwd_dkv" in low:
        return "K1-bwd dkv"
    if "flash_bwd_wg" in low:
        # the 16-bit instances: one template, kDkv its last argument
        return "K1-bwd dkv" if ", true>" in low or "lb1e" in low \
            else "K1-bwd dq"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "gemv", "sm90_")):
        return "products"
    if "softmax" in low or "nll" in low:
        return "softmax / loss"
    return "other"


def _train_profile(torch, step, data, label):
    """TRAIN_PROFILE_STEPS steps under torch.profiler: wall ms a step
    (profiled), device-busy ms a step (the union of the card's kernel
    intervals) and its share of that wall,
    kernels a step, device ms a step by kind of kernel and the five
    heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            float(step(data, label))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILE_STEPS
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kern), "the profiler saw no kernel on the card")
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kern]) / TRAIN_PROFILE_STEPS
    by_class, by_name = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        c = _kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    per = 1e3 * TRAIN_PROFILE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "kernels_per_step": len(kern) / TRAIN_PROFILE_STEPS,
            "device_ms_by_kind": {c: us / per for c, us in
                                  sorted(by_class.items())},
            "top_kernels_ms": [[n[:120], us / per] for n, us in top]}


def phase_train(torch):
    """The slice's main path: ``parallel.TrainStep`` on GPT-2 small
    (vocab 50257, 768 units, 12 layers, 12 heads, 1024 positions, dropout
    0, seed-0 weights) with the per-sequence softmax cross-entropy, one
    numpy-seeded batch of 8 x 1024 tokens (labels the tokens shifted by
    one), repeated: 10 fp32 Adam steps, then 10 on a fresh model at
    ``compute_dtype="bfloat16"``, then 3 on a float16 model with fp32
    masters (``multi_precision``). First, card against the CPU port: the
    same weights, 2 fp32 steps on a 2 x 128 batch, losses and step-one
    gradients."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    loss_fn = gloss.SoftmaxCrossEntropyLoss()

    def make(model, multi_precision=False, **kw):
        return parallel.TrainStep(
            model, loss_fn, "adam", {"learning_rate": TRAIN_LR,
                                     "multi_precision": multi_precision},
            **kw)

    # card against the CPU port, fp32
    d, l = _train_batch(TRAIN_CPU_ROWS, TRAIN_CPU_COLS, seed=1)
    cpu_step = make(GPTModel(**PAGED_MODEL, device="cpu").initialize(seed=0))
    card_step = make(_gpt2_small(seed=0))
    cpu_loss, cpu_g = cpu_step.gradients(d, l)
    card_loss, card_g = card_step.gradients(d, l)
    check(all(g.is_cuda for g in card_g.values()),
          "a card gradient is off the card")
    top = max(float(g.abs().max()) for g in cpu_g.values())
    grad_err = 0.0
    for name, g in cpu_g.items():
        # a k_proj bias's exact gradient is 0 (the softmax cancels it):
        # both hold rounding noise, held to the model's largest gradient
        scale = top if name.endswith("k_proj.bias") \
            else float(g.abs().max())
        grad_err = max(grad_err, float(
            (card_g[name].cpu() - g).abs().max()) / scale)
    cpu_losses = [float(cpu_step(d, l)) for _ in range(TRAIN_CPU_STEPS)]
    card_losses = [float(card_step(d, l)) for _ in range(TRAIN_CPU_STEPS)]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card_losses, cpu_losses))
    emit("train_card_vs_cpu", batch=[TRAIN_CPU_ROWS, TRAIN_CPU_COLS],
         step_one_loss=[float(card_loss), float(cpu_loss)],
         card_losses=card_losses, cpu_losses=cpu_losses,
         max_loss_rel_err=loss_err, max_grad_err_rel_to_max=grad_err)
    check(grad_err <= TRAIN_GRAD_TOL,
          f"card vs CPU step-one gradients {grad_err} > {TRAIN_GRAD_TOL}")
    check(loss_err <= TRAIN_LOSS_REL,
          f"card vs CPU losses {loss_err} > {TRAIN_LOSS_REL}")
    del cpu_step, card_step, cpu_g, card_g

    data, label = (torch.from_numpy(a).cuda()
                   for a in _train_batch(TRAIN_ROWS, TRAIN_COLS, seed=2))
    tokens = TRAIN_ROWS * TRAIN_COLS
    n_layers = PAGED_MODEL["num_layers"]
    res, launches = {}, {}
    for leg, dtype, kw, steps, sfx in (
            ("fp32", "float32", {}, TRAIN_STEPS, ""),
            ("bf16", "float32", {"compute_dtype": "bfloat16"}, TRAIN_STEPS,
             "_bf16"),
            ("f16", "float16", {"multi_precision": True}, TRAIN_F16_STEPS,
             "_f16")):
        model = GPTModel(**PAGED_MODEL, dtype=dtype,
                         device="cuda").initialize(seed=0)
        step = make(model, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what the leg found allocated (its model, and whatever earlier
        # phases still hold): the peak counts it too
        before = torch.cuda.memory_allocated()
        losses, ms, counts = _train_leg(torch, step, data, label, steps)
        peak = torch.cuda.max_memory_allocated()
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        want = {f"{k}{sfx}": n_layers * steps for k in TRAIN_ATTN}
        check(counts == want, f"train {leg}: launches {counts}, want {want}")
        check(all(math.isfinite(x) for x in losses),
              f"train {leg}: non-finite loss {losses}")
        check(leg == "f16" or losses[-1] < losses[0],
              f"train {leg}: losses not falling {losses}")
        params = list(model.collect_params().values())
        states = [t for s in step._opt_states for t in _leaves(s)]
        check(all(p._var().is_cuda for p in params)
              and all(t.is_cuda for t in states),
              f"train {leg}: a parameter or optimizer state is off the card")
        p50 = float(np.median(ms[1:]))
        out = {"losses": losses, "step_ms": ms, "step_ms_p50": p50,
               "tokens_per_s": tokens / p50 * 1e3,
               "launches": counts, "max_memory_allocated": peak,
               "memory_allocated_at_start": before,
               "param_dtypes": sorted({str(p._var().dtype)
                                       for p in params}),
               "state_dtypes": sorted({str(t.dtype) for t in states})}
        if leg == "bf16":
            check(out["param_dtypes"] == ["torch.float32"]
                  and out["state_dtypes"] == ["torch.float32"],
                  "bf16 training moved a master or a state off fp32")
            gap = max(abs(a - b) for a, b in zip(losses, res["fp32"]
                                                 ["losses"]))
            out["max_gap_to_fp32"] = gap
            check(gap < TRAIN_BF16_TOL, f"bf16 losses {gap} from fp32's")
        if leg == "f16":
            masters = [s[0] for s in step._opt_states
                       if isinstance(s, tuple) and len(s) == 2
                       and torch.is_tensor(s[0])]
            check(masters and all(m.dtype == torch.float32
                                  for m in masters),
                  "float16 training kept no fp32 masters")
        if leg != "f16":
            # the profiler's host work stretches the step it traces, so
            # the busy ms also stand over the unprofiled p50
            prof = _train_profile(torch, step, data, label)
            prof["device_busy_share_of_p50"] = prof["device_busy_ms"] / p50
            prof["profiler_overhead_ms"] = prof["wall_ms"] - p50
            out["profile"] = prof
        res[leg] = out
        emit(f"train_{leg}", **out)
        del model, step, params, states
        torch.cuda.empty_cache()
    res["launches"] = launches
    return res


#: the kernels line: name, source, the TPU kernel it replaces (file:line
#: and function), the kernel phase's result key
KERNELS = [
    ("flash_attention_fwd", "flash_attention.cu",
     "mxnet_tpu/ops/attention.py:141", "flash_attention_pallas", "k1"),
    ("decode_attention", "decode_attention.cu",
     "mxnet_tpu/ops/attention.py:474", "decode_attention_pallas", "k2"),
    ("decode_attention_int8", "decode_attention.cu",
     "mxnet_tpu/ops/attention.py:474",
     "decode_attention_pallas (k_scale/v_scale; body "
     "_decode_fwd_kernel quant=True, :402)", "k2i"),
    ("paged_decode_attention", "paged_decode_attention.cu",
     "mxnet_tpu/ops/attention.py:566", "paged_decode_attention_pallas",
     "k3"),
    ("paged_decode_attention_int8", "paged_decode_attention.cu",
     "mxnet_tpu/ops/attention.py:566",
     "paged_decode_attention_pallas (k_scale/v_scale)", "k3i"),
    ("dequant_matmul", "dequant_matmul.cu",
     "mxnet_tpu/ops/quantized.py:151", "dequant_matmul_pallas", "k4"),
    ("flash_attention_fwd_bf16", "flash_attention.cu",
     "mxnet_tpu/ops/attention.py:141",
     "flash_attention_pallas on bf16 q/k/v", "k1b"),
    ("decode_attention_bf16", "decode_attention.cu",
     "mxnet_tpu/ops/attention.py:474",
     "decode_attention_pallas on a bf16 cache (body _decode_fwd_kernel, "
     ":402)", "k2b"),
    ("paged_decode_attention_bf16", "paged_decode_attention.cu",
     "mxnet_tpu/ops/attention.py:566",
     "paged_decode_attention_pallas on a bf16 pool", "k3b"),
    ("flash_attention_fwd_f16", "flash_attention.cu",
     "mxnet_tpu/ops/attention.py:141",
     "flash_attention_pallas on float16 q/k/v", "k1h"),
    ("decode_attention_f16", "decode_attention.cu",
     "mxnet_tpu/ops/attention.py:474",
     "decode_attention_pallas on a float16 cache (body _decode_fwd_kernel, "
     ":402)", "k2h"),
    ("paged_decode_attention_f16", "paged_decode_attention.cu",
     "mxnet_tpu/ops/attention.py:566",
     "paged_decode_attention_pallas on a float16 pool", "k3h"),
] + [
    (f"flash_attention_bwd_{kind}{sfx}", "flash_attention_bwd.cu",
     "mxnet_tpu/ops/attention.py:293",
     f"_flash_bwd, the custom_vjp backward of flash_attention (jnp, no "
     f"pallas_call): its {scan} scan{on}", f"k1bwd_{kind}{sfx}")
    for sfx, on in (("", ""), ("_bf16", ", on bf16 q/k/v"),
                    ("_f16", ", on float16 q/k/v"))
    for kind, scan in (("dq", "dq_step"), ("dkv", "dkv_step"))
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (no result line)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    phase_env(torch)
    phase_build()
    timer = Timer(torch)
    k1 = phase_flash(torch, timer)
    k2, k2i = phase_decode(torch, timer)
    k3, k3i = phase_paged_decode(torch, timer)
    k4 = phase_dequant(torch, timer)
    k5 = phase_rtc(torch, timer)
    kernel_res = {"k1": k1, "k2": k2, "k2i": k2i, "k3": k3, "k3i": k3i,
                  "k4": k4}
    for tag, key in (("bf16", "b"), ("f16", "h")):
        kernel_res[f"k1{key}"] = phase_flash_half(torch, timer, tag)
        kernel_res[f"k2{key}"] = phase_decode_half(torch, timer, tag)
        kernel_res[f"k3{key}"] = phase_paged_decode_half(torch, timer, tag)
    for tag in ("", "bf16", "f16"):
        sfx = f"_{tag}" if tag else ""
        kernel_res[f"k1bwd_dq{sfx}"], kernel_res[f"k1bwd_dkv{sfx}"] = \
            phase_flash_bwd(torch, timer, tag)
    if args.kernels_only:
        return 0
    from mxnet_tpu_torch import ops
    phases = {"custom_op": phase_custom_op(torch)}
    phases["engine"], cpu_model, dense_prompts, dense_results = \
        phase_engine(torch)
    phases["bf16_engine"] = phase_bf16_engine(torch, cpu_model,
                                              dense_prompts, dense_results)
    phases["lora_engine"] = phase_lora_engine(torch, cpu_model,
                                              dense_prompts, dense_results)
    del cpu_model
    paged, model, prompts, results, repeats = phase_paged_engine(torch)
    phases["paged_engine"] = paged
    kv8, kv8_results, card8 = phase_int8_kv_engine(torch, model, prompts,
                                                   repeats)
    phases["int8_kv_engine"] = kv8
    phases["paged_bf16_engine"] = phase_paged_bf16_engine(
        torch, model, prompts, repeats, results)
    phases["lora_paged_engine"] = phase_lora_paged_engine(
        torch, prompts, repeats, results)
    phases["fp16_engine"] = phase_fp16_engine(
        torch, dense_prompts, dense_results, model, prompts, repeats,
        results)
    phase_paged_cpu_reference(torch, model, prompts, results)
    phase_int8_kv_cpu_reference(torch, model, prompts, kv8_results, card8)
    del model
    phases["dense_int8_kv_engine"] = phase_dense_int8_kv(torch)
    (phases["spec_engine"], phases["spec_paged_engine"],
     _sampled) = phase_spec_engine(torch, dense_prompts)
    phases["train"] = phase_train(torch)
    rows = []
    for name, src, replaces, fn, key in KERNELS:
        res = kernel_res[key]
        by_phase = {ph: r["launches"].get(name, 0)
                    for ph, r in phases.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{src}",
            "replaces": replaces, "replaces_function": fn,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": res["max_abs_err"],
            "ms": res["kernel_ms"],
            **{k: res[k] for k in TIMING_KEYS},
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            **{k: res[k] for k in ("bound_ms_fp32_cores", "bound_rule",
                                   "pair_ms", "pair_ms_device", "library")
               if k in res}})
    by_phase = {ph: r["launches"].get("rtc", 0) for ph, r in phases.items()}
    rows.append({
        "name": "rtc", "route": "cuda", "compiler": "nvrtc",
        "source": "mxnet_tpu_torch/rtc.py",
        "user_source": "chip_smoke.py RTC_SOURCE",
        "replaces": "mxnet_tpu/rtc.py:56",
        "replaces_function": "Kernel._build_call (pl.pallas_call :75)",
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        "max_abs_err": k5["max_abs_err"], "timed": k5["timed"],
        "ms": k5["kernel_ms"], **{k: k5[k] for k in TIMING_KEYS},
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"]})
    check(set(ops.launch_counts()) == {r["name"] for r in rows},
          "a kernel of the path is missing from the kernels line")
    check(all(r["launches"] > 0 for r in rows),
          "a kernel of the path was never launched by an engine")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
