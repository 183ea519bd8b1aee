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
buffer and on a row-strided view), K4 int8 dequant-matmul (M = 1 to 512:
the GEMV, each row-frag instance of the tile kernel and its tails, 64-row
m tiles, N not a multiple of 32 and K not of 64; with and without the
bias it adds in its epilogue), the bf16 and the
float16 instances of K1 (its own kernel, templated on the element
type: wgmma on tiles brought by TMA), K2 and K3 (every case of the fp32
phases on 16-bit inputs; K2 and K3 with a 16-bit and an fp32 q over
16-bit caches) and K5, the
runtime-compiled user kernels: one ``rtc.CudaModule`` compiled by NVRTC
for sm_90a (the JAX rtc tests' kernels, the example's ``scale2`` and a
shared-memory ``row_softmax``), each held against its plain torch
version, the same five elementwise kernels through the Triton route of
``rtc.PallasModule`` (Python kernel source compiled by Triton; bitwise
against the same plain versions, ``grad=``, the refusals, an
``interpret=True`` launch on CPU tensors), and K1-bwd, the flash attention backward (its dq and its
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
  ``backward``, ``scale2`` through rtc and through the Triton route), a
  kernel with ``grad=``, an
  opaque one and a numpy-backed CustomOp, held against closed forms,
  and ``np.matmul``/``np.dot`` of integer, bool and mixed-dtype
  operands held against the same calls on the CPU (``CARD_PRODUCTS``),
  and ``npx.topk`` on rows full of ties and the data movement of
  uint16/uint32 arrays in every dtype against the CPU
  (``_card_moves``);

- ``npx``: every function of ``mx.npx`` on the card against the CPU
  port (the activations and special functions crossed over the
  dtypes; pooling, the indexing ops and ``batch_dot`` over the dtypes
  whose card kernels refuse; the gradients of the convolutions,
  pooling, norms, ``rnn``, ``ctc_loss``, the legacy heads and
  ``foreach``), the refused dtypes and the port's routes, and
  ``npx.flash_attention`` under ``record()``: one K1 and one of each
  K1-bwd launch, held against their plain versions; the contrib
  operators (detection, ROI, warping, the deformable convolutions, ...)
  with their gradients, four of them timed at full width (SSD300's
  ``multibox_detection``, Faster R-CNN's RPN ``proposal``, ``roi_align``
  of its 300 rois, a 256-channel ``deformable_convolution``), and
  ``nd.sparse`` (creation, storage casts, dot, add, retain, norm);

- ``gluon``: the classic Gluon loop on the card, each net against the
  CPU port from the same weights and data: two
  ``TransformerEncoderCell``s at GPT-2 small's widths (fp32, 8 x 512,
  ``initialize`` deferred, ``hybridize``, 3 steps of ``record()``,
  ``L2Loss``, ``backward`` and ``Trainer("adam").step``; one K1 and one
  of each K1-bwd launch per cell and step; a profile of 2 steps), and
  ResNet-18's stem and first stage (32 x 3 x 224 x 224, 2 SGD steps with
  momentum, BatchNorm's running statistics, then a bucketed predict
  forward of 20 that adds no entry); then DLPack, ``runtime``, the
  memory queries and ``mx.random.seed`` on the card;

- ``rnn``: ``gluon.rnn``, the losses, ``gluon.metric`` and the file
  layer on the card, each against the CPU port: the word-level LSTM
  language model at its published width (Zaremba et al., 2014's
  "medium": vocab 10000, 650 x 2 layers, bptt 35, batch 64; 3 SGD steps
  with the gradient norm clipped, ``metric.Perplexity``), save and load
  of its parameters (the card's and the CPU port's files) and of its
  trainer's states (the next step bitwise), ``mx.save``/``mx.load`` of
  sparse arrays, ``model.save_checkpoint``, a dropout step repeated
  under ``mx.random.seed``, a profile and the same step through cuDNN's
  LSTM (printed only); a bidirectional GRU with sequence lengths, a
  ``Conv2DLSTMCell`` unrolled 10 steps, every new loss at a realistic
  size and every metric;

- ``amp_data``: item 16 and item 17a, the classic mixed-precision loop:
  a BERT-base-width model (768 units, 12 heads, FFN 3072, vocabulary
  30522, 2 post-norm cells) fed 8 x 512 tokens by a process-worker
  ``DataLoader`` with pinned batches, ``amp.init("float16")``,
  ``amp.scale_loss`` and ``Trainer("lamb")`` with dynamic loss scaling,
  one epoch of 8 steps (one K1-f16 and one of each K1-bwd-f16 launch
  per cell and step), an injected inf and an injected NaN skipped, the
  process workers' batches against thread workers', the same steps in
  fp32, the card against the CPU port at 2 x 32 tokens (first logits
  and each parameter's change), K1-f16 and K1-bwd-f16 against their
  plain versions at (8, 12, 512, 64) non-causal; a synthetic CIFAR-10
  through ``vision.CIFAR10``, the augmentation and 4 process workers
  into ResNet-18's stem and first stage under AMP; every registered
  optimizer on GPT-2 small's FFN pair against the CPU port (fp32,
  float16 with fp32 masters, an ``Updater``, the Trainer against one
  update a parameter);

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
  at every M x is split for the tensor cores as K1's operands are);
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
- the ``rnn`` phase, card vs the CPU port: the LM's losses within 1e-4
  relative and parameters within 1e-2 of their change (2-norm),
  ``Perplexity`` within 1e-5 of exp(mean loss), the GRU, the conv cell
  and the losses within 1e-4 x max(1, max|ref|), the metrics equal, and
  what a file carries bitwise (RNN_LOSS_REL, RNN_PARAM_REL, RNN_PPL_REL,
  RNN_FWD_TOL);
- the ``gluon`` phase, card vs the CPU port: losses within 1e-4
  relative; the Transformer's Adam updates element by element within
  1 % of lr, at most 1e-3 of the elements outside; the conv net's
  parameters and running statistics within 1e-2 of their change
  (2-norm; see GLUON_CONV_REL); the bucketed predict rows within 1e-6;
- the ``amp_data`` phase: float16 AMP against fp32 on the card, losses
  within the train phase's 0.15 (AMP_FP32_TOL), the first step's logits
  and each parameter's change over the epoch within AMP_FP32_REL; the
  card against the CPU port under AMP at 2 x 32 tokens, losses within
  2e-3 relative, the first logits and each parameter's change within
  AMP_CPU's limits (2-norms);
  K1-f16 within one float16 step and K1-bwd-f16 within two of their
  plain versions (as the f16 kernel phases); the augmentation card vs
  CPU within 1e-6; the optimizer sweep's fp32 weights and states within
  1e-5 x max(1, max|ref|), float16 weights within one float16 step
  (AMP_SWEEP), the Updater's and the Trainer's results bitwise equal to
  one update a parameter, SGLD's noise std within 2 % of sqrt(3 lr);
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
import contextlib
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
    try:                        # information only: no kernel needs it yet
        import triton
        tri = {"importable": True, "version": triton.__version__}
    except Exception as e:      # noqa: BLE001 (reported)
        tri = {"importable": False, "error": f"{type(e).__name__}: {e}"}
    print("triton:", json.dumps(tri), flush=True)
    emit("env", nvidia_smi=card, python=sys.version.split()[0], triton=tri,
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


def _tc_resources(lines, kernel):
    """ptxas's registers and spill bytes of each instance of ``kernel``,
    by its integer template argument (head dim, or row frags)."""
    pat = re.compile(kernel + r"ILi(\d+)E")
    out, cur = {}, None
    for ln in lines:
        if "Compiling entry" in ln:
            m = pat.search(ln)
            cur = out.setdefault(int(m.group(1)), {}) if m else None
        elif cur is not None and "spill stores" in ln:
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", ln)
            cur["spill_stores"], cur["spill_loads"] = map(int, st.groups())
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
    return out


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=_build.build_info)
    # K1-bwd's 16-bit instances: registers, spills and wgmma serialization
    inst, warnings = _wg_resources(
        _build.build_info.get("flash_attention_bwd", {}).get("ptxas", []))
    emit("build_flash_bwd_wg", instances=inst, ptxas_warnings=warnings)
    # the TF32 tensor-core kernels: K1-bwd's fp32 launches by head dim,
    # K4's tile kernel by its 8-row frags
    emit("build_tf32", instances={
        kern: _tc_resources(_build.build_info.get(lib, {}).get("ptxas", []),
                            kern)
        for lib, kern in (("flash_attention_bwd", "flash_bwd_dq_tc_kernel"),
                          ("flash_attention_bwd", "flash_bwd_dkv_tc_kernel"),
                          ("dequant_matmul", "dequant_tile_kernel"))})


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


#: K4's check rows: the GEMV (M <= 8), the tile kernel's instances of 2
#: to 8 row frags with their tails (9 .. 64), 64-row m tiles (65, 100,
#: 512), each on every projection shape and DEQUANT_ODD_SHAPE
DEQUANT_CHECK_M = (1, 3, 8, 9, 16, 17, 31, 32, 33, 40, 64, 65, 100, 512)
#: (N, K) with N not a multiple of the tile kernel's 32-channel block and
#: K not of its 64-wide span
DEQUANT_ODD_SHAPE = (1000, 1040)
#: the rows K4 is timed at: the peek (1), a decode step (8), a prefill
#: chunk (32), the speculative verify (40) and the dense prefill (512)
DEQUANT_TIMED_M = (1, 8, 32, 40, 512)
#: the kernels line's K4 rows (dequant_matmul, _m32, _m64: the wrapper's
#: counters by M): result key -> (timed M, the check rows it covers)
DEQUANT_ROWS = {"k4": (8, range(1, 9)), "k4m32": (32, range(9, 33)),
                "k4m64": (40, range(33, 1 << 20))}


def phase_dequant(torch, timer):
    from mxnet_tpu_torch.ops import quantized as qz
    rng = np.random.RandomState(4)
    cases = []
    tables, biases = {}, {}
    for n, k in sorted(set(LAYER_PROJECTIONS) | {DEQUANT_ODD_SHAPE}):
        w = torch.from_numpy(
            (rng.standard_normal((n, k)) * 0.02).astype("f4")).cuda()
        w[n // 3] = 0.0                          # an all-zero channel
        tables[(n, k)] = qz.quantize_channelwise(w)
        biases[(n, k)] = _rand(torch, rng, n)
        wq, sc = tables[(n, k)]
        check(int(wq[n // 3].abs().max()) == 0, "zero channel not zero")
        for m in DEQUANT_CHECK_M:
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
    emit("dequant_matmul_check", cases=cases)
    err_rel = max(c["rel"] for c in cases)
    check(err_rel <= DEQUANT_REL_TOL,
          f"K4 max-abs-err {err_rel} x max|ref| > {DEQUANT_REL_TOL}")

    # timing of each projection of one layer at DEQUANT_TIMED_M; bias=None,
    # as the library call and earlier kernels had none, with the path's
    # bias epilogue timed beside it
    per_shape, lib_name = {}, None
    for m in DEQUANT_TIMED_M:
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
                    flush=True, device=True)}

    def layer(m, key):
        return sum(per_shape[(m, n, k)][key] for n, k in LAYER_PROJECTIONS)

    def layer_bound(m):
        """The GEMV's bound: bytes vs fp32 operations; the tile kernel's:
        bytes vs its two TF32 products (x's big and small parts against
        the exact int8 weight) at the TF32 tensor cores' rate."""
        nbytes = sum(n * k + 4 * (m * k + n + m * n)
                     for n, k in LAYER_PROJECTIONS)
        flops = sum(2 * m * n * k for n, k in LAYER_PROJECTIONS)
        if m <= 8:
            return (*bound(nbytes, flops),
                    "bytes at 3.35 TB/s vs FLOP at 67 TFLOP/s (fp32)")
        return (*bound(nbytes, 2 * flops, PEAK_TF32_FLOPS),
                "bytes at 3.35 TB/s vs 2 x FLOP at 495 TFLOP/s (2xTF32)")

    per_m = {}
    for mm in DEQUANT_TIMED_M:
        bm, by, rule = layer_bound(mm)
        per_m[mm] = {**{key: layer(mm, key) for key in
                        ("kernel_ms", "kernel_ms_device", "library_ms_device",
                         "plain_ms_device", "kernel_bias_ms_device")},
                     "bound_ms": bm, "bound_by": by, "bound_rule": rule}
    out = {}
    for key, (m, rows) in DEQUANT_ROWS.items():
        bm, by, rule = layer_bound(m)
        mine = [c for c in cases if c["M"] in rows]
        out[key] = {
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["rel"] for c in mine),
            "checked_m": sorted({c["M"] for c in mine}),
            **{kk: layer(m, kk) for kk in TIMING_KEYS},
            "kernel_bias_ms_device": layer(m, "kernel_bias_ms_device"),
            "library": lib_name, "bound_ms": bm, "bound_by": by,
            "bound_rule": rule,
            "timed": f"the 6 projections of one layer at M={m}, summed"}
    out["k4m64"]["m512"] = per_m[512]
    emit("dequant_matmul", per_m=per_m,
         rows={kk: {k2: v for k2, v in r.items() if k2 != "m512"}
               for kk, r in out.items()},
         per_shape=[{"M": mm, "N": n, "K": k, **r}
                    for (mm, n, k), r in per_shape.items()])
    return out


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
    k4 = sum(n for name, n in res["launches"].items()
             if name.startswith("dequant_matmul"))
    check(eng.quantize is None or k4 >= 6 * PAGED_MODEL["num_layers"] * steps,
          f"K4 launched {k4} times for {steps} decode steps")
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


#: the Triton route of mx.rtc (``PallasModule``: Python kernel source,
#: the counterpart of the JAX package's Pallas source): the same five
#: elementwise kernels as RTC_SOURCE, in the port's convention (the
#: input pointers, the output pointer, n, BLOCK), their pointers
#: declared fp32
RTC_TRITON_SOURCE = '''
import triton
import triton.language as tl


@triton.jit
def scale_add(x: "*fp32", y: "*fp32", out: "*fp32", n, BLOCK: tl.constexpr):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    x_ = tl.load(x + i, mask=m)
    tl.store(out + i, x_ * 2.0 + tl.load(y + i, mask=m), mask=m)


@triton.jit
def negate(x: "*fp32", out: "*fp32", n, BLOCK: tl.constexpr):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, -tl.load(x + i, mask=m), mask=m)


@triton.jit
def double_it(x: "*fp32", out: "*fp32", n, BLOCK: tl.constexpr):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m) * 2.0, mask=m)


@triton.jit
def ident(x: "*fp32", out: "*fp32", n, BLOCK: tl.constexpr):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m), mask=m)


@triton.jit
def scale2(x: "*fp32", out: "*fp32", n, BLOCK: tl.constexpr):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    tl.store(out + i, tl.load(x + i, mask=m) * 2.0, mask=m)
'''


def phase_rtc_triton(torch, timer):
    """The Triton route of mx.rtc: one ``rtc.PallasModule`` of
    RTC_TRITON_SOURCE, compiled by Triton at its kernels' first launches
    (the cold compile, then a second module of the same source from
    Triton's cache), each kernel held bitwise against its plain torch
    version (RTC_PLAIN) at the K5 shapes, ``double_it`` with ``grad=``
    against its plain gradient, the refusals (a broken source raises
    with Triton's message; a dtype or arity mismatch raises before
    launch), one ``interpret=True`` launch on CPU tensors in Triton's
    interpreter, and scale_add timed at 2^26 fp32 elements beside K5's
    CUDA C one (the same bound and library call)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops, rtc

    rng = np.random.RandomState(13)
    xs = [mx.np.array(rng.standard_normal((257,)).astype("f4"))
          for _ in range(2)]

    def first_launches(mod):
        t0 = time.perf_counter()
        for name in RTC_PLAIN:
            mod.get_kernel(name)(*(xs if name == "scale_add" else xs[:1]))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with mx.gpu(0):
        mod = mx.rtc.PallasModule(RTC_TRITON_SOURCE)
        cold_s = first_launches(mod)
        cached_s = first_launches(mx.rtc.PallasModule(RTC_TRITON_SOURCE))
        check(mod.list_kernels() == sorted(RTC_PLAIN),
              f"triton kernels {mod.list_kernels()}")
        bad = ("@triton.jit\ndef bad(x, out, n, BLOCK: tl.constexpr):\n"
               "    tl.store(out + tl.arange(0, BLOCK), no_such_name)\n")
        try:
            mx.rtc.PallasModule(bad).get_kernel("bad")(xs[0])
            raise AssertionError("a broken Triton source compiled")
        except AssertionError:
            raise
        except Exception as e:          # noqa: BLE001 (Triton's error)
            check("no_such_name" in str(e), f"no Triton message in: {e}")
        cases, err = [], 0.0
        for n in (1, 3, 255, 257, (8, 128), (4, 8), 1 << 20):
            shape = n if isinstance(n, tuple) else (n,)
            xa = rng.standard_normal(shape).astype("f4")
            ya = rng.standard_normal(shape).astype("f4")
            x, y = mx.np.array(xa), mx.np.array(ya)
            for name, plain in RTC_PLAIN.items():
                args = (x, y) if name == "scale_add" else (x,)
                out = mod.get_kernel(name)(*args)
                ref = plain(*[a._data for a in args])
                torch.cuda.synchronize()
                check(out._data.is_cuda and out.shape == tuple(shape),
                      f"triton {name} output {out.shape}")
                diff = int((out._data != ref).sum())
                err = max(err, float((out._data - ref).abs().max()))
                cases.append({"kernel": name, "shape": list(shape),
                              "mismatches": diff})
                check(diff == 0, f"triton {name} differs from its plain "
                      f"version in {diff} elements at {shape}")
        # grad=: double_it's gradient against the plain one (2 * w)
        d = mx.np.array(rng.standard_normal((4, 8)).astype("f4"))
        w = rng.standard_normal((4, 8)).astype("f4")
        d.attach_grad()
        with mx.autograd.record():
            k = mod.get_kernel("double_it", grad=lambda ct, v: (ct * 2.0,))
            (k(d) * mx.np.array(w)).sum().backward()
        grad_err = float(np.abs(d.grad.asnumpy() - 2.0 * w).max())
        check(grad_err == 0.0, f"triton double_it grad= off by {grad_err}")
        # dtype and arity refusals happen before any launch
        before = ops.launch_counts()["rtc_triton"]
        x64 = mx.NDArray(torch.ones(4, dtype=torch.float64, device="cuda"))
        for bad_args in ((x64,), (mx.np.ones((4,)), mx.np.ones((4,)))):
            try:
                mod.get_kernel("negate")(*bad_args)
                raise AssertionError(f"negate ran on {bad_args}")
            except TypeError:
                pass
        check(ops.launch_counts()["rtc_triton"] == before,
              "a refused Triton call launched")
    # Triton's interpreter on CPU tensors (no launch on the card)
    with mx.cpu():
        xa = rng.standard_normal(300).astype("f4")
        ya = rng.standard_normal(300).astype("f4")
        before = ops.launch_counts()["rtc_triton"]
        out = mx.rtc.PallasModule(RTC_TRITON_SOURCE).get_kernel(
            "scale_add", interpret=True, BLOCK=128)(mx.np.array(xa),
                                                    mx.np.array(ya))
        interp_err = float(np.abs(out.asnumpy() - (xa * 2.0 + ya)).max())
        check(out._data.device.type == "cpu" and interp_err == 0.0,
              f"interpreted scale_add off by {interp_err}")
        check(ops.launch_counts()["rtc_triton"] == before,
              "an interpreted launch counted as a card launch")
    emit("rtc_triton_check", triton=rtc._triton().__version__,
         compile_s_cold=cold_s, compile_s_cached=cached_s, cases=cases,
         grad_err=grad_err, interpret_err=interp_err)
    with mx.gpu(0):
        sa = mod.get_kernel("scale_add")
        x = mx.np.array(rng.standard_normal(SCALE_ADD_N).astype("f4"))
        y = mx.np.array(rng.standard_normal(SCALE_ADD_N).astype("f4"))
        xt, yt = x._data, y._data
        times = timings(timer, False, lambda: sa(x, y),
                        lambda: xt * 2.0 + yt,
                        lambda: torch.add(yt, xt, alpha=2.0))
    bound_ms, bound_by = bound(3 * 4 * SCALE_ADD_N, 2 * SCALE_ADD_N)
    res = {"max_abs_err": err,
           "elementwise_mismatches": sum(c["mismatches"] for c in cases),
           **times, "bound_ms": bound_ms, "bound_by": bound_by,
           "timed": f"scale_add at {SCALE_ADD_N} fp32 elements",
           "library": "torch.add(y, x, alpha=2.0)",
           "compile_s_cold": cold_s, "compile_s_cached": cached_s,
           "triton": rtc._triton().__version__, "grad_err": grad_err,
           "interpret_err": interp_err}
    emit("rtc_triton", **res)
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


#: the dtype crosses of the numpy phase
NP_DTYPES = ("bool", "uint8", "uint16", "uint32", "int8", "int32", "float16",
             "float32")
#: tolerances of a card result against the CPU port's, as the CPU tests
#: hold the port to the JAX package: elementwise 1e-6, transcendental
#: 2e-6, reductions, products, linalg and fft 1e-5 (relative and
#: absolute); a float16 result one step of its type, 2^-10
NP_EW, NP_TR, NP_RED, NP_F16 = 1e-6, 2e-6, 1e-5, 2.0 ** -10
#: the unary table and its float domain (any, unit, pos, ge1); the
#: exact ones (rounding, sign, bit and class tests) at NP_EW
NP_UNARY = {
    "negative": "any", "positive": "any", "abs": "any", "fabs": "any",
    "sign": "any", "rint": "any", "ceil": "any", "floor": "any",
    "trunc": "any", "fix": "any", "square": "any", "sqrt": "pos",
    "cbrt": "any", "reciprocal": "pos", "exp": "any", "exp2": "any",
    "expm1": "any", "log": "pos", "log2": "pos", "log10": "pos",
    "log1p": "pos", "sin": "any", "cos": "any", "tan": "unit",
    "arcsin": "unit", "arccos": "unit", "arctan": "any", "sinh": "any",
    "cosh": "any", "tanh": "any", "arcsinh": "any", "arccosh": "ge1",
    "arctanh": "unit", "degrees": "any", "radians": "any",
    "deg2rad": "any", "rad2deg": "any", "invert": "any",
    "bitwise_not": "any", "logical_not": "any", "isnan": "any",
    "isinf": "any", "isneginf": "any", "isposinf": "any",
    "isfinite": "any", "signbit": "any", "conjugate": "any",
    "conj": "any", "real": "any", "imag": "any", "angle": "any",
    "around": "any", "round": "any", "round_": "any", "nan_to_num": "any",
    "absolute": "any",
}
NP_DOMAIN = {"any": (-2.0, 2.0), "unit": (-0.9, 0.9), "pos": (0.1, 3.0),
             "ge1": (1.0, 3.0)}
NP_BINARY = ["add", "subtract", "multiply", "divide", "true_divide",
             "floor_divide", "mod", "remainder", "fmod", "power",
             "float_power", "maximum", "minimum", "fmax", "fmin", "hypot",
             "arctan2", "logaddexp", "logaddexp2", "copysign", "nextafter",
             "ldexp", "heaviside", "bitwise_and", "bitwise_or",
             "bitwise_xor", "left_shift", "right_shift", "gcd", "lcm",
             "equal", "not_equal", "less", "less_equal", "greater",
             "greater_equal", "logical_and", "logical_or", "logical_xor"]
NP_REDUCE = ["sum", "prod", "mean", "max", "min", "amax", "amin", "nansum",
             "nanprod", "nanmean", "nanmax", "nanmin", "all", "any",
             "alltrue", "sometrue", "product", "std", "var", "ptp",
             "argmax", "argmin", "nanargmax", "nanargmin", "cumsum",
             "cumprod", "median", "nanmedian", "count_nonzero", "average",
             "msort", "sort", "argsort", "unique", "trace"]
#: torch's own kernel behind a function of the crosses, tried on the
#: card in every dtype: a refusal names a dtype the port routes, and how
ROUTES = {
    "sort / argsort / median / unique / lexsort": (
        lambda torch, t: torch.sort(t, stable=True),
        "uint16/uint32 as int64, bool as uint8 (_ordered)"),
    "searchsorted": (
        lambda torch, t: torch.searchsorted(t.reshape(-1), t.reshape(-1)),
        "uint16/uint32 as int64, bool as uint8 (_ordered)"),
    "cumsum / cumprod": (lambda torch, t: torch.cumsum(t, 0),
                         "every integer in int64, wrapped back"),
    "take / delete / compress (index_select)": (
        lambda torch, t: t.index_select(0, torch.zeros(1, dtype=torch.long,
                                                       device=t.device)),
        "uint16/uint32 as the signed type (_signed_view)"),
    "rot90 / roll / tril / diag / flip": (
        lambda torch, t: torch.rot90(t), "_signed_view"),
    "isnan / signbit / ceil ... (unary table)": (
        lambda torch, t: torch.isnan(t), "uint16/uint32 as int64"),
    "nonzero / argwhere / trim_zeros": (
        lambda torch, t: torch.nonzero(t), "uint16/uint32 as int64"),
    "amax / ptp / nanmax": (lambda torch, t: torch.amax(t),
                            "uint16/uint32 as int64"),
    "gcd / lcm": (lambda torch, t: torch.gcd(t, t),
                  "every integer in int64, wrapped back"),
    "fmax / fmin": (lambda torch, t: torch.fmax(t, t),
                    "bool as uint8; uint16/uint32 as int64"),
    "diff / ediff1d": (lambda torch, t: torch.diff(t, dim=0),
                       "uint16/uint32 as int64 (_wide_first)"),
    "count_nonzero / all / any": (lambda torch, t: torch.all(t, 0),
                                  "a bool copy; uint16/uint32 as int64"),
    "angle": (lambda torch, t: torch.angle(t),
              "integers and bool in float32, float16 in float32 (_angle)"),
}


def _np_values(dt, shape=(3, 4), seed=0, lo=-2.0, hi=2.0):
    """Seeded values of ``dt``, as the CPU tests make them: floats uniform
    in [lo, hi), integers in [0, 5) or [-5, 5), bools half true."""
    rs = np.random.RandomState(seed)
    if dt == "bool":
        return rs.rand(*shape) > 0.5
    if dt.startswith("uint"):
        return rs.randint(0, 5, shape).astype(dt)
    if dt.startswith("int"):
        return rs.randint(-5, 5, shape).astype(dt)
    return rs.uniform(lo, hi, shape).astype(dt)


def _np_cases():
    """(path, args, kwargs, tolerance) of the phase's calls beyond the
    crosses: every other function of mx.np, .linalg and .fft at least
    once."""
    f, i = _np_values("float32", seed=1), _np_values("int32", seed=2)
    v, w = _np_values("float32", (7,), 3), _np_values("float32", (4,), 4)
    a = _np_values("float32", (4, 4), 5) + 3 * np.eye(4, dtype="f4")
    sq = _np_values("float32", (4, 4), 6)
    spd = (sq @ sq.T + 4 * np.eye(4)).astype("f4")
    r = _np_values("float32", (5, 3), 7)
    c = (v + 1j * _np_values("float32", (7,), 8)).astype("c8")
    k = _np_values("int32", (8,), 9)
    q = np.array([0.1, 0.5, 0.9], "f4")
    E, R = NP_EW, NP_RED
    return [
        # creation helpers
        ("logspace", (0.0, 2.0), {"num": 7}, E), ("identity", (3,), {}, E),
        ("tri", (3, 5), {"k": 1}, E), ("tril", (f,), {}, E),
        ("triu", (f,), {"k": 1}, E), ("diag", (f,), {"k": 1}, E),
        ("diagflat", (v,), {}, E), ("diagonal", (f,), {"offset": 1}, E),
        ("diag_indices_from", (a,), {}, E), ("tril_indices", (4,), {}, E),
        ("tril_indices_from", (a,), {"k": 1}, E),
        ("triu_indices", (4,), {"k": 1}, E), ("triu_indices_from", (a,), {}, E),
        ("indices", ((2, 3),), {}, E), ("meshgrid", (v, w), {}, E),
        ("ascontiguousarray", (f,), {}, E),
        # shapes
        ("swapaxes", (f, 0, 1), {}, E), ("moveaxis", (f, 0, -1), {}, E),
        ("rollaxis", (f, 1), {}, E), ("permute_dims", (f, (1, 0)), {}, E),
        ("atleast_1d", (np.float32(2.0),), {}, E),
        ("atleast_2d", (v,), {}, E), ("atleast_3d", (f,), {}, E),
        ("broadcast_arrays", (f, f[0]), {}, E), ("vstack", ([f, f],), {}, E),
        ("row_stack", ([f, f],), {}, E), ("hstack", ([f, f],), {}, E),
        ("dstack", ([f, f],), {}, E), ("column_stack", ([v, v],), {}, E),
        ("array_split", (v, 3), {}, E), ("hsplit", (f, 2), {}, E),
        ("vsplit", (f, [1]), {}, E), ("dsplit", (f[None], 2), {}, E),
        ("repeat", (f, 2), {"axis": 1}, E), ("fliplr", (f,), {}, E),
        ("flipud", (f,), {}, E), ("rot90", (f,), {}, E),
        ("roll", (f, 2), {}, E), ("append", (v, 3.0), {}, E),
        ("insert", (v, 2, 9.0), {}, E), ("delete", (f, 1), {"axis": 1}, E),
        ("trim_zeros", (np.array([0, 0, 3, 0, 5, 0], "i4"),), {}, E),
        ("unique", (i,), {"return_index": True, "return_inverse": True,
                          "return_counts": True}, E),
        ("resize", (v, (3, 4)), {}, E),
        *[("pad", (f, ((1, 2), (3, 0))), dict(kw, mode=m), R)
          for m, kw in (("constant", {"constant_values": 7}), ("edge", {}),
                        ("wrap", {}), ("reflect", {}),
                        ("symmetric", {"reflect_type": "odd"}),
                        ("linear_ramp", {"end_values": (5, -3)}),
                        ("maximum", {}), ("minimum", {}), ("mean", {}),
                        ("median", {}), ("empty", {}))],
        # sorting, searching, indexing
        ("lexsort", ((k, k[::-1]),), {}, E), ("partition", (v, 3), {}, E),
        ("argpartition", (v, 3), {}, E), ("nonzero", (i,), {}, E),
        ("flatnonzero", (i,), {}, E), ("argwhere", (i,), {}, E),
        ("where", (i > 0,), {}, E),
        ("take_along_axis", (f, np.argsort(f, 1).astype("i4"), 1), {}, E),
        ("compress", (i[0] > 0, f), {"axis": 1}, E),
        ("extract", (i > 0, f), {}, E),
        ("unravel_index", (np.array([0, 5, 11, 13], "i4"), (3, 4)), {}, E),
        ("ravel_multi_index", ((np.array([0, 2], "i4"),
                                np.array([3, 1], "i4")), (3, 4)), {}, E),
        # products, logic, numerical helpers
        ("vdot", (v, v), {}, R), ("inner", (f, f), {}, R),
        ("outer", (v, w), {}, R), ("tensordot", (f, f.T), {"axes": 1}, R),
        ("tensordot", (i, i.T), {"axes": 1}, R), ("kron", (w, w), {}, R),
        ("cross", (r, r[::-1]), {}, R), ("einsum", ("ij,jk->ik", f, f.T), {}, R),
        ("einsum", ("ij,kj", i, i), {}, R), ("matrix_power", (a, 3), {}, R),
        ("matrix_power", (i[:3, :3], 2), {}, R), ("vander", (w,), {}, R),
        ("isclose", (f, f + 1e-6), {}, E), ("diff", (f,), {"n": 2}, E),
        ("ediff1d", (v,), {"to_begin": 1.0}, E),
        ("gradient", (f,), {}, E), ("convolve", (v, w), {}, R),
        ("correlate", (v, w), {"mode": "same"}, R), ("cov", (f,), {}, R),
        ("corrcoef", (f,), {}, R), ("polyval", (w, f), {}, R),
        ("interp", (np.linspace(-1, 5, 9).astype("f4"),
                    np.array([0, 1, 2.5, 4], "f4"),
                    np.array([1, 3, -1, 2], "f4")), {}, E),
        ("quantile", (f, q), {"axis": 1}, R),
        ("percentile", (f, q * 100), {"interpolation": "nearest"}, R),
        ("bincount", (np.abs(k),), {"minlength": 9}, E),
        ("histogram", (v,), {"bins": 4}, R),
        ("blackman", (7,), {}, E), ("hamming", (8,), {}, E),
        ("hanning", (9,), {}, E),
        # linalg
        *[(f"linalg.{n}", args, kw, R) for n, args, kw in (
            ("norm", (a,), {}), ("norm", (r,), {"axis": 1, "ord": 1}),
            ("inv", (a,), {}), ("pinv", (r,), {}), ("det", (a,), {}),
            ("slogdet", (a,), {}), ("solve", (a, r[:4]), {}),
            ("lstsq", (r, v[:5]), {}), ("tensorinv", (a.reshape(2, 2, 2, 2),),
                                         {}),
            ("tensorsolve", (a.reshape(2, 2, 2, 2), w.reshape(2, 2)), {}),
            ("eigvalsh", (spd,), {}), ("cholesky", (spd,), {}),
            ("matrix_rank", (r,), {}), ("matrix_power", (a, 2), {}),
            ("multi_dot", ([r.T, r, r[0]],), {}), ("cond", (a,), {}))],
        # fft
        *[(f"fft.{n}", args, kw, R) for n, args, kw in (
            ("fft", (v,), {}), ("ifft", (c,), {}), ("rfft", (v,), {}),
            ("irfft", (c,), {}), ("hfft", (c,), {}), ("ihfft", (v,), {}),
            ("fft2", (f,), {}), ("ifft2", (f,), {}), ("rfft2", (f,), {}),
            ("irfft2", (f.astype("c8"),), {}), ("fftn", (f,), {}),
            ("ifftn", (f,), {}), ("rfftn", (f,), {}),
            ("irfftn", (f.astype("c8"),), {}), ("fftshift", (f,), {}),
            ("ifftshift", (f,), {}), ("fftfreq", (8, 0.5), {}),
            ("rfftfreq", (9,), {}))],
        # financial, on float32 arrays (a scalar call gives a float)
        *[(n, args, {}, R) for n, args in (
            ("fv", (np.array([0.004, 0.006], "f4"), 120, -100, -100)),
            ("pv", (np.array([0.004, 0.006], "f4"), 240, -500)),
            ("pmt", (np.array([0.004, 0.006], "f4"), 180, 2000)),
            ("nper", (np.array([0.004, 0.006], "f4"), -150, 8000)),
            ("ipmt", (np.array([0.008, 0.01], "f4"), 3, 24, 2000)),
            ("ppmt", (np.array([0.008, 0.01], "f4"), 5, 60, 5500)),
            ("npv", (0.28, np.array([-100, 39, 59, 55, 20], "f4"))),
            ("mirr", (np.array([-4500, -800, 800, 800, 600, 600, 800, 800,
                                700, 3000], "f4"), 0.08, 0.055)),
            ("irr", (np.array([-150000, 15000, 25000, 35000, 45000, 60000],
                              "f4"),)),
            ("rate", (10, 0, -3500, 10000)))],
    ]


def _np_same(mx, card, host, tol, what):
    """A card result against the CPU port's: the same structure, every
    array on the card, dtype and shape equal, integers and bools equal,
    floats within ``tol`` (NP_F16 for float16) relative and absolute."""
    if isinstance(host, (list, tuple)):
        check(isinstance(card, (list, tuple)) and len(card) == len(host),
              f"{what}: {type(card)} vs {type(host)}")
        for c, h in zip(card, host):
            _np_same(mx, c, h, tol, what)
        return
    if not isinstance(host, mx.nd.NDArray):
        check(type(card) is type(host), f"{what}: {card!r} vs {host!r}")
        if isinstance(host, float):
            check(math.isclose(card, host, rel_tol=tol, abs_tol=tol)
                  or (math.isnan(card) and math.isnan(host)),
                  f"{what}: {card} vs {host}")
        else:
            check(card == host, f"{what}: {card!r} vs {host!r}")
        return
    check(card._data.is_cuda, f"{what}: the result is not on the card")
    check(card.dtype == host.dtype and card.shape == host.shape,
          f"{what}: card {card.dtype}{card.shape} vs CPU "
          f"{host.dtype}{host.shape}")
    c, h = card.asnumpy(), host.asnumpy()
    if np.dtype(c.dtype).kind in "biu":
        check(np.array_equal(c, h), f"{what}: values differ")
        return
    t = NP_F16 if c.dtype == np.float16 else tol
    cc, hh = c.astype("c16"), h.astype("c16")
    check(np.allclose(cc, hh, rtol=t, atol=t, equal_nan=True),
          f"{what}: card {cc.ravel()[:8]} vs CPU {hh.ravel()[:8]}")


def _np_call(mx, path, args, kw):
    fn = mx.np
    if path.startswith("npx."):
        fn, path = mx.npx, path[4:]
    for part in path.split("."):
        fn = getattr(fn, part)

    def lift(x):
        if isinstance(x, np.ndarray):
            return mx.np.array(x, dtype=x.dtype)
        if isinstance(x, (list, tuple)) and x \
                and isinstance(x[0], np.ndarray):
            return type(x)(lift(y) for y in x)
        return x
    return fn(*[lift(x) for x in args], **kw)


def _np_both(mx, path, args, kw, tol, failures, called, both_raised=None):
    """``path`` on the card and on the CPU; a mismatch, or one side
    raising, is a failure. Both sides raising is agreement only in a
    dtype cross, where ``both_raised`` is a list (a dtype the function
    refuses on both), which then collects the case; without it, it is a
    failure. ``path`` joins ``called`` once a comparison has passed."""
    err = []
    outs = []
    for ctx in (None, mx.cpu()):
        try:
            if ctx is None:
                outs.append(_np_call(mx, path, args, kw))
            else:
                with ctx:
                    outs.append(_np_call(mx, path, args, kw))
        except Exception as e:          # noqa: BLE001 (compared below)
            err.append(f"{'card' if ctx is None else 'cpu'}: "
                       f"{type(e).__name__}: {str(e)[:160]}")
            outs.append(e)
    tag = f"{path}{tuple(getattr(a, 'dtype', a) for a in args[:2])}"
    if len(err) == 2 and both_raised is not None:
        both_raised.append(tag)
        return
    if err:
        failures.append(f"{tag}: {'; '.join(err)}")
        return
    try:
        _np_same(mx, outs[0], outs[1], tol, tag)
    except AssertionError as e:
        failures.append(str(e))
        return
    called.add(path)


def _np_random(mx, called, failures):
    """Every sampler on the card: the CPU port's dtype and shape, finite
    values (the card's Philox and the CPU's generator differ), and the
    port's seeded repeat on the card."""
    r = mx.np.random
    cases = [("uniform", (0.0, 2.0)), ("normal", (1.0, 2.0)), ("rand", ()),
             ("randn", ()), ("randint", (0, 7)), ("beta", (2.0, 5.0)),
             ("gamma", (3.0,)), ("exponential", (2.0,)),
             ("laplace", (1.0, 2.0)), ("logistic", (1.0, 2.0)),
             ("gumbel", (0.5, 2.0)), ("lognormal", (0.2, 0.5)),
             ("pareto", (5.0,)), ("power", (3.0,)), ("rayleigh", (2.0,)),
             ("weibull", (2.0,)), ("chisquare", (4.0,)), ("f", (5.0, 10.0)),
             ("binomial", (10, 0.3)), ("negative_binomial", (5, 0.4)),
             ("poisson", (3.5,)), ("geometric", (0.25,)),
             ("bernoulli", (0.25,)), ("choice", (7,)), ("permutation", (6,)),
             ("multinomial", (20, [0.2, 0.3, 0.5])),
             ("multivariate_normal", ([0.0, 1.0], [[1.0, 0.3], [0.3, 2.0]]))]
    sized = {"rand": (2, 3), "randn": (2, 3)}
    for name, args in cases:
        called.add(f"random.{name}")
        kw = {} if name in ("permutation",) else {"size": (2, 3)}
        fn = getattr(r, name)
        try:
            card = fn(*sized[name]) if name in sized else fn(*args, **kw)
            with mx.cpu():
                host = fn(*sized[name]) if name in sized \
                    else fn(*args, **kw)
            check(card._data.is_cuda and card.dtype == host.dtype
                  and card.shape == host.shape
                  and bool(np.isfinite(card.asnumpy().astype("f8")).all()),
                  f"random.{name}: card {card.dtype}{card.shape} vs CPU "
                  f"{host.dtype}{host.shape}")
        except Exception as e:          # noqa: BLE001 (reported)
            failures.append(f"random.{name}: {type(e).__name__}: {e}")
    x = mx.np.array(np.arange(12, dtype="f4"))
    r.shuffle(x)
    called.update({"random.shuffle", "random.seed"})
    check(sorted(x.asnumpy().tolist()) == list(range(12)),
          "random.shuffle lost elements on the card")
    draws = []
    for _ in range(2):
        r.seed(99)
        draws.append([r.gamma(2.0, size=(5,)).asnumpy(),
                      r.choice(9, size=(4,)).asnumpy()])
    check(all(np.array_equal(a, b) for a, b in zip(*draws)),
          "seeded draws on the card do not repeat")


def phase_numpy(torch, smi):
    """The rest of ``mx.np`` on the card (the port of the JAX package's
    numpy module, its linalg, fft and random): the unary, binary and
    reduction tables, sort/argsort/unique/searchsorted/take crossed over
    NP_DTYPES, and every other function at least once, each on seeded
    numpy inputs against the same call on the CPU (NP_EW ... NP_F16);
    the samplers by dtype, shape and seeded repeats; which of torch's
    card kernels refuse a dtype and the port's route for it; no call of
    the host fallback; the NumPy protocols on the card; and
    ``npx.decode_attention`` through K2 (fp32 and bf16 caches at the
    decode phase's shape) against its plain version, counting K2's
    launches."""
    import io
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops, random_state
    from mxnet_tpu_torch.ops import attention as at
    ops.reset_launch_counts()
    rng_state = random_state.get_state()     # the later phases' draws
    fallback0 = sum(mx.np.FALLBACK_CALLS.values())
    failures, called, refused_both = [], set(), []
    for name, dom in NP_UNARY.items():
        lo, hi = NP_DOMAIN[dom]
        exact = name in ("negative", "positive", "abs", "absolute", "fabs",
                         "sign", "rint", "ceil", "floor", "trunc", "fix",
                         "square", "invert", "bitwise_not", "logical_not",
                         "isnan", "isinf", "isneginf", "isposinf",
                         "isfinite", "signbit", "conjugate", "conj", "real",
                         "imag", "around", "round", "round_", "nan_to_num")
        for dt in NP_DTYPES:
            _np_both(mx, name, (_np_values(dt, lo=lo, hi=hi, seed=1),), {},
                     NP_EW if exact else NP_TR, failures, called, refused_both)
    for name in NP_BINARY:
        for dt in NP_DTYPES:
            x = _np_values(dt, lo=0.2, hi=2.0, seed=3)
            y = _np_values(dt, lo=0.2, hi=2.0, seed=4)
            if dt[0] != "f":
                y = np.where(y == 0, 1, y).astype(dt)    # no integer / 0
            if name == "ldexp" and dt[0] == "f":
                y = _np_values("int8", seed=4)
            _np_both(mx, name, (x, y), {}, NP_TR, failures, called,
                     refused_both)
    for name in NP_REDUCE:
        for dt in NP_DTYPES:
            _np_both(mx, name, (_np_values(dt, seed=5),), {}, NP_RED,
                     failures, called, refused_both)
    idx = np.array([[0, 3, -1], [5, 2, 11]], "i4")
    for dt in NP_DTYPES:
        s = np.sort(_np_values(dt, (6,), 6))
        for path, args, kw in (
                ("searchsorted", (s, _np_values(dt, (2, 3), 7)), {}),
                ("take", (_np_values(dt, seed=8), idx), {"axis": 1,
                                                         "mode": "wrap"}),
                ("take", (_np_values(dt, seed=8), idx), {}),
                ("sort", (_np_values(dt, seed=9),), {"axis": 0}),
                ("unique", (_np_values(dt, seed=10),),
                 {"return_index": True, "return_counts": True}),
                ("cumsum", (_np_values(dt, seed=11),), {"axis": 1})):
            _np_both(mx, path, args, kw, NP_RED, failures, called,
                     refused_both)
    for path, args, kw, tol in _np_cases():
        _np_both(mx, path, args, kw, tol, failures, called)
    _np_random(mx, called, failures)

    # the rest, on the card and compared by hand
    f = _np_values("float32", seed=12)
    card = mx.np.array(f)
    called.update({"allclose", "array_equal", "array_equiv", "ndim", "shape",
                   "size", "may_share_memory", "shares_memory",
                   "result_type", "promote_types", "can_cast", "fill_diagonal",
                   "put_along_axis", "save", "savez", "load", "genfromtxt",
                   "fromiter", "get_printoptions", "set_printoptions",
                   "get_include", "linalg.svd", "linalg.qr", "linalg.eigh",
                   "linalg.eig", "linalg.eigvals"})
    check(mx.np.allclose(card, card + 1e-9) and mx.np.array_equal(card, card)
          and mx.np.array_equiv(card, card[:1]) is False
          and mx.np.ndim(card) == 2 and mx.np.shape(card) == (3, 4)
          and mx.np.size(card, 1) == 4
          and not mx.np.may_share_memory(card, card)
          and not mx.np.shares_memory(card, card)
          and mx.np.result_type(card, 2.0) == np.float32
          and mx.np.promote_types("int8", "uint8") == np.int16
          and mx.np.can_cast(card, "float64"), "the helpers on the card")
    fd = mx.np.array(np.zeros((3, 3), "f4"))
    mx.np.fill_diagonal(fd, 5.0)
    pa = mx.np.array(f)
    mx.np.put_along_axis(pa, mx.np.array(np.zeros((3, 1), "i4")), 9.0, 1)
    check(fd._data.is_cuda and fd.asnumpy().trace() == 15.0
          and pa._data.is_cuda and (pa.asnumpy()[:, 0] == 9.0).all(),
          "fill_diagonal/put_along_axis on the card")
    with tempfile.TemporaryDirectory() as tmp:
        mx.np.save(f"{tmp}/a.npy", card)
        mx.np.savez(f"{tmp}/b.npz", card, x=card)
        back = mx.np.load(f"{tmp}/a.npy")
        both = mx.np.load(f"{tmp}/b.npz")
    check(back._data.is_cuda and np.array_equal(back.asnumpy(), f)
          and set(both) == {"arr_0", "x"}, "save/load on the card")
    check(mx.np.genfromtxt(io.StringIO("1 2\n3 4\n"))._data.is_cuda
          and mx.np.fromiter(range(4), dtype="int32")._data.is_cuda
          and isinstance(mx.np.get_printoptions(), dict)
          and isinstance(mx.np.get_include(), str),
          "text sources on the card")
    mx.np.set_printoptions(**mx.np.get_printoptions())
    m = mx.np.array(_np_values("float32", (5, 3), 13))
    u, s, vh = mx.np.linalg.svd(m)
    qq, rr = mx.np.linalg.qr(m)
    sym = m.T @ m
    w, vv = mx.np.linalg.eigh(sym)
    ew, ev = mx.np.linalg.eig(sym)
    mn = m.asnumpy()
    check(np.allclose((u * s[None]) @ vh.asnumpy(), mn, atol=1e-4)
          and np.allclose(qq.asnumpy() @ rr.asnumpy(), mn, atol=1e-4)
          and np.allclose(vv.asnumpy() @ np.diag(w.asnumpy())
                          @ vv.asnumpy().T, sym.asnumpy(), atol=1e-4)
          and np.allclose(np.sort(ew.asnumpy()), np.sort(w.asnumpy()),
                          atol=1e-4)
          and np.allclose(np.sort(mx.np.linalg.eigvals(sym).asnumpy()),
                          np.sort(w.asnumpy()), atol=1e-4)
          and ev.shape == (3, 3) and u._data.is_cuda and ew._data.is_cuda,
          "decompositions on the card")

    # the NumPy protocols: numpy's functions and ufuncs on card arrays run
    # the port's natives on the card
    for out in (np.cumsum(card), np.sort(card), np.sqrt(card),
                np.add(card, np.ones(4, "f4")),
                np.array([1.0] * 4, "f4") < card, np.linalg.inv(
                    mx.np.array(np.eye(3, dtype="f4") * 2))):
        check(isinstance(out, mx.nd.NDArray) and out._data.is_cuda,
              "a NumPy protocol call left the card")
    fallback = sum(mx.np.FALLBACK_CALLS.values()) - fallback0

    # the functions of mx.np, .linalg, .fft and .random never called
    import types
    public = set()
    for sub, mod in (("", mx.np), ("linalg.", mx.np.linalg),
                     ("fft.", mx.np.fft), ("random.", mx.np.random)):
        for name, val in vars(mod).items():
            if name.startswith("_") or not callable(val) \
                    or isinstance(val, (type, types.ModuleType)):
                continue
            src = getattr(val, "__module__", "") or ""
            if src.startswith(("mxnet_tpu_torch.numpy", "numpy")):
                public.add(sub + name)
    earlier = {"array", "asarray", "zeros", "ones", "empty", "full",
               "zeros_like", "ones_like", "full_like", "empty_like",
               "arange", "linspace", "eye", "copy", "clip", "reshape",
               "transpose", "expand_dims", "squeeze", "ravel",
               "broadcast_to", "concatenate", "concat", "stack", "split",
               "tile", "flip", "dot", "matmul"}
    uncalled = sorted(public - called - earlier)

    # which of torch's card kernels refuse a dtype, and the port's route
    refused = {}
    for what, (raw, route) in ROUTES.items():
        bad = []
        for dt in NP_DTYPES:
            t = torch.from_numpy(_np_values(dt, (4, 4), 14)).cuda()
            try:
                raw(torch, t)
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError):
                bad.append(dt)
        if bad:
            refused[what] = {"refused_on_card": bad, "port_route": route}
    print("numpy: torch kernels that refused a dtype on the card, and the "
          "port's route:", json.dumps(refused), flush=True)

    # npx.decode_attention: K2 through the front end
    rng = np.random.RandomState(16)
    b, h, s_, d = 8, 12, 1024, 64
    lengths = [0, 1, 63, 64, 65, 500, 1023, 1024]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = _split_view(torch, rng, b, 1, h, d)
    k, v = _rand(torch, rng, b, h, s_, d), _rand(torch, rng, b, h, s_, d)
    scale = 1.0 / math.sqrt(d)
    dec = {}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        name = "decode_attention" + ("" if tag == "fp32" else "_bf16")
        n0 = ops.launch_counts().get(name, 0)
        kk, vv2, qq2 = k.to(dt), v.to(dt), q.to(dt)
        out = mx.npx.decode_attention(mx.nd.NDArray(qq2), mx.nd.NDArray(kk),
                                      mx.nd.NDArray(vv2),
                                      mx.nd.NDArray(lens))
        plain = at._decode_fwd_torch(qq2.float(), kk.float(), vv2.float(),
                                     lens, scale).to(dt)
        torch.cuda.synchronize()
        launched = ops.launch_counts().get(name, 0) - n0
        if tag == "fp32":
            err, tol = float((out._data - plain).abs().max()), OUT_TOL
        else:
            err, tol = _half_err(out._data, plain, BF16_ULP)
        dec[tag] = {"kernel": name, "launches": launched, "max_abs_err": err,
                    "tol": tol, "dtype": str(out.dtype)}
        check(launched == 1 and out._data.dtype == dt and err <= tol,
              f"npx.decode_attention {tag}: {dec[tag]}")

    # the host's cost of a call, beside an mx.np multiply
    x3 = mx.np.array(np.array([3.0, 1.0, 2.0], "f4"))
    m3 = mx.np.array(np.eye(3, dtype="f4"))
    host_us = {}
    for key, fn in (("mx_np_multiply", lambda: x3 * 2.0),
                    ("cumsum", lambda: mx.np.cumsum(x3)),
                    ("sort", lambda: mx.np.sort(x3)),
                    ("einsum", lambda: mx.np.einsum("ij,j->i", m3, x3))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host_us[key] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    random_state.set_state(*rng_state)
    print(f"numpy: {len(refused_both)} dtype-cross cases raised on both the "
          f"card and the CPU: {refused_both}", flush=True)
    res = {"calls": len(called), "failures": failures,
           "both_raised": len(refused_both),
           "uncalled": uncalled, "fallback_calls": fallback,
           "refused_on_card": refused, "decode_attention": dec,
           "host_us_per_call": host_us, "nvidia_smi": smi,
           "launches": ops.launch_counts()}
    emit("numpy", **res)
    check(not failures, f"{len(failures)} numpy calls failed on the card: "
          f"{failures[:10]}")
    check(not uncalled, f"functions the numpy phase never called: "
          f"{uncalled}")
    check(fallback == 0, f"{fallback} calls reached the host fallback")
    return res


#: torch's own kernels behind the npx routes, tried on the card in every
#: dtype (as ROUTES): a refusal names a dtype the port routes, and how
def _npx_idx(torch, t):
    return torch.zeros(2, dtype=torch.long, device=t.device)


NPX_ROUTES = {
    "index_put accumulate (npx.index_add)": (
        lambda torch, t: t.index_put((_npx_idx(torch, t),), t[:2],
                                     accumulate=True),
        "uint16/uint32 in int64, wrapped back"),
    "index_put (npx.index_update, scatter_nd)": (
        lambda torch, t: t.index_put((_npx_idx(torch, t),), t[:2]),
        "uint16/uint32 as the signed type (_put)"),
    "advanced indexing (npx.gather_nd)": (
        lambda torch, t: t[_npx_idx(torch, t)],
        "uint16/uint32 as the signed type (_signed_view)"),
    "index_select (npx.boolean_mask)": (
        lambda torch, t: t.index_select(0, _npx_idx(torch, t)),
        "uint16/uint32 as the signed type (_signed_view)"),
    "constant_pad_nd + amax of windows (npx.pooling max)": (
        lambda torch, t: torch.nn.functional.pad(
            t[None], (1, 1), value=0).unfold(2, 2, 2).amax(-1),
        "uint16/uint32 pooled as int64"),
    "sum of windows in the type (npx.pooling sum/avg)": (
        lambda torch, t: t.unfold(1, 2, 2).sum(-1, dtype=t.dtype),
        "uint16/uint32 pooled as int64"),
    "abs (npx.smooth_l1)": (lambda torch, t: torch.abs(t),
                            "bool, uint16/uint32 in int64"),
    "ge (npx.leaky_relu)": (lambda torch, t: t >= 0,
                            "uint16/uint32 in int64"),
    "relu (npx.relu, npx.activation)": (
        lambda torch, t: torch.relu(t),
        "bool as int32, uint16/uint32 in int64"),
    "sigmoid (npx.sigmoid, float activations)": (
        lambda torch, t: torch.sigmoid(t),
        "integers and bool in the default float (float_input)"),
    "matmul (npx.batch_dot)": (lambda torch, t: torch.matmul(t, t.T),
                               "integers and bool exact in int64"),
    "lgamma (npx.gammaln, gamma)": (lambda torch, t: torch.lgamma(t),
                                    "integers and bool in float32"),
}
#: the activation table and the special functions, crossed over NP_DTYPES
NPX_UNARY = (
    [("npx.activation", {"act_type": a})
     for a in ("relu", "sigmoid", "log_sigmoid", "tanh", "softrelu",
               "softsign", "mish", "relu6", "gelu", "silu", "swish")]
    + [("npx.leaky_relu", {"act_type": a, "slope": 0.3})
       for a in ("leaky", "elu", "selu", "gelu", "gelu_tanh", "silu")]
    + [("npx." + n, {}) for n in (
        "relu", "sigmoid", "log_sigmoid", "softsign", "softplus", "mish",
        "gelu", "silu", "hard_sigmoid", "hard_swish", "softmin", "gamma",
        "gammaln", "erf", "erfinv", "digamma", "rsqrt", "rcbrt",
        "smooth_l1", "all_finite", "arange_like", "index_array",
        "shape_array", "softmax", "log_softmax")]
    + [("npx.gelu", {"approximate": True})])
#: functions of the phase that launch none of the port's kernels but
#: flash_attention, held by hand below
NPX_BY_HAND = {"npx.flash_attention", "npx.decode_attention", "npx.custom",
               "npx.waitall", "npx.num_gpus", "npx.current_device",
               "npx.set_np", "npx.reset_np", "npx.is_np_array",
               "npx.is_np_shape", "npx.dropout", "npx.random",
               "npx.foreach", "npx.while_loop", "npx.cond"}


def _npx_cases():
    """(path, args, kwargs, tolerance) of the npx phase beyond the unary
    crosses: every layer, indexing op and head at least once, the
    dtype-sensitive ones over the dtypes whose card kernels refuse."""
    v = _np_values
    f, R = "float32", NP_RED
    cases = []
    for lay, xs, ws in (("NCHW", (2, 4, 7, 6), (6, 2, 3, 3)),
                        ("NHWC", (2, 7, 6, 4), (6, 3, 3, 2)),
                        ("NCW", (2, 4, 9), (6, 2, 3)),
                        ("NDHWC", (1, 5, 4, 6, 4), (6, 3, 3, 3, 2))):
        nsp = len(lay) - 2
        kw = dict(kernel=(3,) * nsp, num_group=2, layout=lay, pad=1)
        cases.append(("npx.convolution", (v(f, xs, 1), v(f, ws, 2),
                                          v(f, (6,), 3)),
                      dict(kw, stride=2), R))
        dws = (4, 3, 3, 3)[:nsp + 2] if lay.startswith("NC") else \
            (4,) + (3,) * nsp + (3,)
        cases.append(("npx.deconvolution", (v(f, xs, 4), v(f, dws, 5)),
                      dict(kw, stride=2, adj=1), R))
    cases.append(("npx.convolution", (v("float16", (2, 4, 7, 6), 6),
                                      v("float16", (6, 2, 3, 3), 7)),
                  dict(kernel=(3, 3), num_group=2, no_bias=True), R))
    for dt in NP_DTYPES:
        x = v(dt, (2, 3, 7, 6), 8)
        for pt in ("max", "avg", "sum"):
            cases.append(("npx.pooling", (x,), dict(kernel=2, pool_type=pt,
                                                    stride=2, pad=1), R))
    x = v(f, (2, 3, 7, 6), 9)
    for conv in ("valid", "full", "same"):
        for pt in ("max", "avg", "lp"):
            cases.append(("npx.pooling", (x,), dict(
                kernel=3, pool_type=pt, stride=2, pad=1,
                pooling_convention=conv, count_include_pad=False), R))
    cases.append(("npx.pooling", (x,), dict(pool_type="avg",
                                            global_pool=True), R))
    g, b = v(f, (3,), 10, 0.5, 1.5), v(f, (3,), 11)
    for dt in ("float32", "float16"):
        xn = v(dt, (4, 3, 5), 12)
        cases += [
            ("npx.layer_norm", (xn, v(f, (5,), 13), v(f, (5,), 14)), {}, R),
            ("npx.group_norm", (xn, g, b), {"num_groups": 3}, R),
            ("npx.instance_norm", (xn, g, b), {}, R),
            ("npx.rms_norm", (xn, v(f, (5,), 15)), {}, R),
            ("npx.l2_normalization", (xn,), {"mode": "channel"}, R),
            ("npx.batch_norm", (xn, g, b, v(f, (3,), 16),
                                v(f, (3,), 17, 0.5, 2.0)), {}, R)]
    xf = v(f, (3, 5), 18)
    m = v("bool", (3, 5), 19)
    m[:, 0] = True
    cases += [
        ("npx.masked_softmax", (xf, m), {"temperature": 2.0}, R),
        ("npx.masked_log_softmax", (xf, m), {}, R),
        ("npx.fully_connected", (v(f, (4, 2, 3), 20), v(f, (5, 6), 21),
                                 v(f, (5,), 22)), {}, R),
        ("npx.embedding", (v("int32", (2, 3), 23) + 5, v(f, (10, 4), 24)),
         {}, R),
        ("npx.one_hot", (v("int32", (4,), 25) + 5, 10), {}, R),
        ("npx.pick", (xf, v("int32", (3,), 26) + 5), {}, R),
        ("npx.topk", (xf,), {"k": 2, "ret_typ": "both"}, R)]
    idx = np.array([[0, 2, 2, 3], [1, 0, 0, 2]], "i4")
    for dt in NP_DTYPES:
        x43 = v(dt, (4, 3), 27)
        cases += [
            ("npx.index_add", (x43, idx, v(dt, (4,), 28)), {}, R),
            ("npx.index_update", (x43, idx[:, :2], v(dt, (2,), 29)), {}, R),
            ("npx.gather_nd", (x43, idx), {}, R),
            # distinct coordinates: a repeated one's winner is undefined
            ("npx.scatter_nd", (v(dt, (3,), 30), idx[:, [0, 1, 3]]),
             {"shape": (4, 3)}, R),
            ("npx.boolean_mask", (x43, np.array([1, 0, 1, 1], "i4")), {},
             R),
            ("npx.batch_dot", (v(dt, (2, 3, 4), 31), v(dt, (2, 4, 2), 32)),
             {}, R),
            ("npx.sequence_mask", (v(dt, (5, 3), 33),
                                   np.array([4, 2, 5], "i4")),
             {"use_sequence_length": True}, R)]
    x53 = v(f, (5, 3, 2), 34)
    sl = np.array([4, 2, 5], "i4")
    cases += [
        ("npx.sequence_last", (x53, sl), {"use_sequence_length": True}, R),
        ("npx.sequence_reverse", (x53, sl), {"use_sequence_length": True},
         R),
        ("npx.broadcast_like", (xf[:1], xf), {}, R),
        ("npx.reshape_like", (xf, v(f, (5, 3), 35)), {}, R),
        ("npx.slice_axis", (x53, 0, 1, 4), {}, R),
        ("npx.slice", (x53, (1, None, 0), (4, None, 2)), {}, R),
        ("npx.slice", (x53, (None, 2), (None, 0), (None, -1)), {}, R),
        ("npx.slice_like", (x53, v(f, (3, 2, 1), 35)), {}, R),
        ("npx.slice_like", (x53, xf), {"axes": (0,)}, R),
        ("npx.multi_sum_sq", (xf, v("float16", (4,), 36)), {}, R),
        ("npx.multi_all_finite", (xf, v("int32", (2,), 37)), {}, R),
        ("npx.upsampling", (v(f, (1, 2, 3, 3), 38),), {"scale": 2}, R),
        ("npx.upsampling", (v(f, (1, 2, 3, 3), 38), v(f, (2, 1, 4, 4), 39)),
         {"scale": 2, "sample_type": "bilinear", "num_filter": 2}, R),
        ("npx.multibox_prior", (v(f, (1, 2, 4, 5), 40),),
         {"sizes": (0.5, 0.25), "ratios": (1.0, 2.0)}, R),
        ("npx.roi_pooling", (v(f, (2, 3, 8, 8), 41),
                             np.array([[0, 0, 0, 7, 7], [1, 2, 1, 5, 6]],
                                      "f4")), {"pooled_size": (2, 2)}, R),
        ("npx.ctc_loss", (v(f, (8, 3, 5), 42),
                          np.array([[1, 2, 2, 0], [3, 1, 0, 0],
                                    [4, 4, 2, 1]], "i4")), {}, R)]
    return cases


#: differentiable npx calls whose gradients the phase holds on the card
#: against the CPU port: (path, args, kwargs, indices of the
#: differentiated arguments)
def _npx_grad_cases():
    from mxnet_tpu_torch.ops import nn as tnn
    v = _np_values
    f = "float32"
    cases = [
        ("npx.convolution", (v(f, (2, 4, 7, 6), 50), v(f, (6, 2, 3, 3), 51),
                             v(f, (6,), 52)),
         dict(kernel=(3, 3), num_group=2, stride=2, pad=1), (0, 1, 2)),
        ("npx.deconvolution", (v(f, (2, 4, 5, 6), 53),
                               v(f, (4, 3, 3, 3), 54)),
         dict(kernel=(3, 3), num_group=2, stride=2, pad=1), (0, 1)),
        ("npx.pooling", (v(f, (2, 3, 7, 6), 55),),
         dict(kernel=3, pool_type="avg", stride=2, pad=1,
              pooling_convention="full", count_include_pad=False), (0,)),
        ("npx.pooling", (v(f, (2, 3, 7, 6), 55),),
         dict(kernel=3, pool_type="max", stride=2, pad=1), (0,)),
        ("npx.batch_norm", (v(f, (4, 3, 5), 56), v(f, (3,), 57, 0.5, 1.5),
                            v(f, (3,), 58), v(f, (3,), 59),
                            v(f, (3,), 60, 0.5, 2.0)), {}, (0, 1, 2)),
        ("npx.group_norm", (v(f, (4, 4, 5), 61), v(f, (4,), 62),
                            v(f, (4,), 63)), {"num_groups": 2}, (0, 1, 2)),
        ("npx.instance_norm", (v(f, (4, 4, 5), 61), v(f, (4,), 62),
                               v(f, (4,), 63)), {}, (0, 1, 2)),
        ("npx.rms_norm", (v(f, (4, 4, 5), 61), v(f, (5,), 64)), {}, (0, 1)),
        ("npx.l2_normalization", (v(f, (4, 4, 5), 61),), {}, (0,)),
        ("npx.layer_norm", (v(f, (4, 4, 5), 61), v(f, (5,), 64),
                            v(f, (5,), 65)), {}, (0, 1, 2)),
        ("npx.softmax_output", (v(f, (4, 5), 66),
                                np.array([0, 3, 1, 4], "f4")),
         {"normalization": "batch", "smooth_alpha": 0.1}, (0,)),
        ("npx.make_loss", (v(f, (4, 5), 67),), {"normalization": "valid"},
         (0,)),
        ("npx.linear_regression_output", (v(f, (4, 3), 68), v(f, (4, 3), 69)),
         {"grad_scale": 2.0}, (0,)),
        ("npx.mae_regression_output", (v(f, (4, 3), 68), v(f, (4, 3), 69)),
         {}, (0,)),
        ("npx.logistic_regression_output", (v(f, (4, 3), 68),
                                            v(f, (4, 3), 69)), {}, (0,)),
        ("npx.ctc_loss", (v(f, (8, 3, 5), 42),
                          np.array([[1, 2, 2, 0], [3, 1, 0, 0],
                                    [4, 4, 2, 1]], "i4")), {}, (0,)),
    ]
    for mode, bi, proj in (("lstm", True, 3), ("gru", True, None),
                           ("rnn_tanh", False, None),
                           ("rnn_relu", False, None)):
        d = 2 if bi else 1
        size = tnn.rnn_param_size(mode, 4, 5, 2, bi, proj)
        args = [v(f, (5, 3, 4), 70), v(f, (size,), 71, -0.4, 0.4),
                v(f, (2 * d, 3, proj or 5), 72)]
        if mode == "lstm":
            args.append(v(f, (2 * d, 3, 5), 73))
        kw = dict(mode=mode, state_size=5, num_layers=2, bidirectional=bi,
                  projection_size=proj, use_sequence_length=True)
        if mode == "lstm":
            kw.update(lstm_state_clip_min=-0.6, lstm_state_clip_max=0.6)
        cases.append(("npx.rnn", tuple(args) + (np.array([4, 2, 5], "i4"),),
                      kw, tuple(range(len(args)))))
    return cases


def _npx_grads(mx, path, args, kw, wrt, ctx):
    """The first output of ``path`` and the gradients of the arguments
    at ``wrt`` of its weighted sum, under ``record()`` on ``ctx`` (None:
    the card)."""
    def run():
        xs = [mx.np.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
              else a for a in args]
        for i in wrt:
            xs[i].attach_grad()
        with mx.autograd.record():
            y = _np_call(mx, path, xs, kw)
            y = y[0] if isinstance(y, (list, tuple)) else y
            w = mx.np.array(_np_values("float32", y.shape, 99))
            s = (y * w).sum()
        s.backward()
        return [y] + [xs[i].grad for i in wrt]
    if ctx is None:
        return run()
    with ctx:
        return run()


def _boxes(n, seed, lead=()):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 0.7, lead + (n, 2))
    wh = rs.uniform(0.05, 0.4, lead + (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype("f4")


def _nms_rows(seed, n=12):
    """(2, n, 6) rows [class, score, box] of overlapping boxes, three
    classes and scores with exact ties (the tests' box_nms input)."""
    rs = np.random.RandomState(seed)
    cls = rs.randint(0, 3, (2, n, 1)).astype("f4")
    score = rs.choice([0.9, 0.7, 0.5, 0.3, 0.05], (2, n, 1)).astype("f4")
    b = _boxes(n, seed + 1, (2,))
    b[:, 1::3] = b[:, ::3][:, :b[:, 1::3].shape[1]] + 0.01
    return np.concatenate([cls, score, b], -1)


def _rois(seed, n=5, hi=8.0):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, hi, (n, 2))
    wh = rs.uniform(1, hi + 1, (n, 2))
    return np.concatenate([rs.randint(0, 2, (n, 1)), xy, xy + wh],
                          1).astype("f4")


def _npx_contrib_cases():
    """(path, args, kwargs, tolerance, crossed) of the contrib operators
    (numpy_extension/contrib_ops.py), the CPU tests' cases: the
    elementwise, move, product and window ones crossed over NP_DTYPES
    (``crossed``: a dtype both sides refuse counts as agreement), the
    detection, ROI, warping and deformable ones in float32, with exact
    ties in box_nms, bipartite_matching and proposal."""
    v = _np_values
    f, R = "float32", NP_RED
    cases = []
    for dt in NP_DTYPES:
        qkv = v(dt, (4, 2, 18), 1)
        x = v(dt, (2, 8, 3, 4), 8)
        xs = v(dt, (2, 6, 5, 7), 15)
        q, k = v(dt, (2, 7, 3, 4), 19), v(dt, (2, 7, 3, 4), 20)
        dil = np.array([1, 2, 1], "i4")
        kw2 = dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1))
        cases += [(p, a, k_, R, True) for p, a, k_ in [
            ("npx.interleaved_matmul_selfatt_qk", (qkv,), {"heads": 2}),
            ("npx.interleaved_matmul_selfatt_valatt",
             (qkv, v(dt, (4, 4, 4), 2)), {"heads": 2}),
            ("npx.interleaved_matmul_encdec_qk",
             (v(dt, (3, 2, 6), 3), v(dt, (4, 2, 12), 4)), {"heads": 2}),
            ("npx.interleaved_matmul_encdec_valatt",
             (v(dt, (4, 2, 12), 4), v(dt, (4, 3, 4), 5)), {"heads": 2}),
            ("npx.div_sqrt_dim", (x,), {}),
            ("npx.quadratic", (x,), {"a": 0.5, "b": -1.5, "c": 2.0}),
            ("npx.stop_gradient", (x,), {}),
            ("npx.depth_to_space", (x, 2), {}),
            ("npx.space_to_depth", (v(dt, (2, 2, 4, 6), 9), 2), {}),
            ("npx.moments", (x,), {"axes": (0, 2)}),
            ("npx.moments", (x,), {"axes": (1,), "keepdims": True}),
            ("npx.khatri_rao", (v(dt, (2, 3), 10), v(dt, (4, 3), 11),
                                v(dt, (2, 3), 12)), {}),
            ("npx.index_copy", (v(dt, (5, 3), 13), np.array([3, 0], "i4"),
                                v(dt, (2, 3), 14)), {}),
            ("npx.lrn", (xs,), {"nsize": 3}),
            ("npx.adaptive_avg_pool2d", (xs,), {"output_size": (2, 3)}),
            ("npx.bilinear_resize2d", (xs,), {"height": 9, "width": 4}),
            ("npx.bilinear_resize2d", (xs,), {"scale_height": 0.6,
                                             "scale_width": 2.0}),
            ("npx.im2col", (xs,), kw2),
            ("npx.col2im", (v(dt, (2, 36, 21), 16), (5, 7)), kw2),
            ("npx.sldwin_atten_score", (q, k, dil), {"w": 2}),
            ("npx.sldwin_atten_mask_like", (v(f, (2, 7, 3, 5), 21), dil,
                                            np.array([5, 7], "i4")),
             {"w": 2}),
            ("npx.sldwin_atten_context", (v(dt, (2, 7, 3, 2), 21), k, dil),
             {"w": 1, "symmetric": False})]]
    rs = np.random.RandomState(9)
    anchors = _boxes(10, 10)[None]
    label = np.full((2, 3, 5), -1.0, "f4")
    label[0, :2, 0] = [0, 2]
    label[0, :2, 1:] = anchors[0, [1, 6]] + 0.02
    label[1, :3, 0] = [1, 1, 0]
    label[1, :3, 1:] = _boxes(3, 11)
    p = rs.uniform(0, 1, (2, 4, 10)).astype("f4")
    p[:, :, 3] = p[:, :, 5]
    A = 12
    cls = rs.uniform(0, 1, (2, 2 * A, 3, 4)).astype("f4")
    cls[:, A:] = np.round(cls[:, A:] * 4) / 4
    prop = (cls, v(f, (2, 4 * A, 3, 4), 18, -0.2, 0.2),
            np.array([[60, 70, 1.0], [50, 64, 0.5]], "f4"))
    pkw = dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12, threshold=0.5,
               rpn_min_size=4)
    data = v(f, (2, 8, 9, 10), 14)
    rr = np.concatenate([rs.randint(0, 2, (4, 1)), rs.uniform(2, 8, (4, 2)),
                         rs.uniform(1, 6, (4, 2)),
                         rs.uniform(-90, 90, (4, 1))], 1).astype("f4")
    theta = np.tile(np.array([1, 0, 0, 0, 1, 0], "f4"), (2, 1)) \
        + v(f, (2, 6), 7, -0.3, 0.3)
    hk = (v(f, (3, 2), 25, 0.5, 1.5), v(f, (2,), 26, 0.1, 0.5),
          v(f, (2,), 27, 0.5, 2.0), v(f, (3, 2), 28, 0.0, 1.0),
          v(f, (3, 6), 29, 0.1, 1.0), rs.randint(0, 2, (3, 6)).astype("i4"),
          np.array([6, 3, 0], "f4"), np.array([4.0, 3.5, 3.0], "f4"))
    dx = v(f, (2, 4, 6, 5), 11)
    doff = v(f, (2, 18, 6, 5), 12, -1.5, 1.5)
    dw, db = v(f, (3, 4, 3, 3), 13), v(f, (3,), 14)
    dm = v(f, (2, 9, 6, 5), 15, 0.0, 1.0)
    cases += [(p_, a, k_, R, False) for p_, a, k_ in [
        ("npx.box_iou", (_boxes(5, 1, (2,)), _boxes(4, 2, (2,))), {}),
        ("npx.box_iou", (_boxes(5, 1, (2,)), _boxes(4, 2, (2,))),
         {"format": "center"}),
        ("npx.box_nms", (_nms_rows(3),), {}),
        ("npx.box_nms", (_nms_rows(3),), {"id_index": 0, "topk": 5}),
        ("npx.box_nms", (_nms_rows(3),), {"id_index": 0,
                                          "force_suppress": True,
                                          "valid_thresh": 0.1}),
        ("npx.box_nms", (_nms_rows(3),), {"id_index": 0,
                                          "background_id": 1,
                                          "overlap_thresh": 0.3}),
        ("npx.box_encode", (rs.choice([-1.0, 0.0, 1.0], (2, 6)).astype("f4"),
                            rs.randint(0, 4, (2, 6)).astype("f4"),
                            _boxes(6, 6, (2,)), _boxes(4, 7, (2,))), {}),
        ("npx.box_decode", (v(f, (2, 6, 4), 8, -0.5, 0.5),
                            _boxes(6, 6, (1,))), {"clip": 0.8}),
        ("npx.bipartite_matching",
         (rs.choice([0.2, 0.5, 0.8], (2, 5, 4)).astype("f4"),),
         {"threshold": 0.3}),
        ("npx.bipartite_matching",
         (rs.choice([0.2, 0.5, 0.8], (2, 5, 4)).astype("f4"),),
         {"threshold": 0.4, "is_ascend": True}),
        ("npx.multibox_target", (anchors, label,
                                 rs.uniform(0, 1, (2, 4, 10)).astype("f4")),
         {"negative_mining_ratio": 2.0, "minimum_negative_samples": 1}),
        ("npx.multibox_detection", (p / p.sum(1, keepdims=True),
                                    v(f, (2, 40), 13, -0.3, 0.3), anchors),
         {"nms_topk": 6}),
        ("npx.roi_align", (data, _rois(15)), {"pooled_size": (2, 3),
                                             "spatial_scale": 0.5,
                                             "sample_ratio": 2}),
        ("npx.roi_align", (data, _rois(15)), {"pooled_size": 2}),
        ("npx.roi_align", (data, _rois(15)), {"pooled_size": (2, 2),
                                             "position_sensitive": True,
                                             "aligned": True}),
        ("npx.rroi_align", (v(f, (2, 3, 9, 10), 16), rr),
         {"pooled_size": (2, 2)}),
        ("npx.proposal", prop, pkw),
        ("npx.multi_proposal", prop, pkw),
        ("npx.deformable_psroi_pooling",
         (v(f, (2, 18, 8, 9), 20), _rois(21), v(f, (5, 4, 2, 2), 22)),
         dict(spatial_scale=0.5, output_dim=2, group_size=3, pooled_size=3,
              trans_std=0.1, sample_per_part=2, part_size=2)),
        ("npx.grid_generator", (theta,), {"target_shape": (5, 7)}),
        ("npx.grid_generator", (v(f, (2, 2, 5, 7), 2),),
         {"transform_type": "warp"}),
        ("npx.bilinear_sampler", (v(f, (2, 3, 5, 6), 3),
                                  v(f, (2, 2, 4, 5), 4, -1.3, 1.3)), {}),
        ("npx.spatial_transformer", (v(f, (2, 3, 6, 5), 6), theta),
         {"target_shape": (4, 5)}),
        ("npx.correlation", (v(f, (2, 3, 7, 6), 8), v(f, (2, 3, 7, 6), 9)),
         dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
              pad_size=2)),
        ("npx.count_sketch", (v(f, (3, 8), 10),
                              np.array([0, 2, 2, 4, 1, 0, 3, 2], "f4"),
                              np.array([1, -1, 1, 1, -1, 1, -1, 1], "f4"),
                              5), {}),
        ("npx.deformable_convolution", (dx, doff, dw, db),
         {"kernel": (3, 3)}),
        ("npx.modulated_deformable_convolution", (dx, doff, dm, dw),
         {"kernel": (3, 3), "bias": db}),
        ("npx.hawkesll", hk, {}),
        ("npx.identity_attach_kl_sparse_reg",
         (v(f, (4, 3, 2), 26, 0.1, 0.9),), {}),
        ("npx.constraint_check", (np.array([True, True]),), {})]]
    return cases


def _npx_contrib_grad_cases():
    """The gradients of the contrib operators with a backward of their
    own making (four-tap sampling, loops, a custom Function), against
    the CPU port's: (path, args, kwargs, indices of the differentiated
    arguments)."""
    return [
        ("npx.roi_align", (_np_values("float32", (2, 8, 9, 10), 14),
                           _rois(15)),
         {"pooled_size": (2, 3), "spatial_scale": 0.5, "sample_ratio": 2},
         (0,)),
        ("npx.bilinear_sampler", (_np_values("float32", (2, 3, 5, 6), 3),
                                  _np_values("float32", (2, 2, 4, 5), 4,
                                             -1.3, 1.3)), {}, (0, 1)),
        ("npx.spatial_transformer", (
            _np_values("float32", (2, 3, 6, 5), 6),
            np.tile(np.array([1, 0, 0, 0, 1, 0], "f4"), (2, 1))
            + _np_values("float32", (2, 6), 7, -0.3, 0.3)),
         {"target_shape": (4, 5)}, (0, 1)),
        ("npx.deformable_convolution", (
            _np_values("float32", (2, 4, 6, 5), 11),
            _np_values("float32", (2, 18, 6, 5), 12, -1.5, 1.5),
            _np_values("float32", (3, 4, 3, 3), 13),
            _np_values("float32", (3,), 14)), {"kernel": (3, 3)},
         (0, 1, 2, 3)),
        ("npx.modulated_deformable_convolution", (
            _np_values("float32", (2, 4, 6, 5), 11),
            _np_values("float32", (2, 18, 6, 5), 12, -1.5, 1.5),
            _np_values("float32", (2, 9, 6, 5), 15, 0.0, 1.0),
            _np_values("float32", (3, 4, 3, 3), 13)), {"kernel": (3, 3)},
         (0, 1, 2, 3)),
        ("npx.hawkesll", (
            _np_values("float32", (3, 2), 25, 0.5, 1.5),
            _np_values("float32", (2,), 26, 0.1, 0.5),
            _np_values("float32", (2,), 27, 0.5, 2.0),
            _np_values("float32", (3, 2), 28, 0.0, 1.0),
            _np_values("float32", (3, 6), 29, 0.1, 1.0),
            np.random.RandomState(9).randint(0, 2, (3, 6)).astype("i4"),
            np.array([6, 3, 0], "f4"), np.array([4.0, 3.5, 3.0], "f4")),
         {}, (0, 1, 2, 3)),
        ("npx.identity_attach_kl_sparse_reg",
         (_np_values("float32", (4, 3, 2), 26, 0.1, 0.9),),
         {"moving_avg": _np_values("float32", (6,), 27, 0.2, 0.8),
          "penalty": 0.01}, (0,))]


#: SSD300's anchors (Liu et al., 2016; GluonCV's ssd_300_vgg16): six
#: feature maps (size, boxes a pixel), sizes s_k / 300 and ratios, 8732
#: anchors in all
SSD300_MAPS = ((38, 4), (19, 6), (10, 6), (5, 6), (3, 4), (1, 4))
SSD300_SIZES = (30, 60, 111, 162, 213, 264, 315)


def _ssd300_anchors(mx):
    out = []
    for i, (hw, nb) in enumerate(SSD300_MAPS):
        s, s1 = SSD300_SIZES[i] / 300, SSD300_SIZES[i + 1] / 300
        ratios = (1.0, 2.0, 0.5) if nb == 4 else (1.0, 2.0, 0.5, 3.0, 1 / 3)
        out.append(mx.npx.multibox_prior(
            mx.np.zeros((1, 1, hw, hw)), sizes=(s, math.sqrt(s * s1)),
            ratios=ratios).asnumpy())
    return np.concatenate(out, 1)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype("f4")


def _full_width_cases(mx):
    """The contrib operators at the widths of the models they serve:
    (name, path, args, kwargs, source)."""
    rs = np.random.RandomState(90)
    B = 8
    anchors = _ssd300_anchors(mx)
    A = anchors.shape[1]
    ssd = (_softmax(rs.standard_normal((B, 21, A)).astype("f4") * 2, 1),
           (rs.standard_normal((B, A * 4)) * 0.1).astype("f4"), anchors)
    h, w, na = 38, 50, 9
    logits = rs.standard_normal((1, 2, na, h, w)).astype("f4")
    rpn = (_softmax(logits, 1).reshape(1, 2 * na, h, w),
           (rs.standard_normal((1, 4 * na, h, w)) * 0.1).astype("f4"),
           np.array([[600.0, 800.0, 1.0]], "f4"))
    rpn_kw = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                  threshold=0.7, rpn_min_size=16, scales=(8.0, 16.0, 32.0),
                  ratios=(0.5, 1.0, 2.0), feature_stride=16)
    with mx.cpu():
        rois = mx.npx.proposal(*[mx.np.array(a) for a in rpn],
                               **rpn_kw).asnumpy()
    feat = rs.standard_normal((1, 256, h, w)).astype("f4")
    dx = rs.standard_normal((2, 256, h, w)).astype("f4")
    return [
        ("ssd300_multibox_detection", "npx.multibox_detection", ssd,
         dict(threshold=0.01, nms_threshold=0.45, nms_topk=400),
         f"SSD300 (Liu et al., 2016): {A} anchors, 21 VOC classes, "
         f"batch {B}"),
        ("faster_rcnn_rpn_proposal", "npx.proposal", rpn, rpn_kw,
         "Faster R-CNN RPN (Ren et al., 2015): 9 anchors on a 38 x 50 "
         "map (stride 16, a 600 x 800 image), 6000 pre-NMS, 300 kept"),
        ("roi_align_300x7x7", "npx.roi_align", (feat, rois),
         dict(pooled_size=(7, 7), spatial_scale=1 / 16, sample_ratio=2),
         "the RPN's 300 rois to 7 x 7 over (1, 256, 38, 50)"),
        ("deformable_convolution_256", "npx.deformable_convolution",
         (dx, (rs.standard_normal((2, 18, h, w)) * 0.5).astype("f4"),
          (rs.standard_normal((256, 256, 3, 3)) * 0.02).astype("f4"),
          (rs.standard_normal(256) * 0.1).astype("f4")),
         dict(kernel=(3, 3), pad=(1, 1)),
         "a 3 x 3 deformable convolution, 256 -> 256, on (2, 256, 38, 50)")]


#: the full-width cases' card results against the CPU port's, relative
#: and absolute: their sample coordinates reach 50 pixels (800 in
#: proposal's image), where one fp32 step is 3.8e-6 (6.1e-5), and a
#: sample moves by that step times the feature map's slope (a few units
#: a pixel in the random maps); the card's division by a scalar is a
#: product with its reciprocal, a step off the CPU's; and the
#: deformable convolution sums 2304 fp32 products in another order
FULL_TOL = 1e-4


def _full_width(torch, mx, called, failures):
    """Each full-width case on the card (median of 3 timed calls after
    one, CUDA events) and on the CPU port (one call, wall clock), the
    two results compared within FULL_TOL (a class id, a batch index or
    a kept row against a suppressed one differs by far more)."""
    out = {}
    for name, path, args, kw, src in _full_width_cases(mx):
        try:
            card = _np_call(mx, path, args, kw)
            times = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                _np_call(mx, path, args, kw)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            t0 = time.perf_counter()
            with mx.cpu():
                host = _np_call(mx, path, args, kw)
            cpu_s = time.perf_counter() - t0
            c, h = card.asnumpy(), host.asnumpy()
            res = {"source": src, "shape": list(card.shape),
                   "card_ms": float(np.median(times)), "card_ms_runs": times,
                   "cpu_port_s": cpu_s,
                   "max_abs_diff": float(np.abs(c - h).max()),
                   "rows_equal": float(np.mean(np.all(
                       np.isclose(c, h, rtol=FULL_TOL, atol=FULL_TOL),
                       axis=-1))) if c.ndim > 1 else None}
            if path in ("npx.multibox_detection", "npx.proposal"):
                kept = c[..., 0] >= 0 if path.endswith("detection") \
                    else np.ones(c.shape[:-1], bool)
                res["kept_rows"] = int(kept.sum())
            out[name] = res
            _np_same(mx, card, host, FULL_TOL, f"{name} card vs CPU")
            called.add(path)
        except Exception as e:          # noqa: BLE001 (reported)
            failures.append(f"full width {name}: {type(e).__name__}: "
                            f"{str(e)[:300]}")
    print("npx full width:", json.dumps(out), flush=True)
    return out


def _sparse_step(torch, mx, failures):
    """``nd.sparse`` on the card against the CPU port, in float32 and
    the integer dtypes the reference accepts: CSR and row_sparse
    creation (from dense arrays and from their parts), the storage
    casts both ways, dot (csr x dense, csr^T x dense, row_sparse x
    dense), add, retain and norm."""
    sp_dtypes = ("float32", "int32", "int8", "uint8", "uint16")
    ok, done = 0, []
    for dt in sp_dtypes:
        rs = np.random.RandomState(40)
        if dt == "float32":
            d = rs.uniform(-3, 3, (64, 48)).astype(dt)
        else:
            d = rs.randint(0 if dt.startswith("u") else -4, 5,
                           (64, 48)).astype(dt)
        d[rs.uniform(size=d.shape) > 0.2] = 0
        r = d.copy()
        r[rs.uniform(size=64) > 0.4] = 0
        rhs = rs.randint(0, 4, (48, 16)).astype(dt)
        rhs_t = rs.randint(0, 4, (64, 16)).astype(dt)

        def steps(ctx):
            with ctx:
                sp = mx.nd.sparse
                csr = mx.np.array(d).tostype("csr")
                rsp = mx.np.array(r).tostype("row_sparse")
                csr2 = sp.csr_matrix((csr.data.asnumpy(),
                                      csr.indices.asnumpy(),
                                      csr.indptr.asnumpy()), shape=d.shape)
                rsp2 = sp.row_sparse_array((rsp.data.asnumpy(),
                                            rsp.indices.asnumpy()),
                                           shape=r.shape)
                res = [csr.data, csr.indices, csr.indptr, rsp.data,
                       rsp.indices, csr2.todense(), rsp2.todense(),
                       csr.tostype("default"), rsp.tostype("csr").todense(),
                       sp.dot(csr, mx.np.array(rhs)),
                       sp.dot(csr, mx.np.array(rhs_t), transpose_a=True),
                       sp.dot(rsp, mx.np.array(rhs)),
                       (rsp + rsp2).todense(),
                       sp.retain(rsp, mx.np.array(
                           np.array([1, 5, 9, 40], "i4"))).todense()]
                if dt == "float32":
                    res.append(sp.norm(csr))
                return res
        try:
            card = steps(mx.gpu(0))
            host = steps(mx.cpu())
            _np_same(mx, card, host, NP_RED, f"sparse {dt}")
            ok += 1
            done.append(dt)
        except Exception as e:          # noqa: BLE001 (reported)
            failures.append(f"sparse {dt}: {type(e).__name__}: "
                            f"{str(e)[:300]}")
    print(f"npx sparse: {ok} of {len(sp_dtypes)} dtypes agree on the card "
          f"({done})", flush=True)
    return {"dtypes": done, "agree": ok, "of": len(sp_dtypes)}


def phase_npx(torch, smi):
    """``mx.npx`` on the card (the port of the JAX package's
    numpy_extension, its control flow and random): the activation
    table and the special functions crossed over NP_DTYPES, every layer,
    indexing op and legacy head at least once (pooling, the indexing
    ops, ``batch_dot`` and ``sequence_mask`` over NP_DTYPES), each
    against the same call on the CPU port; the gradients of the
    convolutions, pooling, the norms, ``rnn`` (lstm with its projection
    and clipping, gru, rnn_tanh, rnn_relu; two layers, bidirectional,
    masked), ``ctc_loss``, the legacy heads and ``foreach`` against the
    CPU port's; the convolutions with the process's cuDNN TF32 switch on
    (the port's run without TF32 whatever it says); which of torch's
    card kernels refuse a dtype and the port's route; and
    ``npx.flash_attention`` under ``record()`` at (2, 12, 512, 64)
    causal: one K1 launch forward and one of each K1-bwd launch backward,
    held against their plain versions (OUT_TOL, BWD_TOL). A case that
    raises on both the card and the CPU is agreement only in the dtype
    crosses (their count is printed); elsewhere it is a failure."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import ops, random_state
    from mxnet_tpu_torch.ops import attention as at
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rng_state = random_state.get_state()
    failures, called, refused_both = [], set(), []
    for path, kw in NPX_UNARY:
        for dt in NP_DTYPES:
            lo, hi = (0.2, 0.9) if "erfinv" in path else (0.2, 2.0)
            _np_both(mx, path, (_np_values(dt, lo=lo, hi=hi, seed=1),), kw,
                     NP_TR, failures, called, refused_both)
    # the convolutions with the process's TF32 switch at torch's default
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for path, args, kw, tol in _npx_cases():
            _np_both(mx, path, args, kw, tol, failures, called)
        for path, args, kw, tol, crossed in _npx_contrib_cases():
            _np_both(mx, path, args, kw, tol, failures, called,
                     refused_both if crossed else None)
        grad_err = {}
        for path, args, kw, wrt in (_npx_grad_cases()
                                    + _npx_contrib_grad_cases()):
            try:
                card = _npx_grads(mx, path, args, kw, wrt, None)
                host = _npx_grads(mx, path, args, kw, wrt, mx.cpu())
                _np_same(mx, card, host, NP_RED, f"{path} gradients")
                grad_err[path] = max(
                    float(np.abs(c.asnumpy() - h.asnumpy()).max())
                    for c, h in zip(card, host))
                called.add(path)
            except Exception as e:      # noqa: BLE001 (reported)
                failures.append(f"{path} gradients: {type(e).__name__}: "
                                f"{str(e)[:200]}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    # control flow: foreach with its gradient, while_loop, cond
    def loop(ctx):
        def body(xt, st):
            h = mx.np.tanh(mx.np.dot(xt, w) + st[0])
            return h * 2.0, [h]
        with ctx if ctx is not None else contextlib.nullcontext():
            xs = mx.np.array(_np_values("float32", (4, 2, 3), 80))
            w = mx.np.array(_np_values("float32", (3, 3), 81))
            h0 = mx.np.array(_np_values("float32", (2, 3), 82))
            for a in (xs, w, h0):
                a.attach_grad()
            with mx.autograd.record():
                outs, fin = mx.npx.foreach(body, xs, [h0])
                _, (i, acc) = mx.npx.while_loop(
                    lambda vs: vs[0] < 3,
                    lambda vs: ([], [vs[0] + 1, vs[1] * 1.5]),
                    [mx.np.array(np.array(0, "i4")), fin[0]])
                c = mx.npx.cond(acc.sum() > -1e9, lambda a: a * 2.0,
                                lambda a: a, [acc])
                s = outs.sum() + c.sum()
            s.backward()
            return [outs, fin[0], i, acc, c, xs.grad, w.grad, h0.grad]
    called.update({"npx.foreach", "npx.while_loop", "npx.cond"})
    try:
        _np_same(mx, loop(None), loop(mx.cpu()), NP_RED, "control flow")
    except Exception as e:              # noqa: BLE001 (reported)
        failures.append(f"control flow: {type(e).__name__}: {e}")

    # dropout, npx.random, the np-mode switches and the helpers
    x = mx.np.array(np.ones((64, 64), "f4"))
    with mx.autograd.train_mode():
        dr = mx.npx.dropout(x, p=0.5).asnumpy()
    check(set(np.unique(dr).tolist()) <= {0.0, 2.0}
          and 0.3 < (dr == 0).mean() < 0.7, "npx.dropout on the card")
    for name, args in (("uniform", (0.0, 1.0)), ("normal", (0.0, 1.0)),
                       ("randint", (0, 5)), ("gamma", (2.0,)),
                       ("exponential", (1.0,)), ("bernoulli", (0.3,))):
        r = getattr(mx.npx.random, name)(*args, size=(3, 4))
        check(r._data.is_cuda and r.shape == (3, 4),
              f"npx.random.{name} on the card")
    check(mx.npx.random.multinomial(10, [0.2, 0.8])._data.is_cuda,
          "npx.random.multinomial on the card")
    mx.npx.random.seed(3)
    try:
        mx.npx.set_np(dtype=True)
        d64 = mx.np.ones((2,)) * 2.0
        check(d64._data.is_cuda and d64.dtype == np.float64,
              "set_np(dtype=True) on the card")
    finally:
        mx.npx.reset_np()
    check(mx.np.ones((2,)).dtype == np.float32 and mx.npx.is_np_array()
          and mx.npx.is_np_shape() and mx.npx.num_gpus() >= 1
          and mx.npx.current_device().device_type == "gpu",
          "the np-mode switches and helpers")
    mx.npx.waitall()
    called.update(NPX_BY_HAND)

    # npx.flash_attention under record(): K1 forward, K1-bwd backward
    rng = np.random.RandomState(83)
    b, h, s_, d = 2, 12, 512, 64
    q, k, v = (_split_view(torch, rng, b, s_, h, d) for _ in range(3))
    do = _rand(torch, rng, b, h, s_, d)
    n0 = dict(ops.launch_counts())
    qa, ka, va = (mx.nd.NDArray(t.clone()) for t in (q, k, v))
    for a in (qa, ka, va):
        a.attach_grad()
    with mx.autograd.record():
        out = mx.npx.flash_attention(qa, ka, va, causal=True)
    out.backward(mx.nd.NDArray(do))
    torch.cuda.synchronize()
    launched = {n: ops.launch_counts().get(n, 0) - n0.get(n, 0)
                for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv")}
    scale = 1.0 / math.sqrt(d)
    p_out, p_lse = at._blockwise_fwd(q, k, v, True, scale)
    p_dq, p_dk, p_dv = at._flash_bwd(q, k, v, p_out, p_lse, do, True, scale)
    torch.cuda.synchronize()
    fa = {"launches": launched,
          "out_err": float((out._data.detach() - p_out).abs().max()),
          "dq_err": float((qa.grad._data - p_dq).abs().max()),
          "dk_err": float((ka.grad._data - p_dk).abs().max()),
          "dv_err": float((va.grad._data - p_dv).abs().max()),
          "out_tol": OUT_TOL, "grad_tol": BWD_TOL[""]}
    check(all(n == 1 for n in launched.values()),
          f"npx.flash_attention under record(): launches {launched}")
    check(fa["out_err"] <= OUT_TOL and max(fa["dq_err"], fa["dk_err"],
                                           fa["dv_err"]) <= BWD_TOL[""],
          f"npx.flash_attention against its plain versions: {fa}")
    called.add("npx.flash_attention")

    t1 = time.perf_counter()
    full = _full_width(torch, mx, called, failures)
    sparse = _sparse_step(torch, mx, failures)
    full_s = time.perf_counter() - t1

    public = {f"npx.{n}" for n in mx.npx.__all__}
    uncalled = sorted(public - called)

    refused = {}
    for what, (raw, route) in NPX_ROUTES.items():
        bad = []
        for dt in NP_DTYPES:
            t = torch.from_numpy(_np_values(dt, (4, 4), 14)).cuda()
            try:
                raw(torch, t)
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError):
                bad.append(dt)
        if bad:
            refused[what] = {"refused_on_card": bad, "port_route": route}
    print("npx: torch kernels that refused a dtype on the card, and the "
          "port's route:", json.dumps(refused), flush=True)
    random_state.set_state(*rng_state)
    print(f"npx: {len(refused_both)} dtype-cross cases raised on both the "
          f"card and the CPU: {refused_both}", flush=True)
    res = {"calls": len(called), "failures": failures,
           "both_raised": len(refused_both),
           "uncalled": uncalled, "refused_on_card": refused,
           "gradient_max_abs_err": grad_err, "flash_attention": fa,
           "full_width": full, "sparse": sparse,
           "full_width_and_sparse_s": full_s,
           "seconds": time.perf_counter() - t0, "nvidia_smi": smi,
           "launches": ops.launch_counts()}
    emit("npx", **res)
    check(not failures, f"{len(failures)} npx calls failed on the card: "
          f"{failures[:10]}")
    check(not uncalled, f"npx functions the phase never called: {uncalled}")
    return res


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
    tmod = mx.rtc.PallasModule(RTC_TRITON_SOURCE)
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
    t2 = tmod.get_kernel("scale2")(mx.np.array([1.0, 2.0, 3.0]))
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
                      ("scale2", s2), ("triton_scale2", t2),
                      ("d.grad", d.grad),
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
        "triton_scale2": float(np.abs(t2.asnumpy() - [2.0, 4.0, 6.0])
                               .max()),
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
    for key in ("softsign", "clip_forward", "scale2", "triton_scale2",
                "double.grad", "ident.grad"):
        check(errs[key] <= 1e-6, f"custom_op {key} off by {errs[key]}")
    for key in ("x.grad_rel", "sigmoid_x2_rel", "sigmoid_x2.grad_rel"):
        check(errs[key] <= 1e-5, f"custom_op {key} off by {errs[key]}")
    check(launches["rtc"] == 3, f"rtc launched {launches['rtc']} times "
          "in the custom_op flow (scale2, double, ident)")
    check(launches["rtc_triton"] == 1, f"the Triton route launched "
          f"{launches['rtc_triton']} times in the custom_op flow (scale2)")
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


#: the gluon phase's Transformer: GPT-2 small's block widths (Radford et
#: al., 2019), its depth cut from 12 to 2; fp32, batch 8 x 512 tokens
GLUON_TF = dict(units=768, heads=12, hidden=3072, layers=2, batch=8,
                seq=512, steps=3, lr=1e-4)
#: the gluon phase's conv net: ResNet-18's stem and first stage (He et
#: al., 2016) over a 1000-way head; fp32, batch 32 x 3 x 224 x 224
GLUON_CONV = dict(batch=32, classes=1000, steps=2, lr=0.1, momentum=0.9,
                  predict_batch=20, bucket=32)
GLUON_PROFILE_STEPS = 2
#: card vs CPU port (fp32, the same weights and data): losses within
#: 1e-4 relative (two devices' fp32 reduction orders over 768-3072-wide
#: products and 32 x 112 x 112 BatchNorm sums)
GLUON_LOSS_REL = 1e-4
#: Adam moves each weight by about lr a step whatever the gradient's
#: size, so a gradient that is noise (a k_proj bias's exact gradient is
#: 0) can take either sign on two devices: the Transformer's parameters
#: are held by their updates, each element's card and CPU updates within
#: 1 % of lr, and at most 1e-3 of the elements outside that
GLUON_TF_UPDATE_TOL = 1e-2
GLUON_TF_UPDATE_FRAC = 1e-3
#: SGD's update is lr x the gradient: the conv net's parameters and
#: running statistics, each tensor's distance from the CPU's within
#: 1e-2 of how far it moved (2-norms; the largest element's ratio is
#: reported). The stem's weight sets it: about 2e-3 (4.5e-3
#: elementwise) on NVIDIA H100 80GB HBM3, 700.00 W, the losses within
#: 1e-7. Its gradient sums 32 x 112 x 112 products that BatchNorm's
#: backward makes cancel, in two devices' orders, and the second step
#: builds on the first's
GLUON_CONV_REL = 1e-2
#: the bucketed predict forward against the unpadded rows: products of
#: one batch shape, the rows independent of each other
GLUON_BUCKET_TOL = 1e-6


def _gluon_transformer(mx, nn):
    net = nn.HybridSequential()
    for _ in range(GLUON_TF["layers"]):
        net.add(nn.TransformerEncoderCell(
            GLUON_TF["units"], GLUON_TF["heads"],
            hidden_dim=GLUON_TF["hidden"], causal=True, activation="gelu",
            pre_norm=True))
    return net


def _gluon_resnet(mx, nn):
    """ResNet-18's stem and first stage (two basic blocks of 64
    channels), global average pooling and a Dense head with deferred
    ``in_units``. The basic block is a user's block written over
    NDArrays."""
    class BasicBlock(mx.gluon.HybridBlock):
        def __init__(self, channels):
            super().__init__()
            self.body = nn.HybridSequential()
            self.body.add(
                nn.Conv2D(channels, 3, padding=1, use_bias=False),
                nn.BatchNorm(), nn.Activation("relu"),
                nn.Conv2D(channels, 3, padding=1, use_bias=False),
                nn.BatchNorm())

        def forward(self, x):
            return mx.npx.relu(self.body(x) + x)

    net = nn.HybridSequential()
    net.add(nn.Conv2D(64, 7, strides=2, padding=3, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"), nn.MaxPool2D(3, 2, 1),
            BasicBlock(64), BasicBlock(64), nn.GlobalAvgPool2D(),
            nn.Dense(GLUON_CONV["classes"]))
    return net


def _gluon_pair(torch, mx, build, x, init):
    """The net on the card (``initialize`` deferred, ``hybridize``, the
    shapes settled by ``infer_shape``) and its copy on the CPU port with
    the same weights (carried by name)."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.parameter import load_jax_params
    with mx.gpu(0):
        card = build(mx, nn)
        card.initialize(init)
        card.hybridize()
        card.infer_shape(mx.np.array(x[:1]))
    weights = {k: p.data().asnumpy()
               for k, p in card.collect_params().items()}
    with mx.cpu():
        host = build(mx, nn)
        host.initialize()
        host.hybridize()
        load_jax_params(host, weights)
    return card, host, weights


def _gluon_steps(torch, mx, net, ctx, x, y, loss_fn, trainer_args, steps,
                 batch):
    """``steps`` of record() -> loss -> backward() -> Trainer.step on
    ``ctx``: the mean losses and each step's wall ms (the loss read back
    ends it)."""
    with ctx:
        trainer = mx.gluon.Trainer(net.collect_params(), *trainer_args)
        xa, ya = mx.np.array(x), mx.np.array(y)
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            with mx.autograd.record():
                loss = loss_fn(net(xa), ya)
            loss.backward()
            trainer.step(batch)
            losses.append(float(loss.mean()))
            ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, trainer


def _gluon_profile(torch, mx, net, x, y, loss_fn, trainer, batch):
    """GLUON_PROFILE_STEPS more card steps under torch.profiler: wall ms
    a step and the card's busy ms (the union of its kernel intervals)
    and share."""
    from torch.profiler import ProfilerActivity, profile
    with mx.gpu(0):
        xa, ya = mx.np.array(x), mx.np.array(y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(GLUON_PROFILE_STEPS):
                with mx.autograd.record():
                    loss = loss_fn(net(xa), ya)
                loss.backward()
                trainer.step(batch)
                float(loss.mean())
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / GLUON_PROFILE_STEPS
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kern), "the profiler saw no kernel on the card")
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kern]) / GLUON_PROFILE_STEPS
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "kernels_per_step": len(kern) / GLUON_PROFILE_STEPS}


def _gluon_transformer_part(torch, mx, card_name):
    from mxnet_tpu_torch import ops
    rs = np.random.RandomState(31)
    b, s, u = GLUON_TF["batch"], GLUON_TF["seq"], GLUON_TF["units"]
    x = rs.standard_normal((b, s, u)).astype("f4")
    y = rs.standard_normal((b, s, u)).astype("f4")
    t0 = time.perf_counter()
    card, host, weights = _gluon_pair(torch, mx, _gluon_transformer, x,
                                      mx.init.Xavier())
    check(all(p.data().ctx == mx.gpu(0)
              for p in card.collect_params().values()),
          "gluon transformer: a parameter is off the card")
    args = ("adam", {"learning_rate": GLUON_TF["lr"]})
    loss_fn = mx.gluon.loss.L2Loss()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card_losses, ms, trainer = _gluon_steps(
        torch, mx, card, mx.gpu(0), x, y, loss_fn, args, GLUON_TF["steps"],
        b)
    torch.cuda.synchronize()
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    want = {k: GLUON_TF["layers"] * GLUON_TF["steps"] for k in TRAIN_ATTN}
    check(launches == want,
          f"gluon transformer: launches {launches}, want {want}")
    host_losses, _, _ = _gluon_steps(
        torch, mx, host, mx.cpu(), x, y, loss_fn, args, GLUON_TF["steps"],
        b)
    loss_err = max(abs(a - c) / abs(c)
                   for a, c in zip(card_losses, host_losses))
    worst, off, n = 0.0, 0, 0
    hp = host.collect_params()
    for name, p in card.collect_params().items():
        w0 = weights[name]
        du_card = p.data().asnumpy() - w0
        du_host = hp[name].data().asnumpy() - w0
        diff = np.abs(du_card - du_host) / GLUON_TF["lr"]
        worst = max(worst, float(diff.max()))
        off += int((diff > GLUON_TF_UPDATE_TOL).sum())
        n += diff.size
    prof = _gluon_profile(torch, mx, card, x, y, loss_fn, trainer, b)
    p50 = float(np.median(ms[1:]))  # the first step warms cuBLAS/cuDNN
    # the profiler's host work stretches the steps it traces
    prof["device_busy_share_of_p50"] = prof["device_busy_ms"] / p50
    out = {"card": card_name, "config": GLUON_TF,
           "card_losses": card_losses, "cpu_losses": host_losses,
           "max_loss_rel_err": loss_err,
           "max_update_err_in_lr": worst,
           "update_elements_outside_tol": off, "elements": n,
           "step_ms": ms, "step_ms_p50": p50,
           "tokens_per_s": b * s / p50 * 1e3, "launches": launches,
           "profile": prof,
           "seconds": time.perf_counter() - t0}
    emit("gluon_transformer", **out)
    check(all(math.isfinite(v) for v in card_losses),
          f"gluon transformer: non-finite loss {card_losses}")
    check(card_losses[-1] < card_losses[0],
          f"gluon transformer: losses not falling {card_losses}")
    check(loss_err <= GLUON_LOSS_REL,
          f"gluon transformer: card vs CPU losses {loss_err}")
    check(off <= GLUON_TF_UPDATE_FRAC * n,
          f"gluon transformer: {off} of {n} updates beyond "
          f"{GLUON_TF_UPDATE_TOL} x lr of the CPU's")
    return out


def _gluon_resnet_part(torch, mx, card_name):
    from mxnet_tpu_torch import bucketing, telemetry
    rs = np.random.RandomState(32)
    nb = GLUON_CONV["batch"]
    x = rs.standard_normal((nb, 3, 224, 224)).astype("f4")
    y = rs.randint(0, GLUON_CONV["classes"], (nb,)).astype("i4")
    t0 = time.perf_counter()
    card, host, weights = _gluon_pair(torch, mx, _gluon_resnet, x,
                                      mx.init.Xavier())
    args = ("sgd", {"learning_rate": GLUON_CONV["lr"],
                    "momentum": GLUON_CONV["momentum"]})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    card_losses, ms, _ = _gluon_steps(
        torch, mx, card, mx.gpu(0), x, y, loss_fn, args,
        GLUON_CONV["steps"], nb)
    host_losses, _, _ = _gluon_steps(
        torch, mx, host, mx.cpu(), x, y, loss_fn, args,
        GLUON_CONV["steps"], nb)
    loss_err = max(abs(a - c) / abs(c)
                   for a, c in zip(card_losses, host_losses))
    worst, worst_name, worst_elem = 0.0, None, 0.0
    hp = host.collect_params()
    for name, p in card.collect_params().items():
        got = p.data().asnumpy()
        moved = got - weights[name]
        err = got - hp[name].data().asnumpy()
        rel = float(np.linalg.norm(err)) / max(
            float(np.linalg.norm(moved)), 1e-30)
        worst_elem = max(worst_elem, float(np.abs(err).max()) / max(
            float(np.abs(moved).max()), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    # one predict-mode forward of a batch of 20, bucketed up to the 32
    # of an entry made first: the outputs come back sliced, no entry
    # is added, and the rows equal the unpadded batch's
    xp = x[:GLUON_CONV["predict_batch"]]
    with mx.gpu(0), mx.autograd.predict_mode():
        full = card(mx.np.array(x)).asnumpy()
        n_entries = len(card._cached_op._entries)
        prev = telemetry.set_enabled(True)
        pads = telemetry.counter_value("gluon.cachedop.bucket_pad")
        try:
            with bucketing.policy_scope(bucketing.BucketingPolicy(
                    buckets=[GLUON_CONV["bucket"]])):
                part = card(mx.np.array(xp))
            pads = telemetry.counter_value("gluon.cachedop.bucket_pad") \
                - pads
        finally:
            telemetry.set_enabled(prev)
        grown = len(card._cached_op._entries) - n_entries
    bucket_err = float(np.abs(part.asnumpy() - full[:len(xp)]).max())
    p50 = float(np.median(ms[1:]))  # the first step warms cuBLAS/cuDNN
    out = {"card": card_name, "config": GLUON_CONV,
           "card_losses": card_losses, "cpu_losses": host_losses,
           "max_loss_rel_err": loss_err,
           "max_param_err_rel_to_change": worst,
           "worst_param": worst_name,
           "max_element_err_rel_to_change": worst_elem,
           "step_ms": ms, "step_ms_p50": p50,
           "images_per_s": nb / p50 * 1e3,
           "bucketed_shape": list(part.shape), "bucket_pads": pads,
           "entries_added": grown, "bucketed_max_abs_err": bucket_err,
           "seconds": time.perf_counter() - t0}
    emit("gluon_resnet", **out)
    check(all(math.isfinite(v) for v in card_losses),
          f"gluon resnet: non-finite loss {card_losses}")
    check(loss_err <= GLUON_LOSS_REL,
          f"gluon resnet: card vs CPU losses {loss_err}")
    check(worst <= GLUON_CONV_REL,
          f"gluon resnet: {worst_name} {worst} x its change (2-norm) from "
          f"the CPU's")
    check(tuple(part.shape) == (len(xp), GLUON_CONV["classes"])
          and pads == 1 and grown == 0,
          f"gluon resnet: bucketed predict {part.shape}, {pads} pads, "
          f"{grown} entries added")
    check(bucket_err <= GLUON_BUCKET_TOL * max(1.0, float(np.abs(
        full).max())), f"gluon resnet: bucketed rows differ {bucket_err}")
    return out


def _gluon_toplevel(torch, mx, card_name):
    """Item 29 on the card: DLPack without a copy, the runtime
    features, the memory queries, and ``mx.random.seed`` repeating a
    Dropout draw."""
    t0 = time.perf_counter()
    t = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4)
    a = mx.NDArray(t)
    back = mx.dlpack.from_dlpack(mx.dlpack.to_dlpack_for_read(a))
    wback = mx.dlpack.from_dlpack(mx.dlpack.to_dlpack_for_write(a))
    check(back._data.data_ptr() == t.data_ptr() == wback._data.data_ptr()
          and back.ctx == mx.gpu(0) and back._data.is_cuda,
          "dlpack: the round trip copied or left the card")
    feats = mx.runtime.Features()
    check(feats.is_enabled("CUDA") and feats.is_enabled("NVRTC"),
          f"runtime: CUDA/NVRTC not enabled: {feats}")
    free, total = torch.cuda.mem_get_info(0)
    mem = {"torch": [free, total], "util": list(mx.util.get_gpu_memory(0)),
           "context": list(mx.context.gpu_memory_info(0))}
    for key in ("util", "context"):
        check(mem[key][1] == total and abs(mem[key][0] - free) <= 256 << 20,
              f"{key} memory {mem[key]} vs torch {free, total}")
    x = np.ones((256, 256), "f4")
    drops = []
    with mx.gpu(0):
        layer = mx.gluon.nn.Dropout(0.5)
        for _ in range(2):
            mx.random.seed(7)
            with mx.autograd.train_mode():
                drops.append(layer(mx.np.array(x)).asnumpy())
    kept = float((drops[0] != 0).mean())
    check(np.array_equal(drops[0], drops[1]) and abs(kept - 0.5) < 0.02,
          f"random.seed did not repeat the card's Dropout ({kept} kept)")
    out = {"card": card_name, "dlpack_same_ptr": True,
           "features": {k: f.enabled for k, f in feats.items()},
           "compute_capability": mx.util.get_cuda_compute_capability(
               mx.gpu(0)),
           "memory": mem, "dropout_kept": kept,
           "seconds": time.perf_counter() - t0}
    emit("gluon_toplevel", **out)
    return out


def phase_gluon(torch, card_name):
    """The classic Gluon loop on the card (item 15a) and item 29's
    modules: (1) 2 ``TransformerEncoderCell``s at GPT-2 small's widths,
    fp32, batch 8 x 512: ``initialize(Xavier())`` deferred,
    ``hybridize``, 3 steps of ``record()`` -> ``L2Loss`` -> ``backward``
    -> ``Trainer("adam").step``, against the CPU port from the same
    weights and data, one K1 and one of each K1-bwd launch per cell per
    step, then a profile of 2 steps; (2) ResNet-18's stem and first
    stage, batch 32 x 3 x 224 x 224, 2 SGD steps with momentum in
    training mode against the CPU port (losses, parameters, BatchNorm's
    running statistics), then a bucketed predict-mode forward of 20;
    (3) DLPack, ``runtime``, the memory queries and ``mx.random.seed``
    on the card. The phase's launches are the Transformer steps'."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    tf = _gluon_transformer_part(torch, mx, card_name)
    conv = _gluon_resnet_part(torch, mx, card_name)
    top = _gluon_toplevel(torch, mx, card_name)
    gc.collect()
    torch.cuda.empty_cache()
    emit("gluon", card=card_name, seconds=time.perf_counter() - t0)
    return {"launches": tf["launches"], "transformer": tf,
            "resnet": conv, "toplevel": top}


#: the rnn phase's language model: the "medium" word-level LSTM LM of
#: Zaremba et al., 2014 (*Recurrent Neural Network Regularization*; the
#: reference's example/rnn/word_lm) in examples/lstm_lm.py's structure
#: (Embedding -> Dropout -> rnn.LSTM -> Dense) at
#: scripts/tpu_stage_lstm.py's configuration: vocab 10000, a 650-wide
#: embedding, 2 LSTM layers of 650, bptt 35, batch 64, layout NTC; SGD
#: at lr 1.0 with the global gradient norm clipped at 0.25 and
#: SoftmaxCrossEntropyLoss, the state carried and detached between steps
RNN_LM = dict(vocab=10000, embed=650, hidden=650, layers=2, bptt=35,
              batch=64, lr=1.0, clip=0.25, steps=3, dropout=0.5,
              profile_steps=2, library_steps=4)
#: card vs CPU port, the same weights and data (fp32): losses within
#: 1e-4 relative (two devices' reduction orders over 650-wide products,
#: a 10000-way softmax and 2240 tokens); each parameter's distance from
#: the CPU's within 1e-2 of how far it moved (2-norms, as the gluon
#: phase's conv gate); metric.Perplexity on the card's softmax equal to
#: exp of the mean loss within 1e-5 relative (the same log-probabilities,
#: one computed on the host from the card's probabilities)
RNN_LOSS_REL = 1e-4
RNN_PARAM_REL = 1e-2
RNN_PPL_REL = 1e-5
#: the other recurrent paths and the losses, card vs CPU port: within
#: 1e-4 x max(1, max|ref|) (fp32 sums of 650-1600-term products and 35
#: steps of recurrence, or 200 frames of CTC's log-sum-exp recursion, in
#: two devices' orders)
RNN_FWD_TOL = 1e-4
#: a bidirectional GRU with use_sequence_length at the LM's width
RNN_GRU = dict(hidden=650, input=650, bptt=35, batch=64)
#: Conv2DLSTMCell at the Moving-MNIST patch shape of Shi et al., 2015
#: (16 x 16 x 16 input, 64 hidden channels, 5 x 5 kernels), 10 steps
RNN_CONV = dict(batch=16, input=(16, 16, 16), hidden=64, kernel=5,
                steps=10)
#: CTCLoss at a character set's size: N 32, T 200, 29 classes, labels up
#: to 50
RNN_CTC = dict(n=32, t=200, classes=29, max_label=50)


def _lm_corpus(n_tokens, vocab, seed=0):
    """examples/lstm_lm.py's synthetic corpus: Zipf unigrams, and token
    t followed by (7 t + 3) % vocab 60 % of the time."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype="f8")
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    toks = np.empty(n_tokens, "i4")
    toks[0] = 0
    zipf = rng.choice(vocab, size=n_tokens, p=p)
    follow = rng.uniform(size=n_tokens) < 0.6
    for i in range(1, n_tokens):
        toks[i] = (toks[i - 1] * 7 + 3) % vocab if follow[i] else zipf[i]
    return toks


def _lm_batches(n):
    """``n`` (x, y) batches of (batch, bptt) tokens, y shifted by one."""
    b, t = RNN_LM["batch"], RNN_LM["bptt"]
    data = _lm_corpus(b * (n * t + 1), RNN_LM["vocab"]).reshape(b, -1)
    return [(data[:, s * t:(s + 1) * t],
             data[:, s * t + 1:(s + 1) * t + 1]) for s in range(n)]


def _lm_model(mx, dropout=0.0):
    """examples/lstm_lm.py's LSTMLanguageModel at RNN_LM's widths, a
    user's block over NDArrays."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class LSTMLanguageModel(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(RNN_LM["vocab"], RNN_LM["embed"])
            self.drop = nn.Dropout(dropout)
            self.lstm = rnn.LSTM(RNN_LM["hidden"],
                                 num_layers=RNN_LM["layers"],
                                 dropout=dropout, layout="NTC",
                                 input_size=RNN_LM["embed"])
            self.decoder = nn.Dense(RNN_LM["vocab"], flatten=False)

        def begin_state(self, batch_size, ctx=None):
            return self.lstm.begin_state(batch_size=batch_size, ctx=ctx)

        def forward(self, tokens, state):
            x = self.drop(self.embed(tokens))
            out, new_state = self.lstm(x, state)
            return self.decoder(self.drop(out)), new_state

    return LSTMLanguageModel()


def _lm_settled(mx, ctx, x, weights=None, dropout=0.0):
    """An LM on ``ctx``, its deferred shapes settled by one predict-mode
    forward, initialized by Xavier or given ``weights`` by name."""
    from mxnet_tpu_torch.gluon.parameter import load_jax_params
    with ctx:
        net = _lm_model(mx, dropout)
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(mx.np.array(x), net.begin_state(x.shape[0]))
        if weights is not None:
            load_jax_params(net, weights)
    return net


class _LMTrainer:
    """examples/lstm_lm.py's loop: record -> the mean per-sequence loss
    -> backward -> clip_global_norm -> Trainer("sgd").step(1), the
    state detached between steps."""

    def __init__(self, mx, net, ctx):
        self.mx, self.net, self.ctx = mx, net, ctx
        with ctx:
            self.trainer = mx.gluon.Trainer(
                net.collect_params(), "sgd",
                {"learning_rate": RNN_LM["lr"]})
            self.state = net.begin_state(RNN_LM["batch"])
        self.loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        self.logits = None

    def step(self, x, y):
        mx = self.mx
        with self.ctx:
            self.state = [s.detach() for s in self.state]
            with mx.autograd.record():
                logits, self.state = self.net(mx.np.array(x), self.state)
                loss = self.loss_fn(logits, mx.np.array(y)).mean()
            loss.backward()
            grads = [p.grad() for p in self.net.collect_params().values()
                     if p.grad_req != "null"]
            mx.gluon.utils.clip_global_norm(grads, RNN_LM["clip"])
            self.trainer.step(1)
        self.logits = logits
        return float(loss)


def _lm_steps(torch, trainer, batches):
    """Train on ``batches``: the losses and each step's wall ms (the
    loss read back ends it)."""
    losses, ms = [], []
    for x, y in batches:
        t0 = time.perf_counter()
        losses.append(trainer.step(x, y))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _params_np(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _library_lm_step(torch, weights, batches):
    """The same step in plain PyTorch with the recurrence through
    ``torch.nn.LSTM`` (cuDNN): wall ms a step (printed only, never on
    the port's path)."""
    f = torch.nn.functional
    dev = torch.device("cuda")

    def t(name):
        return torch.tensor(weights[name], device=dev, requires_grad=True)

    emb, dec_w, dec_b = t("embed.weight"), t("decoder.weight"), \
        t("decoder.bias")
    lstm = torch.nn.LSTM(RNN_LM["embed"], RNN_LM["hidden"],
                         RNN_LM["layers"], batch_first=True).to(dev)
    with torch.no_grad():
        for layer in range(RNN_LM["layers"]):
            for ours, theirs in (("i2h_weight", "weight_ih"),
                                 ("h2h_weight", "weight_hh"),
                                 ("i2h_bias", "bias_ih"),
                                 ("h2h_bias", "bias_hh")):
                getattr(lstm, f"{theirs}_l{layer}").copy_(torch.tensor(
                    weights[f"lstm.l{layer}_{ours}"]))
    params = [emb, dec_w, dec_b] + list(lstm.parameters())
    opt = torch.optim.SGD(params, lr=RNN_LM["lr"])
    shape = (RNN_LM["layers"], RNN_LM["batch"], RNN_LM["hidden"])
    state = (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
    ms = []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tuple(s.detach() for s in state)
        xt = torch.as_tensor(x, device=dev).long()
        yt = torch.as_tensor(y, device=dev).long()
        out, state = lstm(f.embedding(xt, emb), state)
        logits = f.linear(out, dec_w, dec_b)
        loss = f.cross_entropy(logits.reshape(-1, RNN_LM["vocab"]),
                               yt.reshape(-1))
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(params, RNN_LM["clip"])
        opt.step()
        float(loss.detach())
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _recurrence_ms(torch, weights):
    """The recurrence alone, forward and backward at the LM's shape:
    the port's ``ops.nn.rnn`` (per-timestep loop) and ``torch.nn.LSTM``
    (cuDNN), ms of each (the median of 3, after one warm-up)."""
    from mxnet_tpu_torch.ops import nn as ops_nn
    dev = torch.device("cuda")
    b, t, h = RNN_LM["batch"], RNN_LM["bptt"], RNN_LM["hidden"]
    names = [f"lstm.l{k}_{g}_weight" for k in range(RNN_LM["layers"])
             for g in ("i2h", "h2h")] + \
        [f"lstm.l{k}_{g}_bias" for k in range(RNN_LM["layers"])
         for g in ("i2h", "h2h")]
    flat = torch.cat([torch.tensor(weights[n]).reshape(-1)
                      for n in names]).to(dev).requires_grad_(True)
    x = torch.randn(t, b, h, device=dev, requires_grad=True)
    h0 = torch.zeros(RNN_LM["layers"], b, h, device=dev)
    lstm = torch.nn.LSTM(h, h, RNN_LM["layers"]).to(dev)

    def ours():
        out = ops_nn.rnn(x, flat, h0, state_cell=h0, mode="lstm",
                         state_size=h, num_layers=RNN_LM["layers"])[0]
        out.sum().backward()

    def cudnn():
        out, _ = lstm(x, (h0, h0))
        out.sum().backward()

    res = {}
    for name, fn in (("port_loop", ours), ("cudnn", cudnn)):
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        res[name] = float(np.median(ms[1:]))
    return res


def _lm_profile(torch, trainer, batches):
    """RNN_LM["profile_steps"] more card steps under torch.profiler:
    wall ms a step, the card's busy ms (the union of its kernel
    intervals) and share, kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches:
            trainer.step(x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / len(batches)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kern), "the profiler saw no kernel on the card")
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kern]) / len(batches)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "kernels_per_step": len(kern) / len(batches)}


def _rel_to_change(card, host, before):
    """The largest ratio, over the parameters, of the card-CPU distance
    to how far the parameter moved (2-norms), and its name."""
    worst, worst_name = 0.0, None
    for name, got in card.items():
        moved = float(np.linalg.norm(got - before[name]))
        rel = float(np.linalg.norm(got - host[name])) / max(moved, 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def _rnn_lm_part(torch, mx, card_name, tmp):
    from mxnet_tpu_torch import ops
    n_steps = RNN_LM["steps"]
    batches = _lm_batches(n_steps + 2 + RNN_LM["profile_steps"]
                          + RNN_LM["library_steps"])
    t0 = time.perf_counter()
    x0 = batches[0][0]
    card = _lm_settled(mx, mx.gpu(0), x0)
    check(all(p.data().ctx == mx.gpu(0)
              for p in card.collect_params().values()),
          "rnn LM: a parameter is off the card")
    state_ctx = {s.ctx for s in card.begin_state(2)}
    check(state_ctx == {mx.gpu(0)}, f"rnn LM: begin_state on {state_ctx}")
    weights = _params_np(card)
    host = _lm_settled(mx, mx.cpu(), x0, weights)
    ctr = _LMTrainer(mx, card, mx.gpu(0))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card_losses, ms = _lm_steps(torch, ctr, batches[:n_steps])
    torch.cuda.synchronize()
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    # metric.Perplexity on the last step's card softmax, its labels
    ppl = mx.gluon.metric.Perplexity()
    with mx.gpu(0):
        ppl.update([mx.np.array(batches[n_steps - 1][1])],
                   [mx.npx.softmax(ctr.logits)])
    ppl_err = abs(ppl.get()[1] - math.exp(card_losses[-1])) \
        / math.exp(card_losses[-1])
    htr = _LMTrainer(mx, host, mx.cpu())
    host_losses, host_ms = _lm_steps(torch, htr, batches[:n_steps])
    loss_err = max(abs(a - c) / abs(c)
                   for a, c in zip(card_losses, host_losses))
    card_w, host_w = _params_np(card), _params_np(host)
    worst, worst_name = _rel_to_change(card_w, host_w, weights)
    files = _rnn_files(torch, mx, card, host_w, ctr, batches, tmp)
    # one step at dropout 0.5 on the trained weights: finite, and
    # repeated under mx.random.seed
    drop = _lm_settled(mx, mx.gpu(0), x0, card_w, RNN_LM["dropout"])
    dtr = _LMTrainer(mx, drop, mx.gpu(0))
    x, y = batches[n_steps + 1]
    with mx.gpu(0):
        mx.random.seed(11)
        with mx.autograd.record():
            first = dtr.loss_fn(drop(mx.np.array(x), dtr.state)[0],
                                mx.np.array(y)).mean()
        mx.random.seed(11)
        drop_loss = dtr.step(x, y)
    drop_same = float(first) == drop_loss
    del drop, dtr
    prof = _lm_profile(torch, ctr, batches[n_steps + 2:n_steps + 2
                                           + RNN_LM["profile_steps"]])
    lib_ms = _library_lm_step(torch, card_w, batches[-RNN_LM[
        "library_steps"]:])
    rec = _recurrence_ms(torch, card_w)
    p50 = float(np.median(ms[1:]))  # the first step warms cuBLAS
    prof["device_busy_share_of_p50"] = prof["device_busy_ms"] / p50
    tokens = RNN_LM["batch"] * RNN_LM["bptt"]
    out = {"card": card_name, "config": RNN_LM,
           "card_losses": card_losses, "cpu_losses": host_losses,
           "max_loss_rel_err": loss_err,
           "max_param_err_rel_to_change": worst, "worst_param": worst_name,
           "perplexity": ppl.get()[1], "perplexity_rel_err": ppl_err,
           "dropout_loss": drop_loss, "dropout_repeats": drop_same,
           "step_ms": ms, "step_ms_p50": p50,
           "tokens_per_s": tokens / p50 * 1e3, "cpu_step_ms": host_ms,
           "launches": launches, "profile": prof,
           "library_step_ms": lib_ms,
           "library_step_ms_p50": float(np.median(lib_ms[1:])),
           "library": "the same step with torch.nn.LSTM (cuDNN), "
                      "F.cross_entropy, clip_grad_norm_, optim.SGD",
           "recurrence_fwd_bwd_ms": rec, "files": files,
           "seconds": time.perf_counter() - t0}
    emit("rnn_lm", **out)
    check(all(math.isfinite(v) for v in card_losses),
          f"rnn LM: non-finite loss {card_losses}")
    check(loss_err <= RNN_LOSS_REL, f"rnn LM: card vs CPU losses {loss_err}")
    check(worst <= RNN_PARAM_REL,
          f"rnn LM: {worst_name} {worst} x its change (2-norm) from the "
          f"CPU's")
    check(ppl_err <= RNN_PPL_REL,
          f"rnn LM: perplexity {ppl.get()[1]} vs exp(loss) {ppl_err}")
    check(math.isfinite(drop_loss) and drop_same,
          f"rnn LM: dropout step {drop_loss} (repeats: {drop_same})")
    return out


def _rnn_files(torch, mx, card, host_w, ctr, batches, tmp):
    """Save and load on the card: parameters (from the card net and from
    the CPU port's), the trainer's states (the next step bitwise the
    uninterrupted one's), mx.save/mx.load with sparse arrays, and
    model.save_checkpoint/load_params."""
    from mxnet_tpu_torch.gluon.parameter import load_jax_params
    x0, _ = batches[0]
    res = {}
    with mx.gpu(0):
        xa = mx.np.array(x0)
        st = card.begin_state(RNN_LM["batch"])
        with mx.autograd.pause():
            want = card(xa, st)[0].asnumpy()
        pf = f"{tmp}/lm.params"
        card.save_parameters(pf)
        fresh = _lm_settled(mx, mx.gpu(0), x0)
        ptrs = [p._var().data_ptr() for p in fresh.collect_params().values()]
        fresh.load_parameters(pf)
        with mx.autograd.pause():
            got = fresh(xa, st)[0].asnumpy()
        res["card_file_bitwise"] = bool(np.array_equal(got, want))
        res["storage_kept"] = ptrs == [p._var().data_ptr() for p in
                                       fresh.collect_params().values()]
        # a file the CPU port wrote, against the same weights set by name
        with mx.cpu():
            host = _lm_settled(mx, mx.cpu(), x0, host_w)
            host.save_parameters(f"{tmp}/host.params")
        fresh.load_parameters(f"{tmp}/host.params")
        by_name = _lm_settled(mx, mx.gpu(0), x0)
        load_jax_params(by_name, host_w)
        with mx.autograd.pause():
            a = fresh(xa, st)[0].asnumpy()
            b = by_name(xa, st)[0].asnumpy()
        res["cpu_file_bitwise"] = bool(np.array_equal(a, b))
        del host, by_name
        # the trainer: save after the trained steps, then the next step
        # uninterrupted and resumed from the files
        sf = f"{tmp}/lm.states"
        card.save_parameters(pf)
        ctr.trainer.save_states(sf)
        state0 = [s.detach() for s in ctr.state]
        x, y = batches[RNN_LM["steps"]]
        ctr.step(x, y)
        want = _params_np(card)
        rtr = _LMTrainer(mx, fresh, mx.gpu(0))
        fresh.load_parameters(pf)
        rtr.trainer.load_states(sf)
        rtr.state = state0
        rtr.step(x, y)
        got = _params_np(fresh)
        res["resume_bitwise"] = all(np.array_equal(got[k], want[k])
                                    for k in want)
        del fresh, rtr
        # mx.save/mx.load: a dict with a csr and a row_sparse array
        dense = np.zeros((64, 650), "f4")
        dense[::7, ::3] = np.random.RandomState(5).standard_normal(
            dense[::7, ::3].shape)
        d = {"csr": mx.nd.sparse.csr_matrix(dense),
             "rsp": mx.nd.sparse.row_sparse_array(dense),
             "emb": card.embed.weight.data()}
        mx.save(f"{tmp}/d.npz", d)
        back = mx.load(f"{tmp}/d.npz")
        res["sparse_round_trip"] = (
            back["csr"].stype == "csr" and back["rsp"].stype == "row_sparse"
            and all(v.ctx == mx.gpu(0) for v in back.values())
            and all(np.array_equal(back[k].asnumpy(), d[k].asnumpy())
                    for k in d))
        # model.save_checkpoint / load_params (legacy .params)
        arg = {k: p.data() for k, p in card.collect_params().items()}
        mx.model.save_checkpoint(f"{tmp}/ck", 1, None, arg, {})
        a, x_ = mx.model.load_params(f"{tmp}/ck", 1)
        res["checkpoint_round_trip"] = (
            list(a) == list(arg) and not x_
            and all(np.array_equal(a[k].asnumpy(), arg[k].asnumpy())
                    for k in arg))
    for key, ok in res.items():
        check(ok, f"rnn files: {key} failed")
    return res


def _card_cpu(torch, build, run, x_np):
    """``run(block, x)`` of the block ``build`` makes, on the card and on
    the CPU port with the card block's weights: the outputs (numpy) of
    each, and the card call's ms (after one warm-up)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.parameter import load_jax_params
    with mx.gpu(0):
        card = build()
        card.initialize(mx.init.Xavier())
        xa = mx.np.array(x_np)
        run(card, xa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [o.asnumpy() for o in run(card, xa)]
        ms = (time.perf_counter() - t0) * 1e3
        weights = _params_np(card)
    with mx.cpu():
        host = build()
        host.initialize()
        load_jax_params(host, weights)
        ref = [o.asnumpy() for o in run(host, mx.np.array(x_np))]
    err = max(float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max()))
              for g, r in zip(got, ref))
    return err, ms


def _rnn_other_part(torch, mx, card_name):
    """A bidirectional GRU with use_sequence_length at the LM's width and
    a Conv2DLSTMCell unrolled 10 steps, card against the CPU port."""
    rnn = mx.gluon.rnn
    g = RNN_GRU
    rs = np.random.RandomState(41)
    xg = rs.standard_normal((g["batch"], g["bptt"], g["input"])).astype("f4")
    lens = rs.randint(1, g["bptt"] + 1, g["batch"]).astype("i4")

    def gru():
        return rnn.GRU(g["hidden"], bidirectional=True, layout="NTC",
                       use_sequence_length=True, input_size=g["input"])

    def run_gru(block, x):
        st = block.begin_state(g["batch"])
        out, states = block(x, st, mx.np.array(lens, ctx=x.ctx))
        return [out] + list(states)

    gru_err, gru_ms = _card_cpu(torch, gru, run_gru, xg)
    c = RNN_CONV
    xc = rs.standard_normal((c["batch"], c["steps"]) + c["input"]) \
        .astype("f4")
    pad = c["kernel"] // 2

    def conv():
        return rnn.Conv2DLSTMCell(c["input"], c["hidden"], c["kernel"],
                                  c["kernel"], i2h_pad=pad)

    def run_conv(block, x):
        out, states = block.unroll(c["steps"], x, layout="NTC")
        return [out] + list(states)

    conv_err, conv_ms = _card_cpu(torch, conv, run_conv, xc)
    out = {"card": card_name, "gru": g, "gru_max_err": gru_err,
           "gru_fwd_ms": gru_ms, "conv_lstm": c, "conv_max_err": conv_err,
           "conv_unroll_ms": conv_ms}
    emit("rnn_other", **out)
    check(gru_err <= RNN_FWD_TOL, f"rnn GRU: card vs CPU {gru_err}")
    check(conv_err <= RNN_FWD_TOL, f"rnn ConvLSTM: card vs CPU {conv_err}")
    return out


def _rnn_loss_cases(rs):
    """Every loss of item 15b at a realistic size: (name, class, kwargs,
    forward arguments as numpy)."""
    def nrm(*shape):
        return rs.standard_normal(shape).astype("f4")

    def bits(*shape):
        return rs.randint(0, 2, shape).astype("f4")

    c = RNN_CTC
    lab = rs.randint(1, c["classes"], (c["n"], c["max_label"])).astype("i4")
    lab_len = rs.randint(c["max_label"] // 5, c["max_label"] + 1,
                         c["n"]).astype("i4")
    lab[np.arange(c["max_label"])[None, :] >= lab_len[:, None]] = 0
    pred_len = rs.randint(3 * c["t"] // 4, c["t"] + 1, c["n"]).astype("i4")
    logp = nrm(256, 1000)
    prob = np.exp(nrm(256, 1000))
    prob /= prob.sum(-1, keepdims=True)
    return [
        ("sigmoid_bce", "SigmoidBCELoss", {}, [nrm(1024, 256),
                                               bits(1024, 256)], {}),
        ("sigmoid_bce_pos_weight", "SigmoidBinaryCrossEntropyLoss",
         {"from_sigmoid": True},
         [1 / (1 + np.exp(-nrm(1024, 256))), bits(1024, 256)],
         {"pos_weight": rs.uniform(0.5, 3, 256).astype("f4")}),
        ("kldiv", "KLDivLoss", {"from_logits": False},
         [logp, prob.astype("f4")], {}),
        ("ctc_ntc", "CTCLoss", {},
         [nrm(c["n"], c["t"], c["classes"]), lab], {}),
        ("ctc_tnc_lengths", "CTCLoss",
         {"layout": "TNC", "label_layout": "TN"},
         [nrm(c["t"], c["n"], c["classes"]), lab.T.copy(), pred_len,
          lab_len], {}),
        ("huber", "HuberLoss", {"rho": 0.5}, [nrm(1024, 256),
                                              nrm(1024, 256)], {}),
        ("hinge", "HingeLoss", {}, [nrm(1024, 256),
                                    2 * bits(1024, 256) - 1], {}),
        ("squared_hinge", "SquaredHingeLoss", {},
         [nrm(1024, 256), 2 * bits(1024, 256) - 1], {}),
        ("logistic", "LogisticLoss", {"label_format": "binary"},
         [nrm(1024, 256), bits(1024, 256)], {}),
        ("triplet", "TripletLoss", {}, [nrm(1024, 128), nrm(1024, 128),
                                        nrm(1024, 128)], {}),
        ("poisson_nll", "PoissonNLLLoss", {"compute_full": True},
         [nrm(1024, 256) * 0.5,
          rs.poisson(2.0, (1024, 256)).astype("f4")], {}),
        ("cosine_embedding", "CosineEmbeddingLoss", {"margin": 0.2},
         [nrm(1024, 128), nrm(1024, 128), 2 * bits(1024) - 1], {}),
        ("sdml", "SDMLLoss", {}, [nrm(256, 128), nrm(256, 128)], {}),
    ]


def _rnn_losses_metrics(torch, mx, card_name):
    """Every new loss at a realistic size and every registered metric,
    card inputs against the same inputs on the CPU port."""
    import mxnet_tpu_torch.gluon.loss as L
    import mxnet_tpu_torch.gluon.metric as M
    rs = np.random.RandomState(43)
    losses = {}
    for name, cls, kw, args, call_kw in _rnn_loss_cases(rs):
        outs = []
        for dev in ("cuda", "cpu"):
            fn = getattr(L, cls)(**kw)
            ta = [torch.as_tensor(a, device=dev) for a in args]
            tk = {k: torch.as_tensor(v, device=dev)
                  for k, v in call_kw.items()}
            outs.append(fn(*ta, **tk).cpu().numpy())
        err = float(np.abs(outs[0] - outs[1]).max()) / max(
            1.0, float(np.abs(outs[1]).max()))
        losses[name] = {"shape": list(outs[0].shape), "max_err": err,
                        "finite": bool(np.isfinite(outs[0]).all())}
    n, c = 4096, 1000
    logits = rs.standard_normal((n, c)).astype("f4")
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rs.randint(0, c, n).astype("f4")
    bin_lab = rs.randint(0, 2, n).astype("f4")
    reg = (rs.standard_normal((n, 64)).astype("f4"),
           rs.standard_normal((n, 64)).astype("f4"))
    sig = (1 / (1 + np.exp(-logits[:, 0]))).astype("f4")
    inputs = {"class": (labels, probs), "binary": (bin_lab, sig),
              "binary2": (bin_lab, probs[:, :2]), "reg": reg,
              "loss": (labels, probs[:, 0])}
    kinds = {"accuracy": "class", "topkaccuracy": "class", "f1": "binary",
             "mcc": "binary2", "fbeta": "binary", "mae": "reg", "mse": "reg",
             "rmse": "reg", "crossentropy": "class",
             "negativeloglikelihood": "class", "perplexity": "class",
             "pearsoncorrelation": "reg", "binaryaccuracy": "binary",
             "meanpairwisedistance": "reg", "meancosinesimilarity": "reg",
             "pcc": "class", "loss": "loss", "torch": "loss"}
    metrics = {}
    for name, kind in kinds.items():
        lab, pred = inputs[kind]
        kw = {"top_k": 5} if name == "topkaccuracy" else {}
        vals = []
        for ctx in (mx.gpu(0), mx.cpu()):
            m = M.create(name, **kw)
            with ctx:
                m.update([mx.np.array(lab)], [mx.np.array(pred)])
            vals.append(m.get()[1])
        card_t = M.create(name, **kw)
        card_t.update([torch.as_tensor(lab, device="cuda")],
                      [torch.as_tensor(pred, device="cuda")])
        metrics[name] = {"card": vals[0], "cpu": vals[1],
                         "card_tensor": card_t.get()[1]}
    classes = {k.__name__.lower() for k in M._REGISTRY.values()}
    check(classes - {"compositeevalmetric", "custommetric"} == set(kinds),
          f"rnn: registered metric classes {sorted(classes)} vs the card "
          f"cases {sorted(kinds)}")
    out = {"card": card_name, "losses": losses, "metrics": metrics}
    emit("rnn_losses_metrics", **out)
    for name, r in losses.items():
        check(r["finite"] and r["max_err"] <= RNN_FWD_TOL,
              f"rnn loss {name}: card vs CPU {r}")
    for name, r in metrics.items():
        check(r["card"] == r["cpu"] == r["card_tensor"],
              f"rnn metric {name}: card {r['card']} vs CPU {r['cpu']} "
              f"(tensor {r['card_tensor']})")
    return out


def phase_rnn(torch, card_name):
    """Item 15b and item 18a on the card: (1) the word-level LSTM LM
    (RNN_LM) trained 3 steps at dropout 0 against the CPU port on the
    same weights and data (losses, parameters, metric.Perplexity), then
    save and load (parameters from the card's and the CPU port's files,
    the trainer's states resuming bitwise, mx.save/mx.load with sparse
    arrays, model.save_checkpoint/load_params), one step at dropout 0.5
    repeated under mx.random.seed, a profile of 2 steps, and the same
    step in plain PyTorch with cuDNN's LSTM (printed only); (2) a
    bidirectional GRU with use_sequence_length and a Conv2DLSTMCell,
    card against the CPU port; (3) every new loss at a realistic size
    (CTCLoss at N 32, T 200, 29 classes) and every metric, card inputs
    against the CPU's. It launches none of K1-K5: the recurrence is
    cuBLAS products step by step, as in the reference (a scan)."""
    import tempfile
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        lm = _rnn_lm_part(torch, mx, card_name, tmp)
    other = _rnn_other_part(torch, mx, card_name)
    lm_ = _rnn_losses_metrics(torch, mx, card_name)
    gc.collect()
    torch.cuda.empty_cache()
    emit("rnn", card=card_name, seconds=time.perf_counter() - t0)
    return {"launches": lm["launches"], "lm": lm, "other": other,
            "losses_metrics": lm_}


#: the amp_data phase's model: BERT-base's widths (Devlin et al., 2019:
#: 768 units, 12 heads, FFN 3072, WordPiece vocabulary 30522, sequences
#: of 512): an Embedding, post-norm non-causal TransformerEncoderCells
#: with GELU (depth cut from 12 to 2, as the gluon phase's), a 30522-way
#: Dense head and SoftmaxCrossEntropyLoss; batch 8 x 512 from an
#: ArrayDataset of 64 seeded sequences through a process-worker
#: DataLoader; float16 AMP (amp.init), LAMB at lr 1e-4 (You et al.,
#: 2019) with dynamic loss scaling, one epoch of 8 steps (the p50 of 7
#: timed ones), then a profile of 2
AMP_BERT = dict(vocab=30522, units=768, heads=12, hidden=3072, layers=2,
                batch=8, seq=512, samples=64, steps=8, lr=1e-4, workers=2,
                profile_steps=2)
#: card vs CPU port under the same AMP, from the same weights on the same
#: batches cut to 2 x 32 tokens on both devices: the host of an H100
#: machine took 105.7 s for two such steps at 2 x 128 tokens (its float16
#: products have no fast host kernel; PERF.md §6). Every product's
#: output rounds to float16 on both devices, from sums in another order.
#: Losses within 2e-3 relative; they sit near ln(30522) at Xavier init
#: and show no update, so the first step's logits (2-norm of the
#: difference over the CPU's) and each parameter's change over the two
#: steps (_change_err) are held too. The scale starts at 2^12, not
#: 2^16: at 2^16 a float16 bias gradient (a sum over the tokens) sits
#: at 65056 on the first step and overflows on the second, on one device
#: or both, so the steps compared would be skipped ones. A learning
#: rate 1.1 x too large moves the changes 0.10 apart, an attention
#: scale 1.1 x too large the logits 0.024 and the changes 0.24 (the CPU
#: port against itself: scripts/torch_amp_yardsticks.py). The card read
#: 5.0e-4 and 0.035 (the first cell's ln1.beta) on NVIDIA H100 80GB
#: HBM3, 700.00 W: the limits sit 8 x and 1.7 x above the readings, 6 x
#: and 1.7 x below those faults
AMP_CPU = dict(batch=2, seq=32, steps=2, loss_rel=2e-3, loss_scale=2.0 ** 12,
               logits_rel=4e-3, change_rel=0.06)
#: the AMP run against an fp32 run of the same model on the card, the
#: same weights and batches, the fp32 run updating where the AMP run's
#: scaler did not skip: losses within the train phase's 0.15 (the
#: reference's bf16 contract); the first step's logits and each
#: parameter's change over the epoch (AMP_FP32_REL: the card read 4.9e-4
#: and 0.063, the first cell's out_proj.bias, on NVIDIA H100 80GB HBM3,
#: 700.00 W; the CPU port 5.4e-4 and 0.022 for two steps at 2 x 32
#: tokens); the limits are 8 x and 1.9 x the card's readings
AMP_FP32_TOL = 0.15
AMP_FP32_REL = dict(logits_rel=4e-3, change_rel=0.12)
#: the amp_data phase's image part: a synthetic CIFAR-10 file (seeded,
#: data_batch_1 of 10000 images, data_batch_2-5 empty) through
#: vision.CIFAR10 and the usual augmentation into 4 process workers,
#: feeding the gluon phase's ResNet-18 stem and first stage under the
#: same AMP with SGD (momentum 0.9, multi_precision=False), 2 steps
AMP_CIFAR = dict(images=10000, batch=128, workers=4, steps=2, lr=0.1,
                 momentum=0.9, held=16)
#: the optimizer sweep's weights: GPT-2 small's FFN pair (a 3072 x 768
#: weight and its bias); each registered optimizer 3 steps, card against
#: the CPU port: fp32 weights and states within 1e-5 x max(1, max|ref|)
#: (the same float32 elementwise operations round the same on both
#: devices; LAMB's, LARS's and LANS's norms sum in another order);
#: float16 weights (multi_precision) within one float16 step of
#: max(1, max|ref|), their fp32 masters within the fp32 bound
AMP_SWEEP = dict(out=3072, inp=768, steps=3, lr=0.01, tol=1e-5)


def _bert(mx, nn):
    c = AMP_BERT
    net = nn.HybridSequential()
    net.add(nn.Embedding(c["vocab"], c["units"]))
    for _ in range(c["layers"]):
        net.add(nn.TransformerEncoderCell(
            c["units"], c["heads"], hidden_dim=c["hidden"], causal=False,
            activation="gelu", pre_norm=False))
    net.add(nn.Dense(c["vocab"], flatten=False))
    return net


def _amp_copy(mx, build, weights, ctx):
    """``build``'s net on ``ctx`` with ``weights`` (carried by name)."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.parameter import load_jax_params
    with ctx:
        net = build(mx, nn)
        net.initialize(mx.init.Zero())
        load_jax_params(net, weights)
    return net


def _amp_step(mx, net, trainer, loss_fn, x, y, batch, scaled=True,
              keep=None, apply=True):
    """One record() -> loss -> scale_loss -> backward -> step (none
    unless ``apply``); returns the mean loss read back. ``keep``, a
    list, gets the step's logits."""
    with mx.autograd.record():
        out = net(x)
        loss = loss_fn(out, y)
        if scaled:
            with mx.amp.scale_loss(loss, trainer) as sl:
                pass
        else:
            sl = loss
    sl.backward()
    if apply:
        trainer.step(batch)
    if keep is not None:
        keep.append(out._data.detach())
    return float(loss.mean())


def _rel2(a, b):
    """||a - b|| / ||b|| (2-norms in float64) of two tensors on one
    device."""
    a, b = a.double(), b.double()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _change_err(got, ref, w0):
    """The parameter whose change from ``w0`` in ``got`` differs most
    from its change in ``ref`` (dicts of tensors by name, on one
    device): (||got - ref|| / ||ref - w0||, its name). The key
    projections' biases are left out: softmax is invariant under a
    shift of one query's scores, so their gradient is 0 in exact
    arithmetic and their change is rounding noise that LAMB's trust
    ratio scales up."""
    return max((_rel2(got[k].double() - w0[k].double(),
                      ref[k].double() - w0[k].double()), k)
               for k in ref if not k.endswith("k_proj.bias"))


def _weights_of(net, device):
    """``net``'s parameters by name, copied to ``device``."""
    return {k: p._var().detach().to(device, copy=True)
            for k, p in net.collect_params().items()}


def _amp_profile(torch, mx, net, trainer, loss_fn, x, y, batch, steps):
    """``steps`` more card steps under torch.profiler: wall ms a step,
    the card's busy ms (the union of its kernel intervals), its share,
    and kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _amp_step(mx, net, trainer, loss_fn, x, y, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kern), "amp_data: the profiler saw no kernel on the card")
    busy = _busy_ms([(e.time_range.start, e.time_range.end)
                     for e in kern]) / steps
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "kernels_per_step": len(kern) / steps}


def _amp_kernels(torch):
    """K1-f16 and both K1-bwd-f16 launches at this phase's attention,
    (8, 12, 512, 64) non-causal float16 on the head split's strided
    views, against their plain versions on the widened inputs rounded
    to float16: one float16 step of max(1, max|ref|) for the output
    (as the f16 kernel phase), two for the gradients (BWD_TOL)."""
    from mxnet_tpu_torch.ops import attention as at
    c = AMP_BERT
    b, s, h, d = c["batch"], c["seq"], c["heads"], c["units"] // c["heads"]
    rng = np.random.RandomState(41)
    q, k, v, do = (_split_view(torch, rng, b, s, h, d).half()
                   for _ in range(4))
    sc = 1.0 / math.sqrt(d)
    out, lse = at.flash_attention_fwd(q, k, v, False, None, None)
    ref, ref_lse = at._blockwise_fwd(q.float(), k.float(), v.float(), False,
                                     sc)
    eo, tol = _half_err(out, ref.half(), F16_ULP)
    el = float((lse - ref_lse).abs().max())
    got = at.flash_attention_bwd(q, k, v, out, lse, do, False, None, None)
    refg = at._flash_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                         do.float(), False, sc, None)
    torch.cuda.synchronize()
    grads = {}
    for name, g, r in zip(("dq", "dk", "dv"), got, refg):
        check(g.dtype == torch.float16 and bool(torch.isfinite(g).all()),
              f"amp_data: K1-bwd-f16 {name} {g.dtype} or not finite")
        r = r.half().float()
        grads[name] = float((g.float() - r).abs().max()) / max(
            1.0, float(r.abs().max()))
    res = {"shape": [b, h, s, d], "causal": False, "out_err": eo,
           "out_tol": tol, "lse_err": el, "grad_err_rel": grads,
           "grad_tol": BWD_TOL["f16"]}
    check(eo <= tol and el <= LSE_TOL,
          f"amp_data: K1-f16 vs plain {eo} (tol {tol}), lse {el}")
    check(max(grads.values()) <= BWD_TOL["f16"],
          f"amp_data: K1-bwd-f16 vs plain {grads}")
    return res


def _bert_data(mx):
    """AMP_BERT's 64 seeded sequences; each token's label is the token
    one place on (the sequence wraps)."""
    c = AMP_BERT
    rs = np.random.RandomState(0)
    ids = rs.randint(0, c["vocab"], (c["samples"], c["seq"])).astype("i4")
    return mx.gluon.data.ArrayDataset(ids, np.roll(ids, -1, axis=1))


def _amp_bert_part(torch, mx, card_name, dataset, loader):
    """The BERT-width AMP + LAMB loop (AMP_BERT) through ``loader``, a
    process-worker DataLoader over ``dataset``, with its checks."""
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.gluon import data as gdata
    c = AMP_BERT
    card_dev = mx.gpu(0).torch_device
    t0 = time.perf_counter()
    secs = {}
    ids = dataset[0][0][None]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.gpu(0):
        mx.random.seed(0)
        card = _bert(mx, mx.gluon.nn)
        card.initialize(mx.init.Xavier())
        card.infer_shape(mx.np.array(ids[:, :8]))
    weights = {k: p.data().asnumpy()
               for k, p in card.collect_params().items()}
    n_params = int(sum(w.size for w in weights.values()))
    mx.amp.init("float16")
    secs["build"] = time.perf_counter() - t0
    # card vs the CPU port, both under AMP, on the dataset's first
    # sequences cut to AMP_CPU's 2 x 32 tokens: the CPU's steps run
    # while the loader's workers start
    cb, cs = AMP_CPU["batch"], AMP_CPU["seq"]
    small = [tuple(np.stack([dataset[i][f][:cs]
                             for i in range(k * cb, (k + 1) * cb)])
                   for f in (0, 1)) for k in range(AMP_CPU["steps"])]
    pair, pair_logits, pair_w, pair_scale = {}, {}, {}, {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        net = _amp_copy(mx, _bert, weights, ctx)
        keep = []
        with ctx:
            tr = mx.gluon.Trainer(net.collect_params(), "lamb",
                                  {"learning_rate": c["lr"]})
            mx.amp.init_trainer(tr)
            tr._amp_loss_scaler.loss_scale = AMP_CPU["loss_scale"]
            pair[name] = [_amp_step(mx, net, tr, loss_fn, mx.np.array(x),
                                    mx.np.array(y), cb, keep=keep)
                          for x, y in small]
        pair_scale[name] = (tr._amp_loss_scaler.loss_scale,
                            tr._amp_loss_scaler.overflow_count)
        pair_logits[name] = keep[0].cpu()
        pair_w[name] = _weights_of(net, "cpu")
        del net, tr, keep
    cpu_err = max(abs(a - b) / abs(b)
                  for a, b in zip(pair["card"], pair["cpu"]))
    cpu_logits_err = _rel2(pair_logits["card"], pair_logits["cpu"])
    w0 = {k: torch.from_numpy(v) for k, v in weights.items()}
    cpu_change_err, cpu_change_worst = _change_err(pair_w["card"],
                                                   pair_w["cpu"], w0)
    del pair_logits, pair_w
    secs["cpu_compare"] = time.perf_counter() - t0 - sum(secs.values())
    with mx.gpu(0):
        trainer = mx.gluon.Trainer(card.collect_params(), "lamb",
                                   {"learning_rate": c["lr"]})
        mx.amp.init_trainer(trainer)
        np.random.seed(1)
        it = iter(loader)
        losses, ms, waits, scales, used, keep = [], [], [], [], [], []
        applied = []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for step in range(c["steps"]):
            t1 = time.perf_counter()
            x, y = next(it)
            waits.append((time.perf_counter() - t1) * 1e3)
            skips = trainer._amp_loss_scaler.overflow_count
            losses.append(_amp_step(mx, card, trainer, loss_fn, x, y,
                                    c["batch"], keep=keep if step == 0
                                    else None))
            applied.append(trainer._amp_loss_scaler.overflow_count == skips)
            ms.append((time.perf_counter() - t1) * 1e3)
            scales.append(trainer._amp_loss_scaler.loss_scale)
            used.append((x, y))
        torch.cuda.synchronize()
        launches = {k: n for k, n in ops.launch_counts().items() if n}
        amp_w = _weights_of(card, card_dev)
        rest = list(it)
        # the first batch's loss again after the steps (batches differ
        # by more than a few steps at lr 1e-4 move a loss)
        after = float(loss_fn(card(used[0][0]), used[0][1]).mean())
    secs["steps"] = time.perf_counter() - t0 - sum(secs.values())
    want = {k: c["layers"] * c["steps"] for k in (
        "flash_attention_fwd_f16", "flash_attention_bwd_dq_f16",
        "flash_attention_bwd_dkv_f16")}
    check(launches == want,
          f"amp_data: launches {launches}, want {want} (and no fp32 "
          f"attention launch)")
    check(used[0][0].ctx == mx.gpu(0) and str(used[0][0].dtype) == "int32",
          f"amp_data: batch on {used[0][0].ctx} as {used[0][0].dtype}")
    # the same epoch from thread workers: the same batches
    threads = gdata.DataLoader(dataset, batch_size=c["batch"], shuffle=True,
                               num_workers=c["workers"])
    np.random.seed(1)
    with mx.gpu(0):
        thread_batches = list(threads)
    proc_batches = [b for b in used] + rest
    workers_equal = len(proc_batches) == len(thread_batches) == \
        c["samples"] // c["batch"] and all(
            np.array_equal(a.asnumpy(), b.asnumpy())
            for pa, pb in zip(proc_batches, thread_batches)
            for a, b in zip(pa, pb))
    check(workers_equal, "amp_data: process workers' batches differ from "
          "thread workers'")
    threads.close()
    secs["threads"] = time.perf_counter() - t0 - sum(secs.values())
    prof = _amp_profile(torch, mx, card, trainer, loss_fn, *used[0],
                        c["batch"], c["profile_steps"])
    p50 = float(np.median(ms[1:]))
    prof["device_busy_share_of_p50"] = prof["device_busy_ms"] / p50
    # injected overflows, each with a fresh trainer: an inf in the
    # head's gradient, a NaN (float16's usual overflow result) in the
    # middle of the embedding's
    overflow = {}
    for kind, block, at in (("inf", -1, (0, 0)),
                            ("nan", 0, (c["vocab"] // 2, 7))):
        with mx.gpu(0):
            tr2 = mx.gluon.Trainer(card.collect_params(), "lamb",
                                   {"learning_rate": c["lr"]})
            mx.amp.init_trainer(tr2)
            x, y = used[0]
            with mx.autograd.record():
                loss = loss_fn(card(x), y)
                with mx.amp.scale_loss(loss, tr2) as sl:
                    pass
            sl.backward()
            params = list(card.collect_params().values())
            card[block].weight.grad()[at] = float(kind)
            before = [p._var().clone() for p in params]
            scaler = tr2._amp_loss_scaler
            s0 = scaler.loss_scale
            flag, syncs, _ = _audit(torch, card_dev,
                                    lambda: scaler.has_overflow(params))
            tr2.step(c["batch"])
            unchanged = all(torch.equal(p._var(), b0)
                            for p, b0 in zip(params, before))
            del before
        row = {"detected": flag, "host_reads": sum(syncs.values()),
               "syncs": syncs, "params_unchanged": unchanged,
               "scale_before": s0, "scale_after": scaler.loss_scale,
               "overflow_count": scaler.overflow_count}
        overflow[kind] = row
        check(flag and unchanged and scaler.loss_scale == s0 / 2
              and scaler.overflow_count == 1,
              f"amp_data: injected {kind} {row}")
        check(sum(syncs.values()) == 1,
              f"amp_data: has_overflow read the card {syncs}")
    # the check's one reduction on a NaN alone, in each floating type
    # and at sizes of one block, several, and many
    from mxnet_tpu_torch.amp.loss_scaler import all_finite
    nan_seen = {}
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        for n in (5, 4099, (1 << 22) + 3):
            t = torch.zeros(n, dtype=dt, device=card_dev)
            t[n // 2] = float("nan")
            nan_seen[f"{str(dt)[6:]}x{n}"] = not all_finite(
                [torch.ones(3, device=card_dev), t])
    overflow["nan_alone_seen"] = nan_seen
    check(all(nan_seen.values()), f"amp_data: a NaN passed {nan_seen}")
    secs["profile_overflow"] = time.perf_counter() - t0 - sum(secs.values())
    # the same model in fp32 on the card, the same weights and batches,
    # updating where the AMP run did (not where its scaler skipped)
    mx.amp._state["active"] = False
    keep32 = []
    try:
        fp32 = _amp_copy(mx, _bert, weights, mx.gpu(0))
        with mx.gpu(0):
            tr32 = mx.gluon.Trainer(fp32.collect_params(), "lamb",
                                    {"learning_rate": c["lr"]})
            fp32_losses = [_amp_step(mx, fp32, tr32, loss_fn, x, y,
                                     c["batch"], scaled=False,
                                     keep=keep32 if step == 0 else None,
                                     apply=applied[step])
                           for step, (x, y) in enumerate(used)]
        fp32_w = _weights_of(fp32, card_dev)
        del fp32, tr32
    finally:
        mx.amp._state["active"] = True
    fp32_gap = max(abs(a - b) for a, b in zip(losses, fp32_losses))
    fp32_logits_err = _rel2(keep[0], keep32[0])
    w0 = {k: v.to(card_dev) for k, v in w0.items()}
    fp32_change_err, fp32_change_worst = _change_err(amp_w, fp32_w, w0)
    del keep, keep32, amp_w, fp32_w, w0
    secs["fp32"] = time.perf_counter() - t0 - sum(secs.values())
    kern = _amp_kernels(torch)
    out = {"card": card_name, "config": AMP_BERT, "parameters": n_params,
           "losses": losses, "first_batch_loss_after": after,
           "loss_scale": scales, "applied": applied, "step_ms": ms,
           "step_ms_p50": p50,
           "tokens_per_s": c["batch"] * c["seq"] / p50 * 1e3,
           "loader_wait_ms": waits,
           "launches": launches, "profile": prof,
           "workers_equal": workers_equal, "overflow": overflow,
           "fp32_losses": fp32_losses, "amp_vs_fp32_max_gap": fp32_gap,
           "amp_vs_fp32": {**AMP_FP32_REL,
                           "first_logits_rel_err": fp32_logits_err,
                           "worst_change_rel_err": fp32_change_err,
                           "worst_change_param": fp32_change_worst},
           "cpu_compare": {**AMP_CPU, "card_losses": pair["card"],
                           "cpu_losses": pair["cpu"],
                           "max_loss_rel_err": cpu_err,
                           "scale_and_overflows": pair_scale,
                           "first_logits_rel_err": cpu_logits_err,
                           "worst_change_rel_err": cpu_change_err,
                           "worst_change_param": cpu_change_worst},
           "kernels": kern, "seconds": time.perf_counter() - t0,
           "seconds_by_part": secs}
    emit("amp_bert", **out)
    check(all(math.isfinite(v) for v in losses + fp32_losses),
          f"amp_data: non-finite loss {losses} {fp32_losses}")
    check(math.isfinite(after) and after < losses[0],
          f"amp_data: the first batch's loss did not fall: {losses[0]} "
          f"before the steps, {after} after")
    check(fp32_gap <= AMP_FP32_TOL,
          f"amp_data: AMP vs fp32 losses {fp32_gap}")
    check(cpu_err <= AMP_CPU["loss_rel"],
          f"amp_data: card vs CPU losses {cpu_err}")
    check(all(v == (AMP_CPU["loss_scale"], 0) for v in pair_scale.values()),
          f"amp_data: a step of the card vs CPU pair was skipped "
          f"{pair_scale}")
    check(cpu_logits_err <= AMP_CPU["logits_rel"],
          f"amp_data: card vs CPU first logits {cpu_logits_err}")
    check(cpu_change_err <= AMP_CPU["change_rel"],
          f"amp_data: card vs CPU {cpu_change_worst}'s change "
          f"{cpu_change_err}")
    check(fp32_logits_err <= AMP_FP32_REL["logits_rel"],
          f"amp_data: AMP vs fp32 first logits {fp32_logits_err}")
    check(fp32_change_err <= AMP_FP32_REL["change_rel"],
          f"amp_data: AMP vs fp32 {fp32_change_worst}'s change "
          f"{fp32_change_err}")
    return out


def _write_cifar(root, n):
    """A synthetic CIFAR-10 in the python pickle layout: ``n`` seeded
    images in data_batch_1, data_batch_2-5 empty."""
    import os
    import pickle
    rs = np.random.RandomState(7)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for i in range(1, 6):
        k = n if i == 1 else 0
        with open(os.path.join(base, f"data_batch_{i}"), "wb") as f:
            pickle.dump({"data": rs.randint(0, 256, (k, 3072)).astype("u1"),
                         "labels": rs.randint(0, 10, k).tolist()}, f)


def _cifar_transform(mx):
    tf = mx.gluon.data.vision.transforms
    return tf.Compose([tf.RandomCrop(32, pad=4), tf.RandomFlipLeftRight(),
                       tf.ToTensor(),
                       tf.Normalize((0.4914, 0.4822, 0.4465),
                                    (0.2470, 0.2435, 0.2616))])


def _cifar_loader(mx, root):
    """AMP_CIFAR's synthetic CIFAR-10 under ``root`` through
    vision.CIFAR10 and the augmentation into process workers."""
    from mxnet_tpu_torch.gluon import data as gdata
    c = AMP_CIFAR
    _write_cifar(root, c["images"])
    raw = gdata.vision.CIFAR10(root)
    check(len(raw) == c["images"], f"amp_data: CIFAR10 has {len(raw)}")
    ds = raw.transform_first(_cifar_transform(mx))
    return raw, gdata.DataLoader(ds, batch_size=c["batch"], shuffle=True,
                                 num_workers=c["workers"],
                                 thread_pool=False, pin_memory=True,
                                 last_batch="discard")


def _amp_cifar_part(torch, mx, card_name, raw, loader):
    c = AMP_CIFAR
    t0 = time.perf_counter()
    # the transforms on the card and on the CPU port, the same draws
    held = {}
    for name, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with ctx:
            tf = _cifar_transform(mx)
            np.random.seed(5)
            held[name] = np.stack([tf(raw[i][0]).asnumpy()
                                   for i in range(c["held"])])
    tf_err = float(np.abs(held["card"] - held["cpu"]).max())
    check(held["card"].shape == (c["held"], 3, 32, 32) and tf_err <= 1e-6,
          f"amp_data: transforms card vs CPU {tf_err}")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.gpu(0):
        mx.random.seed(1)
        net = _gluon_resnet(mx, mx.gluon.nn)
        net.initialize(mx.init.Xavier())
        net.infer_shape(mx.np.array(np.zeros((1, 3, 32, 32), "f4")))
        trainer = mx.gluon.Trainer(
            net.collect_params(), "sgd",
            {"learning_rate": c["lr"], "momentum": c["momentum"],
             "multi_precision": False})
        mx.amp.init_trainer(trainer)
        it = iter(loader)
        losses, ms, waits = [], [], []
        for _ in range(c["steps"]):
            t1 = time.perf_counter()
            x, y = next(it)
            waits.append((time.perf_counter() - t1) * 1e3)
            losses.append(_amp_step(mx, net, trainer, loss_fn, x, y,
                                    c["batch"]))
            ms.append((time.perf_counter() - t1) * 1e3)
        conv = net[0](x)
        bn = net[1](conv)
        types = {"input": str(x.dtype), "conv": str(conv.dtype),
                 "batch_norm": str(bn.dtype),
                 "weights": str(net[0].weight.data().dtype)}
    out = {"card": card_name, "config": AMP_CIFAR, "losses": losses,
           "step_ms": ms, "loader_wait_ms": waits,
           "images_per_s": c["batch"] / ms[-1] * 1e3, "types": types,
           "transform_max_abs_err": tf_err,
           "seconds": time.perf_counter() - t0}
    emit("amp_cifar", **out)
    check(all(math.isfinite(v) for v in losses),
          f"amp_data: CIFAR non-finite loss {losses}")
    check(types == {"input": "float32", "conv": "float16",
                    "batch_norm": "float32", "weights": "float32"},
          f"amp_data: CIFAR types {types}")
    return out


_SWEEP_DATA = {}


def _sweep_data(torch):
    """The sweep's seeded weights and gradients (host tensors), made
    once: the FFN pair's weight and bias, and 3 steps' gradients."""
    if not _SWEEP_DATA:
        c = AMP_SWEEP
        rs = np.random.RandomState(3)
        shapes = [(c["out"], c["inp"]), (c["out"],)]
        _SWEEP_DATA["w"] = [torch.from_numpy(
            rs.uniform(-1, 1, s).astype("f4")) for s in shapes]
        _SWEEP_DATA["g"] = [[torch.from_numpy(
            rs.standard_normal(s).astype("f4")) for s in shapes]
            for _ in range(c["steps"])]
    return _SWEEP_DATA


def _sweep_run(torch, mx, name, ctx, mp, lr=None):
    """One optimizer's 3 steps on the FFN pair on ``ctx``: fp32, or
    float16 weights with fp32 masters (``mp``). Returns the weights, the
    states, the gradients and the optimizer's arguments."""
    c = AMP_SWEEP
    opt = mx.optimizer
    data = _sweep_data(torch)
    n = 1 if name == "groupadagrad" else 2
    dev = ctx.torch_device
    dt = torch.float16 if mp else torch.float32
    ws = [w.to(dev, dt, copy=True) for w in data["w"][:n]]
    gs = [[g.to(dev, dt) for g in step[:n]] for step in data["g"]]
    kw = {"learning_rate": lr or c["lr"], "multi_precision": mp}
    if name != "groupadagrad":
        kw["wd"] = 0.01
    o = opt.create(name, **kw)
    states = [o.create_state_multi_precision(i, w) for i, w in enumerate(ws)]
    idx = list(range(len(ws)))
    for g in gs:
        o.update_multi_precision(idx, ws, g, states)
    return ws, states, gs, kw


def _np_leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _np_leaves(v)]
    return [x.float().cpu().numpy()]


def _amp_sweep(torch, mx, card_name):
    """Every registered optimizer, card against the CPU port."""
    c = AMP_SWEEP
    t0 = time.perf_counter()
    card, res = mx.gpu(0), {}
    for name in sorted(mx.optimizer._REGISTRY):
        row = {}
        if name == "sgld":
            # the noise comes from each device's own generator: the
            # deterministic part is the CPU's SGD step without noise,
            # the noise's std sqrt(lr), and a seed repeats it
            runs = []
            for _ in range(2):
                mx.random.seed(11)
                runs.append(_sweep_run(torch, mx, name, card, False)[0])
            det = _sweep_run(torch, mx, "sgd", mx.cpu(), False,
                             lr=c["lr"] / 2)[0]
            noise = (runs[0][0].cpu() - det[0]).double()
            row = {"repeats": all(torch.equal(a, b)
                                  for a, b in zip(*runs))}
            row["noise_std_over_sqrt_lr_x3"] = float(noise.std()) / (
                math.sqrt(c["lr"]) * math.sqrt(c["steps"]))
            res[name] = row
            continue
        errs = {}
        for mp in (False, True):
            wc, sc, gs, kw = _sweep_run(torch, mx, name, card, mp)
            wh, sh, _, _ = _sweep_run(torch, mx, name, mx.cpu(), mp)
            ew = max(float(np.abs(a - b).max()) / max(1.0, float(
                np.abs(b).max())) for a, b in zip(_np_leaves(wc),
                                                  _np_leaves(wh)))
            es = max([float(np.abs(a - b).max()) / max(1.0, float(
                np.abs(b).max())) for a, b in zip(_np_leaves(sc),
                                                  _np_leaves(sh))] or [0.0])
            errs["mp_f16" if mp else "fp32"] = {"weights": ew, "states": es}
            if not mp:
                # the same steps through an Updater: the same bits
                shapes = [tuple(w.shape) for w in wc]
                w2 = [w.cuda() for w in _sweep_data(torch)["w"][:len(wc)]]
                upd = mx.optimizer.get_updater(mx.optimizer.create(name,
                                                                   **kw))
                for g in gs:
                    upd(list(range(len(w2))), g, w2)
                row["updater_bitwise"] = all(torch.equal(a, b)
                                             for a, b in zip(w2, wc))
                # the Trainer (its fused update) against one
                # update_multi_precision a parameter, called directly
                o = mx.optimizer.create(name, **kw)
                w3 = [w.cuda() for w in _sweep_data(torch)["w"][:len(wc)]]
                st3 = [o.create_state_multi_precision(i, w)
                       for i, w in enumerate(w3)]
                for g in gs:
                    for i, (w, gi) in enumerate(zip(w3, g)):
                        o.update_multi_precision([i], [w], [gi], [st3[i]])
                with card:
                    ps = []
                    for i, s in enumerate(shapes):
                        p = mx.gluon.Parameter(f"p{i}", shape=s)
                        p.initialize(ctx=card)
                        p.set_data(_sweep_data(torch)["w"][i])
                        ps.append(p)
                    tr = mx.gluon.Trainer(ps, name, dict(kw))
                    for g in gs:
                        for p, gi in zip(ps, g):
                            p.grad()[:] = mx.NDArray(gi, ctx=card)
                        tr.step(1, ignore_stale_grad=True)
                row["trainer_bitwise"] = all(
                    torch.equal(p._var(), w) for p, w in zip(ps, w3))
        row.update(errs)
        res[name] = row
    out = {"card": card_name, "config": AMP_SWEEP, "optimizers": res,
           "seconds": time.perf_counter() - t0}
    emit("amp_optimizer_sweep", **out)
    check(set(res) == set(mx.optimizer._REGISTRY),
          "amp_data: an optimizer missed the sweep")
    for name, row in res.items():
        if name == "sgld":
            check(row["repeats"] and abs(
                row["noise_std_over_sqrt_lr_x3"] - 1) < 0.02,
                f"amp_data: SGLD {row}")
            continue
        check(row["updater_bitwise"] and row["trainer_bitwise"],
              f"amp_data: {name} Updater/Trainer bits {row}")
        check(row["fp32"]["weights"] <= c["tol"]
              and row["fp32"]["states"] <= c["tol"],
              f"amp_data: {name} fp32 card vs CPU {row['fp32']}")
        check(row["mp_f16"]["weights"] <= F16_ULP
              and row["mp_f16"]["states"] <= c["tol"],
              f"amp_data: {name} float16 mp card vs CPU {row['mp_f16']}")
    return out


def phase_amp_data(torch, card_name):
    """Item 16 and item 17a on the card: (1) the BERT-width float16 AMP
    + LAMB loop (AMP_BERT) fed by a process-worker DataLoader with
    pinned batches: one K1-f16 and one of each K1-bwd-f16 launch per
    cell and step and no fp32 attention launch, losses finite, the
    first batch's loss lower after the steps, the loss scale each step,
    the loader's wait per batch, a profile of 2 steps; the process
    workers' epoch equal to thread workers'; an injected inf and an
    injected NaN each skipping the step (every parameter bitwise
    unchanged, the scale halved, one overflow) with one host read in
    ``has_overflow``, and the check's reduction seeing a lone NaN in
    each floating type; the same steps in fp32 (AMP_FP32_TOL,
    AMP_FP32_REL); the card against the CPU port at 2 x 32 tokens
    (AMP_CPU); K1-f16
    and K1-bwd-f16 against their plain versions at this shape; (2) a
    synthetic CIFAR-10 through vision.CIFAR10, the augmentation
    (card against the CPU port) and 4 process workers into ResNet-18's
    stem and first stage under AMP, 2 SGD steps (float16 convolutions,
    fp32 BatchNorm); (3) every registered optimizer on the FFN pair,
    card against the CPU port in fp32 and float16 with fp32 masters,
    through an Updater, and the Trainer's (fused) update bitwise against
    one update_multi_precision a parameter. AMP is off again when the
    phase ends."""
    import tempfile
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    saved = dict(mx.amp._state)
    c = AMP_BERT
    with tempfile.TemporaryDirectory() as tmp:
        # both loaders' workers start first: each takes seconds to import
        # the package, while the BERT model builds
        dataset = _bert_data(mx)
        bert_loader = mx.gluon.data.DataLoader(
            dataset, batch_size=c["batch"], shuffle=True,
            num_workers=c["workers"], thread_pool=False, pin_memory=True)
        raw, cifar_loader = _cifar_loader(mx, tmp)
        for ld in (bert_loader, cifar_loader):
            ld._ensure_proc_pool()
        try:
            bert = _amp_bert_part(torch, mx, card_name, dataset,
                                  bert_loader)
            cifar = _amp_cifar_part(torch, mx, card_name, raw, cifar_loader)
        finally:
            mx.amp._state.clear()
            mx.amp._state.update(saved)
            bert_loader.close()
            cifar_loader.close()
    sweep = _amp_sweep(torch, mx, card_name)
    gc.collect()
    torch.cuda.empty_cache()
    emit("amp_data", card=card_name, seconds=time.perf_counter() - t0)
    return {"launches": bert["launches"], "bert": bert, "cifar": cifar,
            "sweep": sweep}


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
     "mxnet_tpu/ops/quantized.py:151", "dequant_matmul_pallas (M <= 8: "
     "the GEMV)", "k4"),
    ("dequant_matmul_m32", "dequant_matmul.cu",
     "mxnet_tpu/ops/quantized.py:151", "dequant_matmul_pallas (9-32 rows, "
     "prefill chunks: the tile kernel)", "k4m32"),
    ("dequant_matmul_m64", "dequant_matmul.cu",
     "mxnet_tpu/ops/quantized.py:151", "dequant_matmul_pallas (over 32 "
     "rows, the speculative verify: the tile kernel)", "k4m64"),
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
    card = phase_env(torch)
    phase_build()
    timer = Timer(torch)
    k1 = phase_flash(torch, timer)
    k2, k2i = phase_decode(torch, timer)
    k3, k3i = phase_paged_decode(torch, timer)
    k4 = phase_dequant(torch, timer)
    k5 = phase_rtc(torch, timer)
    k5t = phase_rtc_triton(torch, timer)
    kernel_res = {"k1": k1, "k2": k2, "k2i": k2i, "k3": k3, "k3i": k3i,
                  **k4}
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
    phases = {"custom_op": phase_custom_op(torch),
              "numpy": phase_numpy(torch, card),
              "npx": phase_npx(torch, card),
              "gluon": phase_gluon(torch, card),
              "rnn": phase_rnn(torch, card),
              "amp_data": phase_amp_data(torch, card)}
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
                                   "pair_ms", "pair_ms_device", "library",
                                   "timed", "m512")
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
    by_phase = {ph: r["launches"].get("rtc_triton", 0)
                for ph, r in phases.items()}
    rows.append({
        "name": "rtc_triton", "route": "triton",
        "compiler": f"triton {k5t['triton']}",
        "source": "mxnet_tpu_torch/rtc.py",
        "user_source": "chip_smoke.py RTC_TRITON_SOURCE",
        "replaces": "mxnet_tpu/rtc.py:56",
        "replaces_function": "Kernel._build_call (pl.pallas_call :75), "
                             "reached by PallasModule (:122) with Python "
                             "source",
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        "max_abs_err": k5t["max_abs_err"], "timed": k5t["timed"],
        "ms": k5t["kernel_ms"], **{k: k5t[k] for k in TIMING_KEYS},
        "bound_ms": k5t["bound_ms"], "bound_by": k5t["bound_by"]})
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
