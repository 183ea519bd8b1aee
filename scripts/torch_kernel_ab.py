#!/usr/bin/env python3
"""Measurements of the port's kernels on the card that
``chip_smoke.py`` does not make.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 scripts/torch_kernel_ab.py --other-csrc DIR [--other-csrc DIR2]
                                       [--rounds 2]

e.g. with the parent commit unpacked into ``_tree/`` (``.gitignore``
lists it): ``git archive HEAD~1 | tar -x -C _tree`` and
``--other-csrc _tree/mxnet_tpu_torch/csrc``.

1. ``flash_attention_ab`` and ``flash_attention_bf16_ab``: K1 (flash
   prefill), its fp32 and its bf16 instance, built from ``DIR`` —
   another revision's ``csrc/``, e.g. a ``git archive`` of an earlier
   commit — against K1 built from this checkout, through the same
   wrapper (the C entry point swapped), at ``chip_smoke.py``'s prefill
   shape (1, 12, 512, 64), causal, on strided views, and at the full
   context (1, 12, 1024, 64); the bf16 one with SDPA on the same bf16
   tensors beside it (device ms and kernel-only µs).
   ``chip_smoke.Timer``: enqueue-inclusive and device-only ms.
2. ``dequant_matmul_ab``: K4 from ``DIR`` against this checkout's, at
   ``chip_smoke.py``'s shapes (one GPT-2-small layer's six projections
   at M = 1, 8, 32, 40 and 512, L2 flushed before every call), ``bias=None``
   (an earlier entry point may have no bias argument). Both are called
   by one thin caller (output allocation, pointers, the C call), each
   with its own revision's arguments. Both A/Bs add the kernels' own
   run time from ``torch.profiler`` (``kernel_us_profiler``: no launch
   latency, which the timer's device interval includes).
3. ``decode_attention_ab``, ``paged_decode_attention_ab`` and their
   ``_int8`` siblings: K2 (dense decode attention) and K3 (paged), each
   instance, from ``DIR`` against this checkout's, at
   ``chip_smoke.py``'s decode shapes (8, 12, 1024, 64; K3 over a pool
   of each slot's pages in order, page 16, P_max 64), each kernel's own
   smoke lengths (K2 [0, 1, 63, 64, 65, 500, 1023, 1024], K3 [0, 1, 15,
   16, 17, 500, 1023, 1024]) and NaN garbage past them (int8: the
   values quantized with their amax scales), through the same Python
   wrapper and ``chip_smoke.Timer`` (L2 flushed), plus the kernels' own
   run time from ``torch.profiler`` and the device time with L2 left
   warm (``ms_device_warm``). Both also run four query rows a slot
   (``sq=4``), K3 the peek (one slot, B = 1, length 500). Both
   must take the same C interface; an instance the other revision
   lacks is skipped.

Every A/B runs the two in the order other, this, this, other,
``--rounds`` times, in one process, and checks first that the two
builds agree.

4. ``int8_dense_vs_paged``: the same int8 K/V (the decode shape, the
   same lengths) through K2's int8 instance over the dense cache and
   through K3's over a pool holding each slot's rows in its own pages
   in order (per-page scales equal to the slot's), beside the fp32
   instances on the same values, and K2 (both instances) over a cache
   whose rows per (slot, head) are padded from 1024 to 1040, so that no
   (slot, head) starts at a multiple of 64 KiB: device ms, in turns.
5. ``wrapper_host_cost``: host microseconds per call of K4's wrapper
   (``dequant_matmul`` at M = 8, N = K = 768) taken apart: the whole
   wrapper, its pieces (device context and stream, output allocation,
   pointers), the bare ctypes call of K4's entry point, and a
   launch-API probe compiled here: an empty kernel with K4's arguments
   and grid launched through ``<<<>>>``, through ``cudaLaunchKernelEx``
   with no attribute and with K4's cluster attribute, and with a
   compile-time ``__cluster_dims__``, beside a C function that launches
   nothing (the ctypes call alone). Host time is read while the card
   sleeps, so the launch queue never pushes back. ``launch_floor``:
   the device timer's floor, the empty kernel alone in the interval
   beside K4 (with and without the L2 flush).
6. ``wrapper_host_us``: host microseconds per call of K1's and K4's
   public wrappers (``flash_attention_fwd`` at the prefill shape,
   ``dequant_matmul`` at M = 8, N = K = 768), for this checkout and,
   where ``DIR`` sits in a whole package tree (``DIR/../..`` holds
   ``mxnet_tpu_torch``), for that tree's wrappers in a child process
   (``--host-probe ROOT``).

7. ``flash_attention_bwd_ab``: K1-bwd's fp32, bf16 and float16 instances
   (the dq launch, the dk/dv launch and the pair) from ``DIR`` against
   this checkout's, through the same wrapper, at ``chip_smoke.py``'s
   BWD_SHAPE (8, 12, 1024, 64), causal, strided, with the backward of
   ``scaled_dot_product_attention`` on the same tensors beside them
   (device ms, kernel-only µs).

8. ``bf16_kernel_us``: this checkout's bf16 and float16 instances
   alone: K1-bf16 and K1-f16 at the prefill shape (and SDPA on the same
   16-bit tensors), K1-f16 also at ``chip_smoke.py``'s ``amp_data``
   shape, (8, 12, 512, 64) non-causal, K2 and K3 at the decode shapes
   above over 16-bit caches, each with a 16-bit and an fp32 q: the
   kernels' own run time from ``torch.profiler`` and the device ms with
   L2 flushed and left warm.

``--only NAME`` (repeatable) runs just those: ``flash``, ``dequant``,
``decode``, ``paged``, ``int8_dense_vs_paged``, ``wrapper_cost``,
``wrapper_host_us``, ``bf16``, ``flash_bwd``.

The first line printed is ``nvidia-smi``'s name and power limit; each
measurement prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package under test: this checkout's, or with --host-probe ROOT2
# another tree's (chip_smoke.py is always this checkout's)
PKG_ROOT = (os.path.abspath(sys.argv[sys.argv.index("--host-probe") + 1])
            if "--host-probe" in sys.argv else ROOT)
sys.path.insert(0, PKG_ROOT)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from mxnet_tpu_torch import _build  # noqa: E402
from mxnet_tpu_torch.ops import attention as at  # noqa: E402
from mxnet_tpu_torch.ops import quantized as qz  # noqa: E402

#: an empty kernel with K4's arguments, launched four ways (see above)
PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void probe(const float*, const signed char*, const float*, float*,
                      int, int, int) {}
__global__ void __cluster_dims__(1, 1, 8)
probe_fixed(const float*, const signed char*, const float*, float*, int, int,
            int) {}
#define ARGS const float* x, const signed char* w, const float* s, float* o, \
    int M, int N, int K, void* stream
#define GRID dim3((N + 31) / 32, 1, 8)
extern "C" {
int probe_none(ARGS) { return 0; }
int probe_chevron(ARGS) {
  probe<<<GRID, 256, 0, (cudaStream_t)stream>>>(x, w, s, o, M, N, K);
  return cudaGetLastError();
}
static int launch_ex(ARGS, bool cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = GRID;
  cfg.blockDim = dim3(256);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 8;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, probe, x, w, s, o, M, N, K);
  return e != cudaSuccess ? e : cudaGetLastError();
}
int probe_ex(ARGS) { return launch_ex(x, w, s, o, M, N, K, stream, false); }
int probe_ex_cluster(ARGS) {
  return launch_ex(x, w, s, o, M, N, K, stream, true);
}
int probe_fixed_cluster(ARGS) {
  probe_fixed<<<GRID, 256, 0, (cudaStream_t)stream>>>(x, w, s, o, M, N, K);
  return cudaGetLastError();
}
}
"""


def _compile(src_path, include, tag):
    """nvcc ``src_path`` with the port's flags into ``_build/``; returns
    the loaded library. Named by a hash of the source and the headers
    beside it, so two trees that differ only in a header build apart."""
    h = hashlib.sha256()
    for p in (src_path, *sorted(
            os.path.join(include, n) for n in os.listdir(include)
            if n.endswith(".cuh"))):
        with open(p, "rb") as f:
            h.update(f.read())
    h = h.hexdigest()[:16]
    _build.BUILD_DIR.mkdir(exist_ok=True)
    lib = _build.BUILD_DIR / f"lib{tag}-{h}.so"
    if not lib.exists():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
               str(lib), str(src_path)]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


#: the lengths of chip_smoke.py's K2 and K3 phases
DENSE_LENGTHS = [0, 1, 63, 64, 65, 500, 1023, 1024]
PAGED_LENGTHS = [0, 1, 15, 16, 17, 500, 1023, 1024]


def _decode_inputs(rng, lengths=DENSE_LENGTHS):
    """The decode shape's q, NaN-tailed K/V, lengths and live mask."""
    b, h, s, d = 8, 12, 1024, 64
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    k, v = (cs._rand(torch, rng, b, h, s, d) for _ in range(2))
    live = (torch.arange(s, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, :, None]
    nan = torch.tensor(float("nan"), device="cuda")
    kn, vn = torch.where(live, k, nan), torch.where(live, v, nan)
    q = cs._split_view(torch, rng, b, 1, h, d)
    return q, kn, vn, lens, lengths, live


def _to_pool(x, ps):
    """(B, H, S, D) -> a (1 + B * S / ps, H, ps, D) pool holding slot
    b's page p at 1 + b * S / ps + p (page 0 scrap), and its table."""
    b, h, s, d = x.shape
    pool = x.reshape(b, h, s // ps, ps, d).transpose(1, 2).reshape(
        b * s // ps, h, ps, d)
    pool = torch.cat([torch.zeros_like(pool[:1]), pool]).contiguous()
    table = (1 + torch.arange(b * s // ps, device=x.device, dtype=torch.int32)
             ).reshape(b, s // ps)
    return pool, table


def _int8_inputs(kn, vn, ps=16):
    """int8 K/V with (B, H) scales from the NaN-tailed values (the
    garbage zeroed first), and the same values as a pool of each slot's
    pages in order with per-page scales."""
    kz, vz = torch.nan_to_num(kn), torch.nan_to_num(vn)
    ks, vs = qz.kv_scale(kz, (2, 3)), qz.kv_scale(vz, (2, 3))
    kq = qz.kv_quantize(kz, ks[:, :, None, None])
    vq = qz.kv_quantize(vz, vs[:, :, None, None])
    kq_p, table = _to_pool(kq, ps)
    vq_p, _ = _to_pool(vq, ps)
    n_pp = kq.shape[2] // ps                   # pages per slot
    pad = torch.zeros_like(ks[:1])
    ks_p, vs_p = (torch.cat([pad, sc.repeat_interleave(n_pp, dim=0)])
                  .contiguous() for sc in (ks, vs))
    return dict(kz=kz, vz=vz, kq=kq, vq=vq, ks=ks, vs=vs, kq_p=kq_p,
                vq_p=vq_p, ks_p=ks_p, vs_p=vs_p, table=table)


def kernel_ab(timer, other_csrc, rounds, paged, int8):
    """K2 (or K3), fp32 (or int8) instance, from ``other_csrc`` against
    this checkout's, same wrapper; skipped when the other revision has
    no such instance."""
    rng = np.random.RandomState(1)
    q, kn, vn, lens, lengths, _live = _decode_inputs(
        rng, PAGED_LENGTHS if paged else DENSE_LENGTHS)
    base = "paged_decode_attention" if paged else "decode_attention"
    name = base + ("_int8" if int8 else "")
    argtypes = {(False, False): at._DECODE_ARGTYPES,
                (False, True): at._DECODE_INT8_ARGTYPES,
                (True, False): at._PAGED_ARGTYPES,
                (True, True): at._PAGED_INT8_ARGTYPES}[(paged, int8)]
    x = _int8_inputs(kn, vn)
    kp, table = _to_pool(kn, 16)
    vp, _ = _to_pool(vn, 16)

    def call(q, lens, table):
        return {
            (False, False): lambda: at.decode_attention(q, kn, vn, lens),
            (False, True): lambda: at.decode_attention(
                q, x["kq"], x["vq"], lens, None, x["ks"], x["vs"]),
            (True, False): lambda: at.paged_decode_attention(
                q, kp, vp, table, lens),
            (True, True): lambda: at.paged_decode_attention(
                q, x["kq_p"], x["vq_p"], table, lens, None, x["ks_p"],
                x["vs_p"]),
        }[(paged, int8)]
    q4 = cs._split_view(torch, rng, 8, 4, 12, 64)
    variants = [("sq=1", call(q, lens, table)),
                ("sq=4", call(q4, lens, table))]
    if paged:
        variants += [("peek b=1 len=500", call(
                         q[5:6], lens[5:6].contiguous(),
                         table[5:6].contiguous()))]
    key = (base, f"mxtt_{name}")
    this_fn = _build.function(*key, argtypes)
    other = _compile(os.path.join(other_csrc, f"{base}.cu"), other_csrc,
                     f"{base}-other")
    if not hasattr(other, f"mxtt_{name}"):
        cs.emit(f"{name}_ab", other_csrc=other_csrc,
                skipped=f"no mxtt_{name} in the other revision")
        return
    other_fn = getattr(other, f"mxtt_{name}")
    other_fn.restype = ctypes.c_int
    other_fn.argtypes = argtypes
    fns = {"other": other_fn, "this": this_fn}
    for case, fn in variants:
        def run(which, fn=fn):
            _build._fns[key] = fns[which]
            return fn()

        ref = run("this")
        diff = float((run("other") - ref).abs().max())
        cs.check(diff <= cs.OUT_TOL,
                 f"the two {name} builds differ by {diff} ({case})")
        times = _turns(timer, {w: (lambda w=w: run(w)) for w in fns},
                       rounds, True)
        kernel_us = {w: _kernel_us(lambda w=w: run(w),
                                   "paged_" if paged else "decode",
                                   flush=timer.buf.zero_)
                     for w in fns}
        # the same with the inputs and the kernel's code left in L2
        warm = {w: timer(lambda w=w: run(w), device=True) for w in fns}
        _build._fns[key] = this_fn
        cs.emit(f"{name}_ab", case=case, shape=[8, 12, 1024, 64],
                lengths=lengths, other_csrc=other_csrc, max_abs_diff=diff,
                order="other, this, this, other", rounds=rounds,
                kernel_us_profiler=kernel_us, ms_device_warm=warm,
                **_summary(times))


def _turns(timer, calls, rounds, flush):
    """``{which: [{"ms", "ms_device"}, ...]}`` over ``rounds`` rounds of
    other, this, this, other."""
    times = {"other": [], "this": []}
    for _ in range(rounds):
        for which in ("other", "this", "this", "other"):
            ms, dev = timer.both(calls[which], flush=flush)
            times[which].append({"ms": ms, "ms_device": dev})
    return times


def _summary(times):
    return {which: {"ms_median": float(np.median([t["ms"] for t in ts])),
                    "ms_device_median": float(np.median(
                        [t["ms_device"] for t in ts])),
                    "runs": ts}
            for which, ts in times.items()}


def _kernel_us(fn, name_part, reps=10, flush=None):
    """Median µs per call of the device kernels whose name holds
    ``name_part``, from ``torch.profiler``'s kernel intervals (the
    kernels' own run time: no launch latency, no event); ``flush`` runs
    between calls, outside the sum."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    kern = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name_part in e.name]
    if not kern:
        return None                     # the profiler saw no kernel
    return float(sum(kern) / reps)


def bf16_kernel_us(timer):
    """Kernel-only µs (profiler) and device ms of the bf16 and float16
    instances at ``chip_smoke.py``'s shapes, beside SDPA's for K1; K1-f16
    also at the ``amp_data`` phase's (8, 12, 512, 64) non-causal."""
    import torch.nn.functional as F
    for tag, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        rng = np.random.RandomState(5)
        q, k, v = (cs._split_view(torch, rng, 1, 512, 12, 64).to(dt)
                   for _ in range(3))
        runs = {f"flash_attention_fwd_{tag}": (
                    lambda q=q, k=k, v=v: at.flash_attention_fwd(
                        q, k, v, True), "flash_fwd"),
                f"sdpa_{tag}": (
                    lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), "")}
        if dt == torch.float16:
            qa, ka, va = (cs._split_view(torch, rng, 8, 512, 12, 64).to(dt)
                          for _ in range(3))
            runs["flash_attention_fwd_f16 amp_data"] = (
                lambda: at.flash_attention_fwd(qa, ka, va, False),
                "flash_fwd")
            runs["sdpa_f16 amp_data"] = (
                lambda: F.scaled_dot_product_attention(qa, ka, va), "")
        qd, kn, vn, lens, _, _ = _decode_inputs(rng)
        kb, vb = kn.to(dt), vn.to(dt)
        qp, kp, vp, plens, _, _ = _decode_inputs(rng, PAGED_LENGTHS)
        kpb, table = _to_pool(kp.to(dt), 16)
        vpb, _ = _to_pool(vp.to(dt), 16)
        for qtag, qq, qpp in ((f"q_{tag}", qd.to(dt), qp.to(dt)),
                              ("q_fp32", qd, qp)):
            runs[f"decode_attention_{tag} {qtag}"] = (
                lambda qq=qq, kb=kb, vb=vb, lens=lens: at.decode_attention(
                    qq, kb, vb, lens), "decode")
            runs[f"paged_decode_attention_{tag} {qtag}"] = (
                lambda qpp=qpp, kpb=kpb, vpb=vpb, table=table, plens=plens:
                at.paged_decode_attention(qpp, kpb, vpb, table, plens),
                "paged_")
        for name, (fn, part) in runs.items():
            # SDPA's kernels go by several names: every kernel of its
            # call counts, so no flush runs inside its profile
            cs.emit("bf16_kernel_us", kernel=name,
                    kernel_us_profiler=_kernel_us(
                        fn, part, flush=timer.buf.zero_ if part else None),
                    ms_device=timer(fn, flush=True, device=True),
                    ms_device_warm=timer(fn, device=True))


#: K1's entry points: the fp32 instance and the bf16 one (the input type)
FLASH_ENTRIES = (("mxtt_flash_attention_fwd", torch.float32),
                 ("mxtt_flash_attention_fwd_bf16", torch.bfloat16))


def flash_ab(timer, other_csrc, rounds):
    """K1's fp32 and bf16 instances from ``other_csrc`` against this
    checkout's, through the same wrapper (the cached entry point
    swapped), prefill shape and full context; the bf16 one beside SDPA
    on the same bf16 tensors. An entry point the other revision lacks is
    skipped."""
    import torch.nn.functional as F
    other = _compile(os.path.join(other_csrc, "flash_attention.cu"),
                     other_csrc, "flash_attention-other")
    for sym, dt in FLASH_ENTRIES:
        tag = ("flash_attention_ab" if dt == torch.float32
               else "flash_attention_bf16_ab")
        if not hasattr(other, sym):
            cs.emit(tag, other_csrc=other_csrc,
                    skipped=f"no {sym} in the other revision")
            continue
        other_fn = getattr(other, sym)
        other_fn.restype = ctypes.c_int
        other_fn.argtypes = at._FLASH_ARGTYPES
        key = ("flash_attention", sym)
        fns = {"other": other_fn,
               "this": _build.function(*key, at._FLASH_ARGTYPES)}
        rng = np.random.RandomState(3)
        for s in (512, 1024):
            q, k, v = (cs._split_view(torch, rng, 1, s, 12, 64).to(dt)
                       for _ in range(3))

            def run(which):
                _build._fns[key] = fns[which]
                return at.flash_attention_fwd(q, k, v, True)
            ref, ref_lse = run("this")
            out, lse = run("other")
            diff = float((out.float() - ref.float()).abs().max())
            # fp32: both within OUT_TOL of the plain version; bf16: both
            # round fp32 results that differ by fp32 rounding
            tol = (2 * cs.OUT_TOL if dt == torch.float32
                   else cs._bf16_err(out, ref)[1])
            cs.check(diff <= tol, f"the two {sym} builds differ by {diff}")
            times = _turns(timer, {w: (lambda w=w: run(w)) for w in fns},
                           rounds, False)
            kernel_us = {w: _kernel_us(lambda w=w: run(w), "flash_fwd")
                         for w in fns}
            _build._fns[key] = fns["this"]
            extra = {}
            if dt == torch.bfloat16:
                def sdpa():
                    return F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True)
                extra["sdpa_bf16"] = {
                    "ms_device": timer(sdpa, device=True),
                    "kernel_us_profiler": _kernel_us(sdpa, "")}
            cs.emit(tag, shape=[1, 12, s, 64], causal=True, strided=True,
                    other_csrc=other_csrc, max_abs_diff=diff,
                    max_abs_diff_lse=float((lse - ref_lse).abs().max()),
                    order="other, this, this, other", rounds=rounds,
                    kernel_us_profiler=kernel_us, **extra,
                    **_summary(times))


def flash_bwd_ab(timer, other_csrc, rounds):
    """K1-bwd's fp32, bf16 and float16 instances (both launches) from
    ``other_csrc`` against this checkout's, through the same wrapper (the
    cached entry points swapped), at ``chip_smoke.py``'s BWD_SHAPE,
    causal, on the head split's strided views: device ms of each launch
    and of the pair in turns, kernel-only µs (profiler), and the backward
    of ``scaled_dot_product_attention`` on the same tensors beside them.
    The two builds must agree within twice the instance's BWD_TOL of
    max(1, max|g|) (each is within BWD_TOL of the plain version there)."""
    import torch.nn.functional as F
    other = _compile(os.path.join(other_csrc, "flash_attention_bwd.cu"),
                     other_csrc, "flash_attention_bwd-other")
    b, h, s, d = cs.BWD_SHAPE
    sc = 1.0 / np.sqrt(d)
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                    ("f16", torch.float16)):
        sfx = "" if tag == "fp32" else f"_{tag}"
        syms = {kind: f"mxtt_flash_attention_bwd_{kind}{sfx}"
                for kind in ("dq", "dkv")}
        if not all(hasattr(other, sym) for sym in syms.values()):
            cs.emit("flash_attention_bwd_ab", instance=tag,
                    other_csrc=other_csrc,
                    skipped=f"no {tag} K1-bwd in the other revision")
            continue
        fns = {}
        for which, lib in (("other", other), ("this", None)):
            fns[which] = {}
            for kind, sym in syms.items():
                if lib is None:
                    fn = _build.function("flash_attention_bwd", sym,
                                         at._FLASH_BWD_ARGTYPES)
                else:
                    fn = getattr(lib, sym)
                    fn.restype = ctypes.c_int
                    fn.argtypes = at._FLASH_BWD_ARGTYPES
                fns[which][kind] = fn
        rng = np.random.RandomState(20)
        q, k, v, do = (cs._split_view(torch, rng, b, s, h, d).to(dt)
                       for _ in range(4))
        out, lse = at.flash_attention_fwd(q, k, v, True)

        def use(which):
            for kind, sym in syms.items():
                _build._fns[("flash_attention_bwd", sym)] = fns[which][kind]

        def dq_call(which):
            use(which)
            return at._flash_bwd_launch("dq", q, k, v, out, lse, do, True,
                                        sc, s)

        def pair(which):
            dq, delta = dq_call(which)
            dk, dv = at._flash_bwd_launch("dkv", q, k, v, out, lse, do, True,
                                          sc, s, delta)
            return dq, dk, dv
        got = {w: pair(w) for w in ("this", "other")}
        tol = 2 * cs.BWD_TOL[sfx[1:]]
        diff = {}
        for i, name in enumerate(("dq", "dk", "dv")):
            a, o = got["this"][i].float(), got["other"][i].float()
            diff[name] = float((a - o).abs().max()) / max(
                1.0, float(o.abs().max()))
        cs.check(max(diff.values()) <= tol,
                 f"the two {tag} K1-bwd builds differ by {diff}")
        _, delta = dq_call("this")
        calls = {
            "dq": lambda w: dq_call(w),
            "dkv": lambda w: (use(w), at._flash_bwd_launch(
                "dkv", q, k, v, out, lse, do, True, sc, s, delta)),
            "pair": pair}
        res = {}
        for kind, call in calls.items():
            times = _turns(timer, {w: (lambda w=w: call(w))
                                   for w in ("other", "this")},
                           rounds, False)
            res[kind] = {**_summary(times), "kernel_us_profiler": {
                w: _kernel_us(lambda w=w: call(w), "flash_bwd")
                for w in ("other", "this")}}
        use("this")
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

        def sdpa_bwd():
            return torch.autograd.grad(o_lib, (qs, ks, vs), do,
                                       retain_graph=True)
        cs.emit("flash_attention_bwd_ab", instance=tag,
                shape=list(cs.BWD_SHAPE), causal=True, strided=True,
                other_csrc=other_csrc, max_rel_diff=diff,
                order="other, this, this, other", rounds=rounds, **res,
                sdpa_bwd={"ms_device": timer(sdpa_bwd, device=True),
                          "kernel_us_profiler": _kernel_us(sdpa_bwd, "")})


#: K4's entry point before it took a bias: x, wq, scales, out; M, N, K;
#: stream
_DEQUANT_ARGTYPES_NO_BIAS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def dequant_ab(timer, other_csrc, rounds):
    """K4 from ``other_csrc`` against this checkout's at one layer's six
    projections, M = 1 and 8 (the GEMV), 32, 40 and 512 (the tile
    kernel), bias=None, through one thin caller."""
    src = os.path.join(other_csrc, "dequant_matmul.cu")
    with open(src) as f:
        takes_bias = "const float* bias, float* out" in f.read()
    other = _compile(src, other_csrc, "dequant_matmul-other")
    other_fn = other.mxtt_dequant_matmul
    other_fn.restype = ctypes.c_int
    other_fn.argtypes = (qz._DEQUANT_ARGTYPES if takes_bias
                         else _DEQUANT_ARGTYPES_NO_BIAS)
    this_fn = _build.function("dequant_matmul", "mxtt_dequant_matmul",
                              qz._DEQUANT_ARGTYPES)

    def caller(fn, bias_arg, x, wq, sc):
        m, k = x.shape
        n = wq.shape[0]
        ptrs = (x.data_ptr(), wq.data_ptr(), sc.data_ptr())

        def call():
            out = torch.empty((m, n), dtype=torch.float32, device="cuda")
            args = (*ptrs, *((None,) if bias_arg else ()), out.data_ptr(),
                    m, n, k)
            cs.check(_build.launch_on(x, fn, args) == 0, "K4 launch failed")
            return out
        return call

    rng = np.random.RandomState(5)
    tables = {}
    for n, k in sorted(set(cs.LAYER_PROJECTIONS)):
        w = torch.from_numpy((rng.standard_normal((n, k)) * 0.02)
                             .astype("f4")).cuda()
        tables[(n, k)] = qz.quantize_channelwise(w)
    for m in (1, 8, 32, 40, 512):
        per = {"other": {}, "this": {}}
        prof_us = {"other": 0.0, "this": 0.0}
        diff = 0.0
        for n, k in sorted(set(cs.LAYER_PROJECTIONS)):
            wq, sc = tables[(n, k)]
            x = cs._rand(torch, rng, m, k)
            calls = {"other": caller(other_fn, takes_bias, x, wq, sc),
                     "this": caller(this_fn, True, x, wq, sc)}
            ref = qz._dequant_matmul_torch(x, wq, sc)
            scale = float(ref.abs().max())
            for which in calls:
                diff = max(diff, float((calls[which]() - ref).abs().max())
                           / scale)
            times = _turns(timer, calls, rounds, True)
            for which, ts in times.items():
                per[which][(n, k)] = ts
            for which, fn in calls.items():
                us = _kernel_us(fn, "dequant", flush=timer.buf.zero_)
                if prof_us[which] is not None:
                    prof_us[which] = None if us is None else prof_us[which] + us
        cs.check(diff <= cs.DEQUANT_REL_TOL,
                 f"a K4 build is {diff} x max|ref| off the plain version")
        layer = {}
        for which, by_shape in per.items():
            runs = [{key: sum(by_shape[s][i][key]
                              for s in cs.LAYER_PROJECTIONS)
                     for key in ("ms", "ms_device")}
                    for i in range(2 * rounds)]
            layer[which] = runs
        cs.emit("dequant_matmul_ab", M=m, timed="one layer's 6 projections, "
                "summed; L2 flushed before every call", bias=None,
                other_csrc=other_csrc, other_takes_bias=takes_bias,
                max_rel_err=diff, order="other, this, this, other",
                rounds=rounds, kernel_us_profiler=prof_us,
                **_summary(layer))


def host_probe():
    """Host µs per call of K1's and K4's public wrappers, for the
    package imported from ``PKG_ROOT``."""
    rng = np.random.RandomState(6)
    q, k, v = (cs._split_view(torch, rng, 1, 512, 12, 64) for _ in range(3))
    w = torch.from_numpy((rng.standard_normal((768, 768)) * 0.02)
                         .astype("f4")).cuda()
    wq, sc = qz.quantize_channelwise(w)
    x = cs._rand(torch, rng, 8, 768)
    res = {"flash_attention_fwd": _host_us(
               lambda: at.flash_attention_fwd(q, k, v, True)),
           "dequant_matmul": _host_us(lambda: qz.dequant_matmul(x, wq, sc))}
    torch.cuda.synchronize()
    return res


def wrapper_host_us(other_csrc_list):
    """``host_probe`` for this checkout, and in a child process for each
    other revision that sits in a whole package tree."""
    cs.emit("wrapper_host_us", unit="us per call, host", tree=PKG_ROOT,
            which="this", **host_probe())
    for other in other_csrc_list:
        root = os.path.dirname(os.path.dirname(os.path.abspath(other)))
        if not os.path.isdir(os.path.join(root, "mxnet_tpu_torch", "ops")):
            continue
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--host-probe",
             root], capture_output=True, text=True, timeout=600)
        cs.check(out.returncode == 0,
                 f"host probe of {root} failed:\n{out.stderr[-2000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


def int8_dense_vs_paged(timer, rounds):
    """The same int8 values through K2-int8 (dense) and K3-int8 (a pool
    of each slot's pages in order), and the fp32 values through K2 and
    K3, device ms in turns."""
    q, kn, vn, lens, lengths, _live = _decode_inputs(
        np.random.RandomState(2))
    x = _int8_inputs(kn, vn)
    kz_p, table = _to_pool(x["kz"], 16)
    vz_p, _ = _to_pool(x["vz"], 16)

    def padded(t, extra=16):
        buf = torch.zeros((*t.shape[:2], t.shape[2] + extra, t.shape[3]),
                          dtype=t.dtype, device=t.device)
        buf[:, :, :t.shape[2]] = t
        return buf[:, :, :t.shape[2]]

    kq_x, vq_x, kz_x, vz_x = (padded(x[k]) for k in ("kq", "vq", "kz",
                                                      "vz"))
    calls = {
        "dense_int8": lambda: at.decode_attention(
            q, x["kq"], x["vq"], lens, None, x["ks"], x["vs"]),
        "dense_int8_padded": lambda: at.decode_attention(
            q, kq_x, vq_x, lens, None, x["ks"], x["vs"]),
        "dense_fp32_padded": lambda: at.decode_attention(q, kz_x, vz_x,
                                                         lens),
        "paged_int8": lambda: at.paged_decode_attention(
            q, x["kq_p"], x["vq_p"], x["table"], lens, None, x["ks_p"],
            x["vs_p"]),
        "dense_fp32": lambda: at.decode_attention(q, x["kz"], x["vz"], lens),
        "paged_fp32": lambda: at.paged_decode_attention(q, kz_p, vz_p, table,
                                                        lens),
    }
    outs = {k: fn() for k, fn in calls.items()}
    diffs = {f"{a} vs {b}": float((outs[a] - outs[b]).abs().max())
             for a, b in (("dense_int8", "paged_int8"),
                          ("dense_int8", "dense_int8_padded"),
                          ("dense_fp32", "paged_fp32"),
                          ("dense_fp32", "dense_fp32_padded"))}
    times = {k: [] for k in calls}
    order = list(calls) + list(calls)[::-1]
    for _ in range(rounds):
        for k in order:
            times[k].append(timer(calls[k], flush=True, device=True))
    cs.emit("int8_dense_vs_paged", shape=[8, 12, 1024, 64], page_size=16,
            lengths=lengths, order=order, rounds=rounds,
            max_abs_diff=diffs,
            ms_device_median={k: float(np.median(v))
                              for k, v in times.items()},
            ms_device_runs=times)


def _host_us(fn, calls=200, reps=7):
    """Median host microseconds per call of ``fn``, enqueued while the
    card sleeps (so the launch queue never blocks the host)."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)            # ~50 ms
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per))


def wrapper_cost(timer):
    """Host µs per call of K4's wrapper at M = 8, N = K = 768, apart
    (the launch probe's empty kernels take K4's arguments before it took
    a bias)."""
    rng = np.random.RandomState(4)
    m, n, k = 8, 768, 768
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.02)
                         .astype("f4")).cuda()
    wq, sc = qz.quantize_channelwise(w)
    x = cs._rand(torch, rng, m, k)
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    dev = x.device
    stream = torch.cuda.current_stream().cuda_stream
    bias = cs._rand(torch, rng, n)
    ptrs = (x.data_ptr(), wq.data_ptr(), sc.data_ptr(), out.data_ptr())
    k4 = _build.function("dequant_matmul", "mxtt_dequant_matmul",
                         qz._DEQUANT_ARGTYPES)
    k4_args = (*ptrs[:3], None, ptrs[3], m, n, k)

    def ctx_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    res = {
        "wrapper": _host_us(lambda: qz.dequant_matmul(x, wq, sc)),
        "wrapper_bias": _host_us(lambda: qz.dequant_matmul(x, wq, sc,
                                                           bias=bias)),
        "cuda_wrapper": _host_us(lambda: qz._dequant_matmul_cuda(x, wq,
                                                                 sc)),
        "device_context_and_stream": _host_us(ctx_stream),
        "raw_stream_on_current_device": _host_us(
            lambda: torch._C._cuda_getCurrentRawStream(
                torch._C._cuda_getDevice())),
        "output_alloc": _host_us(lambda: torch.empty(
            (m, n), dtype=torch.float32, device=dev)),
        "data_ptrs": _host_us(lambda: (x.data_ptr(), wq.data_ptr(),
                                       sc.data_ptr(), out.data_ptr())),
        "k4_entry_ctypes": _host_us(lambda: k4(*k4_args, stream)),
        "k4_launch_on": _host_us(lambda: _build.launch_on(x, k4, k4_args)),
    }
    src = _build.BUILD_DIR / "launch_probe.cu"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src.write_text(PROBE_SRC)
    probe = _compile(str(src), _build.CSRC, "launch_probe")
    for name in ("probe_none", "probe_chevron", "probe_ex",
                 "probe_ex_cluster", "probe_fixed_cluster"):
        fn = getattr(probe, name)
        fn.restype = ctypes.c_int
        fn.argtypes = _DEQUANT_ARGTYPES_NO_BIAS
        cs.check(fn(*ptrs, m, n, k, stream) == 0, f"{name} failed")
        res[name] = _host_us(lambda: fn(*ptrs, m, n, k, stream))
    torch.cuda.synchronize()
    cs.emit("wrapper_host_cost", unit="us per call, host", M=m, N=n, K=k,
            **res)
    # the device timer's floor: the empty kernel with K4's grid, and K4
    # itself, each alone in the interval (chip_smoke.Timer, device=True)
    empty = probe.probe_chevron
    floor = {}
    for flush in (False, True):
        tag = "_flushed" if flush else ""
        floor["empty_kernel" + tag] = timer(
            lambda: empty(*ptrs, m, n, k, stream), flush=flush, device=True)
        floor["k4" + tag] = timer(lambda: qz.dequant_matmul(x, wq, sc),
                                  flush=flush, device=True)
    cs.emit("launch_floor", unit="ms per call, device", M=m, N=n, K=k,
            grid="K4's parent grid: (N / 32, 1, 8) x 256 threads", **floor)


#: the measurements --only selects from
ONLY = ("flash", "dequant", "decode", "paged", "int8_dense_vs_paged",
        "wrapper_cost", "wrapper_host_us", "bf16", "flash_bwd")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other-csrc", action="append", default=[],
                    help="another revision's mxnet_tpu_torch/csrc/ "
                         "(repeat for several)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", action="append", choices=ONLY,
                    help="run only this measurement (repeatable)")
    ap.add_argument("--host-probe", metavar="ROOT",
                    help="only print the host cost of the wrappers of the "
                         "package under ROOT")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.host_probe:
        _build.build_all()
        cs.emit("wrapper_host_us", unit="us per call, host", tree=PKG_ROOT,
                which="other", **host_probe())
        return 0
    if not args.other_csrc:
        ap.error("--other-csrc is required")
    cs.phase_env(torch)
    _build.build_all()
    timer = cs.Timer(torch)
    only = set(args.only or ONLY)
    for other in args.other_csrc:
        other = os.path.abspath(other)
        if "flash" in only:
            flash_ab(timer, other, args.rounds)
        if "dequant" in only:
            dequant_ab(timer, other, args.rounds)
        if "flash_bwd" in only:
            flash_bwd_ab(timer, other, args.rounds)
        for paged in (False, True):
            if ("paged" if paged else "decode") in only:
                for int8 in (False, True):
                    kernel_ab(timer, other, args.rounds, paged, int8)
    if "int8_dense_vs_paged" in only:
        int8_dense_vs_paged(timer, args.rounds)
    if "wrapper_cost" in only:
        wrapper_cost(timer)
    if "wrapper_host_us" in only:
        wrapper_host_us(args.other_csrc)
    if "bf16" in only:
        bf16_kernel_us(timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
