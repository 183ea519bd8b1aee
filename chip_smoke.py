#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc/`` (nvcc,
seconds), holds each kernel against its plain PyTorch version on the
card, serves greedy generation at GPT-2-small widths through
``GenerationEngine`` and holds the engine's tokens and logits against
the same weights run on the CPU. Every phase prints one JSON line; any
failure raises (exit code != 0) and no result line is printed. The
last line is ``{"ok": true, "device": {...}}``.

Tolerances, with their reasons:
- kernel vs plain version on the same card inputs: max-abs-err of the
  attention output <= 2e-5 (fp32 throughout; the two sum in different
  orders), of the log-sum-exp <= 1e-4 (a value of ~10 in fp32 carries
  ~1e-6 per rounding, and exp/log add a few);
- card logits vs the CPU forward of the same weights: <= 1e-3 (fp32
  reduction order over 12 layers of 768-wide products and a 50257-way
  head, on two devices and two BLAS libraries);
- greedy agreement of the engine with the CPU under teacher forcing:
  >= 99%, and every disagreement on a CPU top-1 vs engine-token logit
  gap below 2e-3 (two logits each within 1e-3 can only swap when their
  gap is below 2e-3).

It imports torch, numpy and mxnet_tpu_torch only (never jax or the JAX
package). Without a CUDA device it exits with code 2 and prints no
result. ``--kernels-only`` stops after the kernel phases (a quick first
check of a kernel change) and prints no result line either.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet), used for bound_ms:
#: HBM3 bytes/s, and fp32 FLOP/s outside the tensor cores (the kernels
#: compute in full fp32 on the CUDA cores)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

OUT_TOL = 2e-5
LSE_TOL = 1e-4
LOGIT_TOL = 1e-3
AGREE_MIN = 0.99


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(n_bytes, n_flops):
    t_b, t_f = n_bytes / PEAK_BYTES_S, n_flops / PEAK_FP32_FLOPS
    return (max(t_b, t_f) * 1e3,
            "bytes" if t_b >= t_f else "operations")


class Timer:
    """Per-call CUDA-event timing: median ms over ``iters`` calls after
    ``warm`` untimed ones. ``flush`` overwrites a 64 MiB buffer before
    every timed call, so the inputs come from HBM, not the 50 MB L2
    (a decode step finds its layer's cache cold: the other 11 layers
    ran in between)."""

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=30, warm=3, flush=False):
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            if flush:
                self.buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))


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


def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, kernels=_build.build_info)


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
    # the prefill's own layout: strided views out of the head split
    sp = 512
    q, k, v = (_split_view(torch, rng, b, sp, h, d) for _ in range(3))
    check(not q.is_contiguous(), "strided case is contiguous")
    compare(q, k, v, True, None, f"strided s={sp} causal")
    emit("flash_attention_check", cases=cases)
    check(err_o <= OUT_TOL, f"K1 out max-abs-err {err_o} > {OUT_TOL}")
    check(err_l <= LSE_TOL, f"K1 lse max-abs-err {err_l} > {LSE_TOL}")

    # timing at the prefill shape (1, 12, 512, 64), causal, strided
    kernel_ms = timer(lambda: at.flash_attention_fwd(q, k, v, True))
    plain_ms = timer(lambda: at._blockwise_fwd(q, k, v, True, scale))
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    pairs = sp * (sp + 1) // 2                       # visible (q, k) pairs
    n_flops = 4 * d * b * h * pairs                  # q.k and p.v
    n_bytes = 4 * (4 * b * h * sp * d + b * h * sp)  # q, k, v, out, lse
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"max_abs_err": err_o, "max_abs_err_lse": err_l,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "shape": [b, h, sp, d]}
    emit("flash_attention", **res)
    return res


def phase_decode(torch, timer):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as at
    rng = np.random.RandomState(1)
    b, h, s, d = 8, 12, 1024, 64
    scale = 1.0 / math.sqrt(d)
    lengths = [0, 1, 63, 64, 65, 500, 1023, 1024]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    k, v = (_rand(torch, rng, b, h, s, d) for _ in range(2))
    live = (torch.arange(s, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, :, None]     # (B, 1, S, 1)
    kz, vz = k * live, v * live                # garbage rows zeroed
    nan = torch.tensor(float("nan"), device="cuda")
    kn, vn = torch.where(live, k, nan), torch.where(live, v, nan)
    cases, err = [], 0.0
    for sq in (1, 4, 5):
        q = _split_view(torch, rng, b, sq, h, d)
        out = at.decode_attention(q, kn, vn, lens)
        ref = at._decode_fwd_torch(q, kz, vz, lens, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()),
              f"K2 non-finite output with NaN past the lengths (sq={sq})")
        check(float(out[0].abs().max()) == 0.0, "K2 len=0 row not zero")
        e = float((out - ref).abs().max())
        per_slot = (out - ref).abs().amax(dim=(1, 2, 3)).tolist()
        cases.append({"case": f"sq={sq}", "out_err": e,
                      "per_slot": per_slot})
        err = max(err, e)
    emit("decode_attention_check", cases=cases)
    check(err <= OUT_TOL, f"K2 max-abs-err {err} > {OUT_TOL}")

    q = _split_view(torch, rng, b, 1, h, d)    # the decode step's layout
    mask = live[:, :, :, 0][:, :, None, :]     # (B, 1, 1, S) bool
    kernel_ms = timer(lambda: at.decode_attention(q, kn, vn, lens),
                      flush=True)
    plain_ms = timer(lambda: at._decode_fwd_torch(q, kn, vn, lens, scale),
                     flush=True)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q, kz, vz, attn_mask=mask), flush=True)
    total = sum(lengths)                        # K/V rows this data needs
    n_bytes = 4 * (2 * total * h * d + 2 * b * h * d) + 4 * b
    n_flops = 4 * d * h * total
    bound_ms, bound_by = bound(n_bytes, n_flops)
    res = {"max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "shape": [b, h, s, d], "lengths": lengths}
    emit("decode_attention", **res)
    return res


def phase_engine(torch):
    """GPT-2-small widths, 12 layers, random weights from a seed, 24
    prompts of 16..512 tokens from 4 client threads; then the CPU
    reference on the same weights."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    from mxnet_tpu_torch.ops import attention as at
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
    results, ttft, errors = [None] * n_req, [None] * n_req, []

    def client(c):
        # each client sends its 6 prompts back to back, then collects:
        # up to 24 requests queue for the 8 slots
        try:
            mine = []
            for j in range(c, n_req, 4):
                mine.append((j, time.perf_counter(), eng.submit(prompts[j])))
            for j, t, st in mine:
                results[j] = st.result(timeout=600)
                ttft[j] = (st.first_token_at - t) * 1e3
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    telemetry.reset()
    at.reset_launch_counts()           # the main path's run starts here
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in clients:
        th.start()
    for th in clients:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    launches = at.launch_counts()      # ... and ends here
    steps = int(telemetry.counter_value("serving.generate.host_syncs"))
    decode_hist = telemetry.hist_quantiles("serving.generate.decode")
    if errors:
        raise errors[0]
    check(all(r is not None for r in results), "a request did not finish")
    check(all(r.finish_reason in ("eos", "length") for r in results),
          f"finish reasons {[r.finish_reason for r in results]}")
    gen_tokens = sum(len(r.tokens) for r in results)
    check(launches["flash_attention_fwd"] >= n_layers * n_req,
          f"K1 launched {launches['flash_attention_fwd']} times")
    check(launches["decode_attention"] >= steps * n_layers > 0,
          f"K2 launched {launches['decode_attention']} times for "
          f"{steps} decode steps")
    tt = np.array(ttft)
    eng_res = {"requests": n_req, "generated_tokens": gen_tokens,
               "prompt_tokens": int(lens.sum()), "wall_s": wall,
               "tokens_per_s": gen_tokens / wall,
               "ttft_ms_p50": float(np.percentile(tt, 50)),
               "ttft_ms_p99": float(np.percentile(tt, 99)),
               "decode_steps": steps,
               "decode_step_ms_p50": decode_hist["p50"],
               "decode_step_ms_avg": decode_hist["avg"],
               "launches": launches, "init_s": init_s,
               "warmup_s": warmup_s,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
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
    return eng_res


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
    from mxnet_tpu_torch.ops import attention as at

    phase_env(torch)
    phase_build()
    timer = Timer(torch)
    k1 = phase_flash(torch, timer)
    k2 = phase_decode(torch, timer)
    if args.kernels_only:
        return 0
    eng = phase_engine(torch)
    rows = []
    for name, src, line, fn, res in (
            ("flash_attention_fwd", "flash_attention.cu", 141,
             "flash_attention_pallas", k1),
            ("decode_attention", "decode_attention.cu", 474,
             "decode_attention_pallas", k2)):
        rows.append({
            "name": name, "route": "cuda",
            "source": f"mxnet_tpu_torch/csrc/{src}",
            "replaces": f"mxnet_tpu/ops/attention.py:{line}",
            "replaces_function": fn,
            "launches": eng["launches"][name],
            "max_abs_err": res["max_abs_err"],
            "ms": res["kernel_ms"], "kernel_ms": res["kernel_ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    check(set(at.launch_counts()) == {r["name"] for r in rows},
          "a kernel of the path is missing from the kernels line")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
