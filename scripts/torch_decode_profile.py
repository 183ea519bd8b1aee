#!/usr/bin/env python3
"""Where the port's generation time goes on the card: one decode step
and one prefill of ``mxnet_tpu_torch`` at GPT-2-small widths, on the
dense fp32 cache, the dense int8 KV cache, the dense bf16 model over a
bf16 cache (one step, and one ``decode_multi`` tick of 4 steps), and
the paged cache with int8 weights over an fp32, an int8 and (bf16
compute) a bf16 pool.

Run from the repository root on a machine with an NVIDIA card::

    python3 scripts/torch_decode_profile.py [--steps 20]

It builds the model that ``chip_smoke.py`` serves (vocab 50257, 768
wide, 12 layers, 12 heads, 1024 positions, random weights from seed 0),
prefills all 8 slots of a 1024-row cache with prompts of 16..512 tokens
and then runs decode steps exactly as ``GenerationEngine`` does
(``decode_step``, argmax on the card, the (8,) tokens read by the host),
and the same over an int8 KV cache (``dtype="int8"``); then, with bf16
compute armed (``cast_compute_params``), over a bf16 cache: the decode
step, a ``decode_multi`` tick of 4 steps (greedy, one host read a tick)
and a 512-token prefill. Then it arms the int8 weights
(``quantize_params``), fills a paged pool (page 16) with the same
prompts through 32-token prefill chunks, as the paged engine does, and
profiles the paged decode step (``decode_step_paged``, all 8 slots
active) over an fp32, an int8 and (bf16 compute) a bf16 pool, and one
32-token chunk. A speculative iteration as ``GenerationEngine`` runs it
at ``spec_k=4`` (a 1-layer draft holding the model's embeddings, head
and first block: ``propose_tokens``, ``verify_commit[_paged]``, the
host's read of the commit block, the draft's rollback) is profiled on
the dense fp32 cache and on the paged int8-weight pool, whole and in its
two halves (``spec_iteration*``, ``.propose``, ``.verify_commit``).
For each it prints one JSON line with:

- ``wall_ms``: host clock per step, ending in the host's read;
- ``device_busy_ms``: the union of the card's kernel intervals per step,
  from ``torch.profiler`` (null, "not measured", when the profiler
  reports no device activity), and ``busy_share`` = busy / wall;
- ``kernels_per_step`` and the kernels with the most device time.

The first line printed is ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel  # noqa: E402
from mxnet_tpu_torch import ops  # noqa: E402


def _busy(kernels):
    """Union length (us) of the kernels' [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(kernels):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(fn, n):
    """Run ``fn`` n times under the profiler; returns per-call wall ms,
    per-call device-busy ms (None if no device events), per-call kernel
    count, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kern:
        d = e.time_range.end - e.time_range.start
        by_name[e.name][0] += d
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy = _busy([(e.time_range.start, e.time_range.end) for e in kern])
    return {"wall_ms": wall,
            "device_busy_ms": busy / 1e3 / n if kern else None,
            "busy_share": (busy / 1e3 / n) / wall if kern else None,
            "kernels_per_step": len(kern) / n,
            "top_kernels": [{"name": k[:90], "ms_per_step": v[0] / 1e3 / n,
                             "launches_per_step": v[1] / n}
                            for k, v in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = GPTModel(vocab_size=50257, units=768, num_layers=12,
                     num_heads=12, max_length=1024).initialize(seed=0)
    rng = np.random.RandomState(2)
    lengths = [int(n) for n in rng.randint(16, 513, size=8)]
    prompts = [rng.randint(0, 50256, size=n).astype("i4") for n in lengths]

    def dense_step(dtype, phase, ticks=1):
        cache = model.init_cache(8, 1024, dtype=dtype)
        last = np.zeros(8, "i4")
        for slot, p in enumerate(prompts):
            sb = 1 << (len(p) - 1).bit_length()
            toks = np.zeros((1, max(sb, 8)), "i4")
            toks[0, :len(p)] = p
            lg, cache = model.prefill(toks, [len(p)], cache, slots=[slot])
            last[slot] = int(lg[0].argmax())
        state = {"toks": last}

        def decode():
            lg, _ = model.decode_step(state["toks"], cache)
            state["toks"] = lg.argmax(dim=-1).cpu().numpy().astype("i4")

        greedy = (np.full(8, ticks, "i4"), [None] * 8, np.zeros(8, "f4"),
                  np.zeros(8, "i4"), np.ones(8, "f4"), np.full(8, -1, "i4"))

        def decode_multi():
            toks, _emit, _g, _c = model.decode_multi(
                state["toks"], greedy[0], cache, ticks, *greedy[1:])
            state["toks"] = toks[:, -1].cpu().numpy().astype("i4")

        ops.reset_launch_counts()
        dec = profile(decode if ticks == 1 else decode_multi, args.steps)
        calls = args.steps + 1
        dec["kernel_launches_per_step"] = {
            k: v / calls / ticks for k, v in ops.launch_counts().items()}
        if ticks > 1:   # per decode step, beside the tick's figures
            dec["steps_per_call"] = ticks
            dec["per_step"] = {k: dec[k] / ticks for k in (
                "wall_ms", "device_busy_ms", "kernels_per_step")
                if dec[k] is not None}
        print(json.dumps({"phase": phase, "slots": 8, "cache_rows": 1024,
                          **dec}), flush=True)

    def prefill_512(phase):
        pcache = model.init_cache(1, 1024)
        ptoks = np.random.RandomState(3).randint(0, 50256, size=(1, 512)) \
            .astype("i4")

        def prefill():
            lg, _ = model.prefill(ptoks, [512], pcache, slots=[0])
            int(lg[0].argmax())

        pre = profile(prefill, max(1, args.steps // 4))
        print(json.dumps({"phase": phase, "tokens": 512, **pre}),
              flush=True)

    k_spec = 4
    draft = GPTModel(vocab_size=50257, units=768, num_layers=1,
                     num_heads=12, max_length=1024)
    mine = model.collect_params()
    for name, p in draft.collect_params().items():
        p.set_data(mine[name].data())

    def spec_iteration(phase, paged):
        """One speculative iteration of the engine over 8 decoding
        slots, after the same prefills; the draft's cache is dense."""
        dcache = draft.init_cache(8, 1024)
        if paged:
            cache = model.init_paged_cache(8, 8 * p_max + 1, ps, 1024)
        else:
            cache = model.init_cache(8, 1024)
        last = np.zeros(8, "i4")
        for slot, p in enumerate(prompts):
            toks = np.zeros((1, max(ps, 1 << (len(p) - 1).bit_length())),
                            "i4")
            toks[0, :len(p)] = p
            if paged:
                row = np.arange(1 + slot * p_max, 1 + (slot + 1) * p_max,
                                dtype="i4")
                lg, cache = model.prefill_paged(toks, len(p), slot, row,
                                                cache, fresh=True)
            else:
                lg, cache = model.prefill(toks, [len(p)], cache,
                                          slots=[slot])
            draft.prefill(toks, [len(p)], dcache, slots=[slot])
            last[slot] = int(lg[0].argmax())
        active = np.ones(8, "i4")
        verify = model.verify_commit_paged if paged else model.verify_commit
        st = {"toks": last, "dt": None}

        def propose():
            st["dt"], _ = draft.propose_tokens(st["toks"], dcache, k_spec)

        def commit():
            c, n, _ = verify(st["toks"], st["dt"], active, cache)
            blk = torch.cat((c, n[:, None]), 1).cpu().numpy()
            st["toks"] = blk[np.arange(8), blk[:, -1] - 1].astype("i4")
            return blk[:, -1]

        def iteration():
            propose()
            draft.advance_len(commit() - k_spec, dcache)

        ops.reset_launch_counts()
        it = profile(iteration, args.steps)
        it["kernel_launches_per_iteration"] = {
            k: v / (args.steps + 1) for k, v in ops.launch_counts().items()}

        it["propose"] = profile(propose, args.steps)
        # each timed propose left the draft k ahead: roll it back
        dcache["len"] -= k_spec * (args.steps + 1)
        propose()
        it["verify_commit"] = profile(commit, args.steps)
        print(json.dumps({"phase": phase, "slots": 8, "spec_k": k_spec,
                          "draft_layers": 1, **it}), flush=True)

    ps, p_max = 16, 1024 // 16
    spec_iteration("spec_iteration", paged=False)
    dense_step(None, "decode_step")
    dense_step("int8", "decode_step_int8_kv")
    prefill_512("prefill")
    model.cast_compute_params("bfloat16")
    dense_step("bfloat16", "decode_step_bf16")
    dense_step("bfloat16", "decode_multi_bf16", ticks=4)
    prefill_512("prefill_bf16")
    model.cast_compute_params(None)

    # the paged engine's step: int8 projections (K4), paged attention (K3)
    model.quantize_params()
    chunk = 32
    spec_iteration("spec_iteration_paged_int8", paged=True)

    def paged_step(dtype, phase):
        gcache = model.init_paged_cache(8, 8 * p_max + 1, ps, 1024,
                                        dtype=dtype)
        last = np.zeros(8, "i4")
        for slot, p in enumerate(prompts):
            row = np.arange(1 + slot * p_max, 1 + (slot + 1) * p_max,
                            dtype="i4")
            for pos in range(0, len(p), chunk):
                nv = min(chunk, len(p) - pos)
                toks = np.zeros((1, chunk), "i4")
                toks[0, :nv] = p[pos:pos + nv]
                lg, gcache = model.prefill_paged(toks, nv, slot, row,
                                                 gcache, start=pos)
            last[slot] = int(lg[0].argmax())
        gstate = {"toks": last}
        active = np.ones(8, "i4")

        def decode_paged():
            lg, _ = model.decode_step_paged(gstate["toks"], active, gcache)
            gstate["toks"] = lg.argmax(dim=-1).cpu().numpy().astype("i4")

        ops.reset_launch_counts()
        dec = profile(decode_paged, args.steps)
        dec["kernel_launches_per_step"] = {
            k: v / (args.steps + 1) for k, v in ops.launch_counts().items()}
        print(json.dumps({"phase": phase, "slots": 8, "page_size": ps,
                          "pool_pages": 8 * p_max + 1, **dec}), flush=True)

    paged_step(None, "decode_step_paged_int8")
    paged_step("int8", "decode_step_paged_int8_kv")
    model.cast_compute_params("bfloat16")
    paged_step("bfloat16", "decode_step_paged_int8_bf16")
    model.cast_compute_params(None)

    ccache = model.init_paged_cache(1, p_max + 1, ps, 1024)
    crow = np.arange(1, p_max + 1, dtype="i4")
    ctoks = rng.randint(0, 50256, size=(1, chunk)).astype("i4")

    def prefill_chunk():
        lg, _ = model.prefill_paged(ctoks, chunk, 0, crow, ccache,
                                    start=192)
        int(lg[0].argmax())

    pre = profile(prefill_chunk, max(1, args.steps // 4))
    print(json.dumps({"phase": "prefill_chunk_paged_int8", "tokens": chunk,
                      "start": 192, **pre}), flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
