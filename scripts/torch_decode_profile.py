#!/usr/bin/env python3
"""Where the port's generation time goes on the card: one decode step
and one prefill of ``mxnet_tpu_torch`` at GPT-2-small widths.

Run from the repository root on a machine with an NVIDIA card::

    python3 scripts/torch_decode_profile.py [--steps 20]

It builds the model that ``chip_smoke.py`` serves (vocab 50257, 768
wide, 12 layers, 12 heads, 1024 positions, random weights from seed 0),
prefills all 8 slots of a 1024-row cache with prompts of 16..512 tokens
and then runs decode steps exactly as ``GenerationEngine`` does
(``decode_step``, argmax on the card, the (8,) tokens read by the host).
For the decode step and for one 512-token prefill it prints one JSON
line each with:

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
from mxnet_tpu_torch.ops import attention as at  # noqa: E402


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
    cache = model.init_cache(8, 1024)
    last = np.zeros(8, "i4")
    for slot in range(8):
        n = int(rng.randint(16, 513))
        sb = 1 << (n - 1).bit_length()
        toks = np.zeros((1, max(sb, 8)), "i4")
        toks[0, :n] = rng.randint(0, 50256, size=n)
        lg, cache = model.prefill(toks, [n], cache, slots=[slot])
        last[slot] = int(lg[0].argmax())
    state = {"toks": last}

    def decode():
        lg, _ = model.decode_step(state["toks"], cache)
        state["toks"] = lg.argmax(dim=-1).cpu().numpy().astype("i4")

    at.reset_launch_counts()
    dec = profile(decode, args.steps)
    dec["attention_launches_per_step"] = {
        k: v / (args.steps + 1) for k, v in at.launch_counts().items()}
    print(json.dumps({"phase": "decode_step", "slots": 8,
                      "cache_rows": 1024, **dec}), flush=True)

    pcache = model.init_cache(1, 1024)
    ptoks = rng.randint(0, 50256, size=(1, 512)).astype("i4")

    def prefill():
        lg, _ = model.prefill(ptoks, [512], pcache, slots=[0])
        int(lg[0].argmax())

    pre = profile(prefill, max(1, args.steps // 4))
    print(json.dumps({"phase": "prefill", "tokens": 512, **pre}),
          flush=True)
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
