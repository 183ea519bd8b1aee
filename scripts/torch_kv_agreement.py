#!/usr/bin/env python3
"""How far an int8 KV cache moves a GPT-2-small-width model's greedy
choices: int8 KV against an fp32 KV, both with int8 weights.

Run from the repository root (``--device cpu`` at a cut depth; the full
12 layers belong on the card)::

    python3 scripts/torch_kv_agreement.py --layers 2 --device cpu

It builds the model ``chip_smoke.py`` serves (vocab 50257, 768 wide,
12 heads, 1024 positions, random weights from seed 0) at ``--layers``
depth with int8 weights, and for 3 prompts (a 192-token system prompt
and a 40-, 70- or 100-token tail) generates 48 greedy tokens over an
int8 paged pool (page 16, 32-token prefill chunks). It then replays
each request teacher-forced on those tokens over an int8 and over an
fp32 pool and prints one JSON line: the per-step logit max-abs-err of
the two, and how often the fp32-KV argmax is the int8-KV token.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel  # noqa: E402

PS, CHUNK, S_MAX = 16, 32, 1024


def _prefill(model, prompt, cap, kv_dtype):
    cache = model.init_paged_cache(1, cap + 1, PS, S_MAX, dtype=kv_dtype)
    row = np.zeros(S_MAX // PS, "i4")
    row[:cap] = np.arange(1, cap + 1)
    for pos in range(0, len(prompt), CHUNK):
        nv = min(CHUNK, len(prompt) - pos)
        toks = np.zeros((1, CHUNK), "i4")
        toks[0, :nv] = prompt[pos:pos + nv]
        lg, cache = model.prefill_paged(toks, nv, 0, row, cache, start=pos)
    return lg[0], cache


def _replay(model, prompt, gen, kv_dtype):
    """Teacher-forced logits of every generated position."""
    lg, cache = _prefill(model, prompt, -(-(len(prompt) + len(gen)) // PS),
                         kv_dtype)
    out = [lg]
    for tok in gen[:-1]:
        lg, cache = model.decode_step_paged(np.array([tok], "i4"),
                                            np.ones(1, "i4"), cache)
        out.append(lg[0])
    return torch.stack(out).cpu()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--new-tokens", type=int, default=48)
    args = ap.parse_args(argv)
    model = GPTModel(vocab_size=50257, units=768, num_layers=args.layers,
                     num_heads=12, max_length=S_MAX,
                     device=args.device).initialize(seed=0)
    model.quantize_params()
    rng = np.random.RandomState(5)
    sys_prompt = rng.randint(0, 50256, 192).astype("i4")
    agree = total = 0
    err = 0.0
    for r in range(3):
        prompt = np.concatenate(
            [sys_prompt, rng.randint(0, 50256, 40 + 30 * r).astype("i4")])
        cap = -(-(len(prompt) + args.new_tokens) // PS)
        lg, cache = _prefill(model, prompt, cap, "int8")
        gen = [int(lg.argmax())]
        for _ in range(args.new_tokens - 1):
            lg, cache = model.decode_step_paged(np.array([gen[-1]], "i4"),
                                                np.ones(1, "i4"), cache)
            gen.append(int(lg[0].argmax()))
        l8 = _replay(model, prompt, gen, "int8")
        l32 = _replay(model, prompt, gen, None)
        err = max(err, float((l8 - l32).abs().max()))
        agree += int((l32.argmax(dim=-1).numpy() == np.array(gen)).sum())
        total += len(gen)
    print(json.dumps({"layers": args.layers, "device": str(model.device),
                      "tokens": total, "kv_logit_max_abs_err": err,
                      "int8_kv_vs_fp32_kv_agreement": agree / total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
