#!/usr/bin/env python3
"""How much acceptance the speculative engine's draft rollback costs.

The target serves as its own draft, so a draft that saw the target's
whole committed prefix would propose exactly the target's greedy tokens
and every proposal would be accepted. The engine's rollback (the
reference's ``advance_len(n_commit - k)``) leaves the draft without the
K/V of its last proposal after a full accept: its k steps feed ``last,
d_1 .. d_{k-1}``, never ``d_k``. This script serves the same greedy
requests through ``GenerationEngine(draft_model=target)`` twice: as the
engine runs, and with the draft fed ``d_k`` too (k + 1 draft steps, the
last one's token unused, and a rollback one step further), and prints
the accepted and proposed counts of each. Greedy tokens are the same
either way.

Run from the repository root::

    python3 scripts/torch_spec_self_draft.py [--device cpu] [--layers 2]

The model is ``gpt_small``-sized (vocab 97, 32 units, 4 heads, 128
positions) with random weights from ``--seed``; the engine has 4 slots,
64 cache rows and ``spec_k=3``; 6 prompts of 3..17 tokens generate 20
tokens each.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.gpt import gpt_small  # noqa: E402
from mxnet_tpu_torch.serving import GenerationEngine  # noqa: E402


class _FedDraft:
    """The target as a draft that also feeds its last proposal: k + 1
    chained steps, the first k tokens proposed, the rollback one step
    further."""

    def __init__(self, model):
        self._m = model
        self._vocab_size = model._vocab_size
        self.init_cache = model.init_cache
        self.prefill = model.prefill

    def propose_tokens(self, tokens, cache, k, **sampling):
        out = self._m.propose_tokens(tokens, cache, k + 1, **sampling)
        if not sampling:
            return out[0][:, :k], out[1]
        return out[0][:, :k], out[1][:, :k], out[2], out[3]

    def advance_len(self, delta, cache):
        return self._m.advance_len(np.asarray(delta) - 1, cache)


def _serve(model, draft, prompts, device):
    eng = GenerationEngine(model, max_slots=4, max_length=64,
                           max_new_tokens=20, draft_model=draft, spec_k=3,
                           device=device)
    telemetry.reset()
    tokens = [s.result(timeout=600).tokens
              for s in [eng.submit(p) for p in prompts]]
    c = telemetry.snapshot()["counters"]
    eng.close()
    return tokens, {"accepted": int(c["serving.generate.spec.accepted"]),
                    "proposed": int(c["serving.generate.spec.proposed"])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    model = gpt_small(vocab_size=97, units=32, num_layers=args.layers,
                      num_heads=4, max_length=128,
                      device=args.device).initialize(seed=args.seed)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 97, size=n).astype("i4")
               for n in (3, 9, 17, 5, 12, 7)]
    engine_toks, engine = _serve(model, model, prompts, args.device)
    fed_toks, fed = _serve(model, _FedDraft(model), prompts, args.device)
    print(json.dumps({"device": str(model.device), "layers": args.layers,
                      "seed": args.seed, "spec_k": 3,
                      "engine_rollback": engine, "draft_fed_d_k": fed,
                      "greedy_tokens_equal": engine_toks == fed_toks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
