#!/usr/bin/env python3
"""How far apart ``chip_smoke.py``'s ``amp_data`` comparisons put two
runs that differ on purpose, on the CPU port alone.

Run from the repository root (no card needed; about a minute)::

    python3 scripts/torch_amp_yardsticks.py

It builds the phase's BERT-width model (``chip_smoke._bert``: 768 units,
12 heads, FFN 3072, vocabulary 30522, 2 cells) from seeded Xavier
weights, takes two LAMB steps on 2 x 32 seeded tokens under
``amp.init("float16")`` with the loss scale at ``AMP_CPU["loss_scale"]``
(the card-vs-CPU pair's set-up), and prints the pair's two metrics
(the first step's logits and the worst parameter change, 2-norms, as
``chip_smoke._rel2`` and ``_change_err`` compute them) between that run
and: the same run again, the same steps in fp32, a learning rate 1.1 x
too large, and an attention scale 1.1 x too large. The first shows the
CPU's repeatability, the second what float16 costs, the last two what
a faulty update or a faulty attention reads as.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.ops import attention as at  # noqa: E402


def main():
    c, p = cs.AMP_BERT, cs.AMP_CPU
    rs = np.random.RandomState(0)
    ids = rs.randint(0, c["vocab"], (2 * p["batch"], p["seq"])).astype("i4")
    labels = np.roll(ids, -1, axis=1)
    batches = [(ids[i:i + p["batch"]], labels[i:i + p["batch"]])
               for i in range(0, len(ids), p["batch"])]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        mx.random.seed(0)
        net = cs._bert(mx, mx.gluon.nn)
        net.initialize(mx.init.Xavier())
        net.infer_shape(mx.np.array(ids[:1, :8]))
    weights = {k: v.data().asnumpy() for k, v in
               net.collect_params().items()}
    w0 = {k: torch.from_numpy(v) for k, v in weights.items()}
    saved = dict(mx.amp._state)

    def run(amp=True, lr=c["lr"]):
        mx.amp._state["active"] = False
        if amp:
            mx.amp.init("float16")
        net = cs._amp_copy(mx, cs._bert, weights, mx.cpu())
        keep = []
        with mx.cpu():
            tr = mx.gluon.Trainer(net.collect_params(), "lamb",
                                  {"learning_rate": lr})
            if amp:
                mx.amp.init_trainer(tr)
                tr._amp_loss_scaler.loss_scale = p["loss_scale"]
            for x, y in batches:
                cs._amp_step(mx, net, tr, loss_fn, mx.np.array(x),
                             mx.np.array(y), p["batch"], scaled=amp,
                             keep=keep)
        skipped = tr._amp_loss_scaler.overflow_count if amp else 0
        return keep[0], cs._weights_of(net, "cpu"), skipped

    try:
        base = run()
        others = {"repeat": run(), "fp32": run(amp=False),
                  "lr_x1.1": run(lr=1.1 * c["lr"])}
        scale = at._scale
        at._scale = lambda q, s: 1.1 * scale(q, s)
        try:
            others["attention_scale_x1.1"] = run()
        finally:
            at._scale = scale
    finally:
        mx.amp._state.clear()
        mx.amp._state.update(saved)
    out = {"base_skipped_steps": base[2]}
    for name, (logits, w, skipped) in others.items():
        err, worst = cs._change_err(w, base[1], w0)
        out[name] = {"first_logits_rel_err": cs._rel2(logits, base[0]),
                     "worst_change_rel_err": err, "worst_change_param": worst,
                     "skipped_steps": skipped}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
