"""The port's optimizers and learning-rate schedulers against the JAX
package's.

``mxnet_tpu_torch.optimizer``'s ``SGD`` (with and without momentum),
``NAG``, ``Adam``, ``AdamW`` and ``Test`` run 5 updates of two weights
through ``update`` beside the reference's on the same seeded numpy
weights and gradients, with weight decay, ``clip_gradient``,
``rescale_grad``, an ``lr_scheduler`` and an ``lr_mult``; the weights
and states must agree within 2e-6 relative (fp32: the same arithmetic in
the same order; the bias corrections' ``power`` is numpy's float32 here,
XLA's there, which may differ in the last bit). ``update_multi_precision``
on bf16 and float16 weights (fp32 masters, ``_step_mp``) is held the
same way: the masters within 2e-6, the 16-bit weights within one step of
their type. The schedulers are the reference's own closed forms, so
they must agree exactly at every update count.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import optimizer as jopt

from mxnet_tpu_torch import lr_scheduler as tsched
from mxnet_tpu_torch import optimizer as topt

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = ((4, 5), (7,))
STEPS = 5

OPTS = {
    "sgd": ("sgd", {"learning_rate": 0.1}),
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 0.01}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    "adamw": ("adamw", {"learning_rate": 0.01, "wd": 0.1}),
    "test": ("test", {"learning_rate": 0.05}),
}
VARIANTS = {
    "plain": {},
    "clip": {"clip_gradient": 0.3},
    "rescale": {"rescale_grad": 0.5},
    "scheduler": {"lr_scheduler": "factor"},
    "lr_mult": {"lr_mult": {0: 0.5}},
}


def _make(mod, sched_mod, name, kw, variant):
    kw = dict(kw)
    extra = dict(VARIANTS[variant])
    if extra.pop("lr_scheduler", None):
        kw["lr_scheduler"] = sched_mod.FactorScheduler(step=2, factor=0.5)
    lr_mult = extra.pop("lr_mult", None)
    opt = mod.create(name, **kw, **extra)
    if lr_mult:
        opt.set_lr_mult(lr_mult)
    return opt


def _arrays(seed):
    rng = onp.random.RandomState(seed)
    ws = [rng.standard_normal(s).astype("f4") for s in SHAPES]
    gs = [[rng.standard_normal(s).astype("f4") for s in SHAPES]
          for _ in range(STEPS)]
    return ws, gs


def _run_reference(name, kw, variant, ws, gs, dtype=None, mp=False):
    opt = _make(jopt, jsched, name, kw, variant)
    w_nd = [jmx.np.array(w).astype(dtype) if dtype else jmx.np.array(w)
            for w in ws]
    states = [opt.create_state_multi_precision(i, w) if mp
              else opt.create_state(i, w) for i, w in enumerate(w_nd)]
    for step in gs:
        for i, g in enumerate(step):
            g_nd = jmx.np.array(g).astype(dtype) if dtype \
                else jmx.np.array(g)
            if mp:
                opt.update_multi_precision(i, w_nd[i], g_nd, states[i])
            else:
                opt.update(i, w_nd[i], g_nd, states[i])
            states[i] = opt._last_states[i]
    return ([onp.asarray(w.asnumpy(), "f4") for w in w_nd],
            [[onp.asarray(x, "f4") for x in _leaves(s)] for s in states])


def _run_port(name, kw, variant, ws, gs, dtype=None, mp=False):
    opt = _make(topt, tsched, name, kw, variant)
    tdt = getattr(torch, dtype) if dtype else torch.float32
    w_t = [torch.from_numpy(w).to(tdt) for w in ws]
    states = [opt.create_state_multi_precision(i, w) if mp
              else opt.create_state(i, w) for i, w in enumerate(w_t)]
    for step in gs:
        for i, g in enumerate(step):
            g_t = torch.from_numpy(g).to(tdt)
            if mp:
                opt.update_multi_precision(i, w_t[i], g_t, states[i])
            else:
                opt.update(i, w_t[i], g_t, states[i])
    return ([w.float().numpy() for w in w_t],
            [[x.float().numpy() for x in _leaves(s)] for s in states])


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("opt", list(OPTS))
def test_update_matches_reference(opt, variant):
    name, kw = OPTS[opt]
    ws, gs = _arrays(seed=len(opt) * 10 + len(variant))
    ref_w, ref_s = _run_reference(name, kw, variant, ws, gs)
    got_w, got_s = _run_port(name, kw, variant, ws, gs)
    for a, b in zip(got_w, ref_w):
        onp.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)
    for sa, sb in zip(got_s, ref_s):
        assert len(sa) == len(sb)
        for a, b in zip(sa, sb):
            onp.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("dtype,step", [("bfloat16", 2.0 ** -8),
                                        ("float16", 2.0 ** -10)])
@pytest.mark.parametrize("opt", ["sgd_momentum", "adam", "adamw"])
def test_multi_precision_matches_reference(opt, dtype, step):
    name, kw = OPTS[opt]
    kw = dict(kw, multi_precision=True)
    ws, gs = _arrays(seed=7)
    ref_w, ref_s = _run_reference(name, kw, "plain", ws, gs, dtype, mp=True)
    got_w, got_s = _run_port(name, kw, "plain", ws, gs, dtype, mp=True)
    for a, b in zip(got_w, ref_w):
        onp.testing.assert_allclose(a, b, rtol=step, atol=step)
    for sa, sb in zip(got_s, ref_s):
        # the fp32 master comes first, then the inner state
        for a, b in zip(sa, sb):
            assert a.dtype == onp.float32
            onp.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


def test_multi_precision_keeps_fp32_master():
    opt = topt.create("adam", learning_rate=0.1, multi_precision=True)
    w = torch.ones(3, dtype=torch.bfloat16)
    state = opt.create_state_multi_precision(0, w)
    assert state[0].dtype == torch.float32 and state[0] is not w
    opt.update_multi_precision(0, w, torch.ones(3, dtype=torch.bfloat16),
                               state)
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, state[0].to(torch.bfloat16))


def test_update_on_parameters_reads_their_gradient():
    """``update`` takes ``Parameter`` weights and gradients (the
    parameter's ``grad()`` buffer) and writes in place."""
    from mxnet_tpu_torch.gluon import Parameter
    p = Parameter("w", (3,))
    p.set_data(torch.ones(3))
    p.grad().fill_(2.0)
    opt = topt.create("sgd", learning_rate=0.5)
    opt.update(0, p, p, opt.create_state(0, p))
    assert torch.equal(p.data(), torch.zeros(3))


def test_registry_and_counts():
    assert set(topt._REGISTRY) >= {"sgd", "nag", "adam", "adamw", "test"}
    opt = topt.create("adam")
    assert topt.create(opt) is opt
    opt._update_count([0, 1])
    opt._update_count(0)
    assert opt._index_update_count == {0: 2, 1: 1} and opt.num_update == 2
    assert int(opt._hyper(1)["t"]) == 1 and int(opt._hyper(0)["t"]) == 2
    opt.set_wd_mult({1: 0.0})
    assert float(opt._hyper(1)["wd"]) == 0.0


SCHEDULERS = [
    ("FactorScheduler", dict(step=3, factor=0.7, base_lr=0.1,
                             stop_factor_lr=0.02, warmup_steps=4,
                             warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[5, 9, 20], factor=0.5, base_lr=0.2,
                                  warmup_steps=3, warmup_mode="constant",
                                  warmup_begin_lr=0.05)),
    ("PolyScheduler", dict(max_update=30, base_lr=0.1, pwr=2, final_lr=0.01,
                           warmup_steps=5)),
    ("CosineScheduler", dict(max_update=30, base_lr=0.1, final_lr=0.001,
                             warmup_steps=5, warmup_begin_lr=0.0)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[s[0] for s in SCHEDULERS])
def test_lr_scheduler_matches_reference(name, kw):
    ref = getattr(jsched, name)(**kw)
    got = getattr(tsched, name)(**kw)
    assert [got(n) for n in range(40)] == [ref(n) for n in range(40)]
