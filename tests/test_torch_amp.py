"""The port's ``amp`` against the JAX package's, on the CPU.

Under ``amp.init("float16")`` and ``amp.init("bfloat16")`` both routes
give the reference's output dtypes and values: Gluon layers on the
same seeded parameters (``Dense``, ``Conv2D``, ``LayerNorm``,
``MultiHeadAttention`` and ``SoftmaxCrossEntropyLoss``) and ``mx.np``/``mx.npx`` ops (a list op of
each kind). Values agree within two steps of the low type at the
outputs' magnitude (the products round once in both packages, in
another order). ``LossScaler`` follows the reference's scale
trajectory; the ``Trainer`` skips an overflowing step with its
parameters bitwise unchanged, halves the scale and counts the trip,
and ``amp.unscale`` is not divided twice (the parameters then agree
within the float16 gradients' rounding, ``F16_STEP``);
``convert_hybrid_block`` casts the reference's parameters. AMP's process-wide state is restored in
both packages after each test.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.gluon import nn as tnn

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_gluon_nn import INPUTS, _pair

LOW_TOL = {"float16": 2.0 ** -9, "bfloat16": 2.0 ** -6}
# parameters after steps whose gradients flowed through float16
# activations: each package rounds them once, in another order
F16_STEP = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _amp_restored(monkeypatch):
    saved = (dict(jmx.amp._state), dict(tmx.amp._state))
    monkeypatch.delenv("MXTPU_FUSED_TRAINER", raising=False)
    with tmx.cpu():
        yield
    jmx.amp._state.clear()
    jmx.amp._state.update(saved[0])
    tmx.amp._state.clear()
    tmx.amp._state.update(saved[1])


def _init(dt):
    jmx.amp.init(dt)
    tmx.amp.init(dt)


def _same(got, ref, dt):
    g, r = got.asnumpy().astype("f4"), onp.asarray(ref.asnumpy(), "f4")
    assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
    assert g.shape == r.shape
    scale = max(1.0, float(onp.abs(r).max()))
    onp.testing.assert_allclose(g, r, rtol=0, atol=2 * LOW_TOL[dt] * scale)


def _loss_net(nn):
    return nn.Dense(5, flatten=False)


LAYERS = [
    ("Dense", lambda nn: nn.Dense(4, flatten=False), "s"),
    ("Conv2D", lambda nn: nn.Conv2D(3, 3), "c2"),
    ("LayerNorm", lambda nn: nn.LayerNorm(), "s"),
    ("MultiHeadAttention", lambda nn: nn.MultiHeadAttention(8, 2), "s"),
]


@pytest.mark.parametrize("dt", ["float16", "bfloat16"])
@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_gluon_layers_under_amp(case, dt):
    _, factory, inp = case
    x = INPUTS[inp]
    jl, tl = _pair(factory, x)
    _init(dt)
    _same(tl(tmx.np.array(x)), jl(jmx.np.array(x)), dt)


@pytest.mark.parametrize("dt", ["float16", "bfloat16"])
def test_softmax_ce_loss_under_amp(dt):
    x = INPUTS["s"]
    label = onp.random.RandomState(3).randint(0, 5, (2, 6)).astype("i4")
    jl, tl = _pair(_loss_net, x)
    _init(dt)
    res = {}
    for pkg, layer in ((jmx, jl), (tmx, tl)):
        xa = pkg.np.array(x)
        for p in layer.collect_params().values():
            p.zero_grad()
        with pkg.autograd.record():
            logits = layer(xa)
            loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
                logits, pkg.np.array(label))
        loss.backward()
        res[pkg] = (logits, loss, layer.weight.grad())
    for k in range(3):
        _same(res[tmx][k], res[jmx][k], dt)
    assert str(res[tmx][1].dtype) == "float32"


@pytest.mark.parametrize("dt", ["float16", "bfloat16"])
def test_npx_route_under_amp(dt):
    rs = onp.random.RandomState(5)
    a = rs.uniform(-1, 1, (3, 8)).astype("f4")
    w = rs.uniform(-1, 1, (4, 8)).astype("f4")
    g, b = rs.uniform(0.5, 1.5, (8,)).astype("f4"), \
        rs.uniform(-1, 1, (8,)).astype("f4")
    _init(dt)
    out = {}
    for pkg in (jmx, tmx):
        np, npx = pkg.np, pkg.npx
        fc = npx.fully_connected(np.array(a), np.array(w), None,
                                 num_hidden=4, no_bias=True)
        low = fc.astype(dt)
        out[pkg] = [
            fc,
            npx.layer_norm(low, np.array(np.ones((4,))),
                           np.array(np.zeros((4,)))),
            npx.softmax(low),
            np.add(low, np.array(onp.ones((3, 4), "f4"))),
            np.sum(low),
            npx.batch_dot(np.array(a).reshape(1, 3, 8),
                          np.array(w).reshape(1, 8, 4)),
            npx.layer_norm(np.array(a).astype(dt), np.array(g),
                           np.array(b)),
        ]
    for got, ref in zip(out[tmx], out[jmx]):
        _same(got, ref, dt)


def test_loss_scaler_trajectory():
    flags = [False] * 5 + [True, True] + [False] * 7 + [True] + [False] * 3
    scales = {}
    for pkg in (jmx, tmx):
        s = pkg.amp.LossScaler(init_scale=8.0, scale_window=3)
        scales[pkg] = [s.update_scale(f) for f in flags]
        assert s.overflow_count == 3
    assert scales[tmx] == scales[jmx]
    s = tmx.amp.LossScaler(init_scale=2.0)
    assert [s.update_scale(True) for _ in range(3)] == [1.0, 1.0, 1.0]
    s = tmx.amp.LossScaler(init_scale=2.0 ** 24, scale_window=1)
    assert s.update_scale(False) == 2.0 ** 24
    fin = tmx.amp.loss_scaler.all_finite
    assert fin([torch.ones(3), torch.arange(3)]) and fin([])
    for bad in (float("inf"), float("nan"), -float("inf")):
        assert not fin([torch.ones(3), torch.tensor([1.0, bad]).half()])


def _net(pkg, nn):
    net = nn.Dense(3, in_units=4)
    net.initialize(pkg.init.Zero() if pkg is jmx else None)
    rs = onp.random.RandomState(2)
    net.weight.set_data(pkg.np.array(rs.uniform(-1, 1, (3, 4)).astype("f4")))
    net.bias.set_data(pkg.np.array(rs.uniform(-1, 1, (3,)).astype("f4")))
    return net


def _amp_steps(pkg, nn, opt, inject=(), unscale=False, steps=4):
    net = _net(pkg, nn)
    tr = pkg.gluon.Trainer(net.collect_params(), opt,
                           {"learning_rate": 0.1})
    pkg.amp.init_trainer(tr)
    # a scale the float16 cotangents hold without overflowing
    tr._amp_loss_scaler.loss_scale = 16.0
    tr._amp_loss_scaler._scale_window = 2
    x = pkg.np.array(INPUTS["d"][:, :4])
    trace = []
    for k in range(steps):
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
            with pkg.amp.scale_loss(loss, tr) as scaled:
                pass
        scaled.backward()
        if k in inject:
            g = net.weight.grad()
            g[0, 0] = float("inf")
        before = [p.data().asnumpy().copy()
                  for p in net.collect_params().values()]
        if unscale:
            pkg.amp.unscale(tr)
        tr.step(2)
        after = [p.data().asnumpy() for p in net.collect_params().values()]
        trace.append((tr._amp_loss_scaler.loss_scale,
                      all((a == b).all() for a, b in zip(before, after)),
                      after))
    return trace, tr


@pytest.mark.parametrize("opt", ["sgd", "lamb"])
def test_trainer_overflow_skip_and_scale(opt):
    _init("float16")
    ref, _ = _amp_steps(jmx, jnn, opt, inject=(1,))
    got, tr = _amp_steps(tmx, tnn, opt, inject=(1,))
    assert [t[0] for t in got] == [t[0] for t in ref]
    assert [t[1] for t in got] == [False, True, False, False]
    assert tr._amp_loss_scaler.overflow_count == 1
    for (_, _, a), (_, _, b) in zip(got, ref):
        for x, y in zip(a, b):
            onp.testing.assert_allclose(x, y, **F16_STEP)
    assert got[1][0] == got[0][0] / 2


def test_unscale_divides_once():
    _init("float16")
    plain, _ = _amp_steps(tmx, tnn, "sgd", steps=2)
    unscaled, _ = _amp_steps(tmx, tnn, "sgd", unscale=True, steps=2)
    ref, _ = _amp_steps(jmx, jnn, "sgd", unscale=True, steps=2)
    for (_, _, a), (_, _, b), (_, _, c) in zip(plain, unscaled, ref):
        for x, y, z in zip(a, b, c):
            onp.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
            onp.testing.assert_allclose(y, z, **F16_STEP)


def test_convert_hybrid_block_and_names():
    nets = {}
    for pkg, nn in ((jmx, jnn), (tmx, tnn)):
        net = nn.HybridSequential()
        net.add(nn.Dense(3, in_units=4), nn.LayerNorm(in_channels=3),
                nn.Dense(2, in_units=3))
        net.initialize()
        pkg.amp.convert_hybrid_block(net, "float16")
        nets[pkg] = {k: str(p.dtype).replace("torch.", "")
                     for k, p in net.collect_params().items()}
        assert pkg.amp.convert_symbol("s") == "s"
    assert nets[tmx] == {k: str(onp.dtype(v)) for k, v in nets[jmx].items()}
    public = {n for n in dir(jmx.amp) if not n.startswith("_")
              and n not in ("jnp", "onp", "NDArray", "annotations")}
    assert public <= set(dir(tmx.amp))
    for fn in ("list_lp16_ops", "list_fp16_ops", "list_fp32_ops",
               "list_lp16_fp32_ops", "list_widest_type_cast",
               "list_conditional_fp32_ops", "list_lp16_use_fp32_params",
               "list_loss_output_functions"):
        assert getattr(tmx.amp, fn)() == getattr(jmx.amp, fn)()
    a, b = tmx.amp.amp_multicast(tmx.np.array(onp.ones(2, "f4")),
                                 tmx.np.array(onp.ones(2, "f2")))
    assert str(a.dtype) == str(b.dtype) == "float32"
