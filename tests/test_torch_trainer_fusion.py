"""The port's ``grad_fusion`` and the Trainer's fused update.

``build_buckets`` gives the JAX package's layouts (reverse declaration
order, one open bucket per dtype, a flush at the byte cap) and the same
content-digest keys, at several caps and with a float16 parameter among
fp32 ones. The Trainer updates through ``fused_update_multi_precision``;
its parameters and states are bit-identical to those of one
``update_multi_precision`` a parameter after a few steps of each
optimizer kind, and LAMB's agree with the JAX Trainer's within 2e-6
(every optimizer's step is held to the reference's in
``test_torch_optimizer_all.py``). The switches are the reference's own
environment variables, read as it reads them. ``save_states`` and
``load_states`` carry Nadam's and LAMB's states: a resumed trainer steps
bitwise as the one that wrote the file, and the JAX trainer reads the
same values from it.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import grad_fusion as jgf
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import grad_fusion as tgf
from mxnet_tpu_torch.gluon import nn as tnn

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

UNITS = ((16, 8), (32, 16), (4, 32), (8, 4))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("MXTPU_FUSED_TRAINER", raising=False)
    monkeypatch.delenv("MXTPU_FUSION_BYTES", raising=False)
    with tmx.cpu():
        yield


def _net(pkg, nn, seed=0):
    net = nn.HybridSequential()
    for out, inp in UNITS:
        net.add(nn.Dense(out, in_units=inp))
    net.initialize(pkg.init.Zero() if pkg is jmx else None)
    rs = onp.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(pkg.np.array(rs.uniform(-1, 1, p.shape).astype("f4")))
    return net


@pytest.mark.parametrize("cap", [1, 600, 2048, 4 << 20])
def test_build_buckets_match_reference(cap):
    layouts = {}
    for pkg, nn, gf in ((jmx, jnn, jgf), (tmx, tnn, tgf)):
        net = _net(pkg, nn)
        params = list(net.collect_params().values())
        params[2].cast("float16")
        buckets = gf.build_buckets(list(enumerate(params)), cap, owner=7)
        layouts[pkg] = [(b.bid, b.indices, tuple(tuple(s) for s in b.shapes),
                         b.nbytes, b.dtype, b.key,
                         [p.name for p in b.params]) for b in buckets]
    assert layouts[tmx] == layouts[jmx]


def test_switches_read_like_reference(monkeypatch):
    for val, on in (("0", False), ("off", False), ("1", True), ("", True)):
        monkeypatch.setenv("MXTPU_FUSED_TRAINER", val)
        assert tgf.fused_enabled() is on is jgf.fused_enabled()
    monkeypatch.setenv("MXTPU_FUSION_BYTES", "1234")
    assert tgf.default_fusion_bytes() == 1234
    monkeypatch.setenv("MXTPU_FUSION_BYTES", "junk")
    with pytest.warns(UserWarning):
        assert tgf.default_fusion_bytes() == tgf.DEFAULT_FUSION_BYTES
    assert tgf.next_owner_uid() < tgf.next_owner_uid()
    with pytest.raises(tmx.base.NotPortedError, match="item 19"):
        tgf.allreduce_bucket(None, None)
    for bad in (-1, 0.5):
        with pytest.raises(ValueError, match="positive byte cap"):
            tmx.gluon.Trainer(_net(tmx, tnn).collect_params(), "sgd",
                              fusion=bad)
    for good in (None, True, False, 0, 1, 4 << 20):
        tmx.gluon.Trainer(_net(tmx, tnn).collect_params(), "sgd",
                          fusion=good)


def _backward(pkg, net):
    x = pkg.np.array(onp.random.RandomState(9).uniform(
        -1, 1, (5, 8)).astype("f4"))
    with pkg.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()


def _train(pkg, nn, opt, kw, steps=3):
    net = _net(pkg, nn)
    tr = pkg.gluon.Trainer(net.collect_params(), opt, dict(kw))
    for _ in range(steps):
        _backward(pkg, net)
        tr.step(5)
    return net, tr


def _loop(opt, kw, steps=3):
    """``_train``'s steps through one ``update_multi_precision`` a
    parameter, in the Trainer's order (sorted by name), with its
    ``rescale_grad`` of 1 / 5."""
    net = _net(tmx, tnn)
    params = [p for _, p in sorted(net.collect_params().items())]
    o = tmx.optimizer.create(opt, **kw)
    states = [o.create_state_multi_precision(i, p._var())
              for i, p in enumerate(params)]
    for _ in range(steps):
        _backward(tmx, net)
        o.rescale_grad = 1.0 / 5
        for i, p in enumerate(params):
            o.update_multi_precision([i], [p._var()], [p._grad_nd()._data],
                                     [states[i]])
    return net, states


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


@pytest.mark.parametrize("opt,kw", [
    ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("nadam", {"learning_rate": 0.01}),
    ("sgd", {"learning_rate": 0.001, "momentum": 0.9}),
], ids=["lamb", "rmsprop", "nadam", "sgd"])
def test_fused_trainer_bitwise_equals_loop(opt, kw):
    fused_net, fused_tr = _train(tmx, tnn, opt, kw)
    loop_net, loop_states = _loop(opt, kw)
    for a, b in zip(fused_net.collect_params().values(),
                    loop_net.collect_params().values()):
        assert torch.equal(a._var(), b._var())
    fused_leaves = _leaves(fused_tr._states)
    loop_leaves = _leaves(loop_states)
    assert len(fused_leaves) == len(loop_leaves) > 0
    for a, b in zip(fused_leaves, loop_leaves):
        assert torch.equal(a, b)
    if opt == "lamb":
        ref_net, _ = _train(jmx, jnn, opt, kw)
        for a, b in zip(fused_net.collect_params().values(),
                        ref_net.collect_params().values()):
            onp.testing.assert_allclose(a.data().asnumpy(),
                                        b.data().asnumpy(), rtol=2e-6,
                                        atol=2e-6)


def _step_once(pkg, net, tr):
    _backward(pkg, net)
    tr.step(5)


@pytest.mark.parametrize("opt", ["nadam", "lamb"])
def test_trainer_states_of_new_optimizers(opt, tmp_path):
    """``save_states``/``load_states`` carry the new optimizers' states:
    a port trainer resumed from the file steps bitwise as the one that
    wrote it, and the JAX trainer reads the same states."""
    kw = {"learning_rate": 0.01}
    net, tr = _train(tmx, tnn, opt, kw, steps=2)
    path = str(tmp_path / "tr.states")
    tr.save_states(path)
    weights = {k: p.data().asnumpy() for k, p in
               net.collect_params().items()}
    _step_once(tmx, net, tr)
    resumed = _net(tmx, tnn)
    for k, p in resumed.collect_params().items():
        p.set_data(weights[k])
    tr2 = tmx.gluon.Trainer(resumed.collect_params(), opt, dict(kw))
    tr2.load_states(path)
    jtr = jmx.gluon.Trainer(_net(jmx, jnn).collect_params(), opt, dict(kw))
    jtr.load_states(path)
    for a, b in zip(_leaves(jtr._states), _leaves(tr2._states)):
        onp.testing.assert_array_equal(onp.asarray(a), b.numpy())
    _step_once(tmx, resumed, tr2)
    for a, b in zip(net.collect_params().values(),
                    resumed.collect_params().values()):
        assert torch.equal(a._var(), b._var())
