"""The port's ``gluon.Trainer`` and the classic Gluon loop against the
JAX package's, on the CPU.

A two-layer MLP (deferred ``in_units``) gets the same seeded weights in
both packages (carried across by name); then a few steps of
``autograd.record()`` → loss → ``backward()`` → ``Trainer.step``, with
SGD (momentum and weight decay), NAG, Adam and AdamW, ``grad_req``
``write`` and ``add``. The losses (1e-5 relative) and every parameter
after the steps (1e-5) are held to the reference's. One case is the
whole classic loop with both nets hybridized: ``initialize``
(deferred, Xavier on the reference), ``hybridize``, ``record``,
``SoftmaxCrossEntropyLoss``, ``backward``, ``step``. Also crossed: the
stale-gradient warning, ``learning_rate``/``set_learning_rate`` and an
``lr_scheduler``, and tied parameters updated once. The port alone:
every store, option and optimizer a later item brings raises
``NotPortedError`` naming it.
"""
import warnings

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.base import NotPortedError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import load_jax_params

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
RS = onp.random.RandomState(4)
X = RS.uniform(-1, 1, (8, 5)).astype("f4")
Y = RS.uniform(-1, 1, (8, 3)).astype("f4")
LABEL = RS.randint(0, 3, (8,)).astype("i4")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _mlp(nn, hybrid=False):
    net = nn.HybridSequential() if hybrid else nn.Sequential()
    net.add(nn.Dense(6, activation="tanh"), nn.Dense(3))
    return net


def _pair(init=None, hybrid=False):
    """Both MLPs on the reference's initial weights: the JAX one
    initialized (deferred) and run once, the port's initialized
    (deferred) and given them by name."""
    jnet = _mlp(jnn, hybrid)
    jnet.initialize(init or jmx.init.Normal(0.5))
    if hybrid:
        jnet.hybridize()
    jnet(jmx.np.array(X))
    tnet = _mlp(tnn, hybrid)
    tnet.initialize()
    if hybrid:
        tnet.hybridize()
    load_jax_params(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _train(pkg, net, opt, opt_params, steps, loss_fn=None, label=Y):
    tr = pkg.gluon.Trainer(net.collect_params(), opt, opt_params)
    loss_fn = loss_fn or pkg.gluon.loss.L2Loss()
    x, y = pkg.np.array(X), pkg.np.array(label)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(X.shape[0])
        losses.append(float(loss.mean().item()))
    return losses, {k: p.data().asnumpy()
                    for k, p in net.collect_params().items()}


OPTS = [
    ("sgd", {"learning_rate": 0.2, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.2, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.05}),
    ("adamw", {"learning_rate": 0.05, "wd": 0.1}),
]


@pytest.mark.parametrize("grad_req", ["write", "add"])
@pytest.mark.parametrize("opt", OPTS, ids=[o[0] for o in OPTS])
def test_trainer_steps_match_reference(opt, grad_req):
    jnet, tnet = _pair()
    res = {}
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        net.collect_params().setattr("grad_req", grad_req)
        res[pkg] = _train(pkg, net, *opt, steps=2)
    assert res[tmx][0][-1] != res[tmx][0][0]
    onp.testing.assert_allclose(res[tmx][0], res[jmx][0], **TOL)
    for k, ref in res[jmx][1].items():
        onp.testing.assert_allclose(res[tmx][1][k], ref, err_msg=k, **TOL)


def test_classic_loop_hybridized():
    """initialize (deferred), hybridize, record, backward, step."""
    jnet, tnet = _pair(jmx.init.Xavier(), hybrid=True)
    res = {}
    for pkg, net in ((jmx, jnet), (tmx, tnet)):
        res[pkg] = _train(pkg, net, "adam", {"learning_rate": 0.05}, 3,
                          pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                          label=LABEL)
    assert res[tmx][0][-1] < res[tmx][0][0]
    onp.testing.assert_allclose(res[tmx][0], res[jmx][0], **TOL)
    for k, ref in res[jmx][1].items():
        onp.testing.assert_allclose(res[tmx][1][k], ref, err_msg=k, **TOL)


def test_stale_gradient_warning_and_learning_rate():
    msgs, lrs = {}, {}
    for pkg, nn in ((jmx, jnn), (tmx, tnn)):
        d = nn.Dense(2, in_units=5)
        d.initialize()
        sched = pkg.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        tr = pkg.gluon.Trainer(d.collect_params(), "sgd",
                               {"learning_rate": 1.0, "lr_scheduler": sched})
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr.step(1)
        msgs[pkg] = [str(m.message) for m in w if "stale" in str(m.message)
                     or "has not been updated" in str(m.message)]
        lrs[pkg] = [tr.learning_rate]
        tr.step(1, ignore_stale_grad=True)
        lrs[pkg].append(tr.learning_rate)
        with pytest.raises(UserWarning):
            tr.set_learning_rate(0.1)
        tr2 = pkg.gluon.Trainer(d.collect_params(), "sgd",
                                {"learning_rate": 1.0})
        tr2.set_learning_rate(0.3)
        assert tr2.learning_rate == 0.3 and tr2.optimizer.lr == 0.3
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tr2.step(1, ignore_stale_grad=True)
    assert lrs[tmx] == lrs[jmx]
    assert len(msgs[tmx]) == len(msgs[jmx]) == 1
    assert msgs[tmx][0].split(" on context")[0] == \
        msgs[jmx][0].split(" on context")[0]


def test_tied_parameters_updated_once():
    res = {}
    for pkg, nn in ((jmx, jnn), (tmx, tnn)):
        a = nn.Dense(3, in_units=3, use_bias=False)
        b = nn.Dense(3, in_units=3, use_bias=False)
        b.share_parameters(a.collect_params())
        a.initialize(pkg.init.One())
        params = {"a": a.weight, "b": b.weight}
        tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        assert len(tr._params) == 1
        x = pkg.np.array(X[:, :3])
        with pkg.autograd.record():
            loss = (b(a(x)) ** 2).sum()
        loss.backward()
        tr.step(1)
        res[pkg] = a.weight.data().asnumpy()
    onp.testing.assert_allclose(res[tmx], res[jmx], **TOL)


def test_later_items_raise(tmp_path):
    d = tnn.Dense(2, in_units=5)
    d.initialize()
    params = d.collect_params()
    for kw, item in (({"kvstore": "dist_sync"}, 19),
                     ({"kvstore": object()}, 19),
                     ({"update_on_kvstore": True}, 19),
                     ({"compression_params": {"type": "2bit"}}, 19)):
        with pytest.raises(NotPortedError, match=f"item {item}"):
            tmx.gluon.Trainer(params, "sgd", **kw)
    # item 16: every optimizer of the reference; fusion= validated
    assert type(tmx.gluon.Trainer(params, "rmsprop").optimizer).__name__ \
        == "RMSProp"
    with pytest.raises(ValueError, match="positive byte cap"):
        tmx.gluon.Trainer(params, "sgd", fusion=-1)
    for kv in (None, "device", "local"):
        tr = tmx.gluon.Trainer(params, "sgd", kvstore=kv)
        tr.allreduce_grads()
    # save_states/load_states (item 18a): the counts come back
    path = str(tmp_path / "tr.states")
    tr.optimizer.num_update = 3
    tr.save_states(path)
    tr.optimizer.num_update = 0
    tr.load_states(path)
    assert tr.optimizer.num_update == 3
    with pytest.raises(ValueError, match="list or dict"):
        tmx.gluon.Trainer(3, "sgd")
