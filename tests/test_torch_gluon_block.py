"""The port's ``Block``/``HybridBlock``/``CachedOp``, ``Parameter``,
``Constant``, ``ParameterDict``, ``load_jax_params`` and ``gluon.utils``
against the JAX package's, on the CPU.

Crossed with the reference: ``collect_params`` names and order (and
``select``), deferred initialization and its errors, forward hooks,
``share_parameters``, ``cast``, ``Constant``, ``grad_req`` ``write``
and ``add`` under ``autograd.record()``, ``split_data``/
``split_and_load``, ``clip_global_norm`` (fp32 at 1e-6) and a user's
block written over NDArrays around the port's layers (products at
1e-5). The port alone: a block given tensors returns tensors, no graph
outside ``record()``, ``data()`` writing the parameter in place,
``summary``, the hybridized entries per signature with their telemetry,
bucketing's pad-and-slice on the inference path, ``warmup``/``infer``/
``infer_shape``, and each name a later item brings raising
``NotPortedError`` with that item.
"""
import warnings

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import NotPortedError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import load_jax_params

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RED = dict(rtol=1e-5, atol=1e-5)
X = onp.random.RandomState(0).uniform(-1, 1, (4, 6)).astype("f4")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _net(nn):
    net = nn.HybridSequential()
    inner = nn.HybridSequential()
    inner.add(nn.Dense(5, activation="relu"), nn.LayerNorm())
    net.add(inner, nn.Dense(3, use_bias=False), nn.BatchNorm(axis=-1))
    return net


def _pair():
    jnet = _net(jnn)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.np.array(X))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = _net(tnn)
    tnet.initialize()
    load_jax_params(tnet, params)
    return jnet, tnet, params


def test_collect_params_names_order_and_select():
    jnet, tnet, params = _pair()
    assert list(tnet.collect_params()) == list(params)
    for sel in ("0.*", ".*weight", "2.running_.*"):
        assert list(tnet.collect_params(sel)) == \
            list(jnet.collect_params(sel))
    assert isinstance(tnet.collect_params(), tgluon.ParameterDict)
    assert list(tnet[1].params) == ["weight"]
    assert tnet.collect_params()["0.0.weight"].name == "0.0.weight"
    # the registered tensors are the module's, under the same names
    assert {k for k, _ in tnet.named_parameters()} == set(params)
    onp.testing.assert_allclose(tnet(tmx.np.array(X)).asnumpy(),
                                jnet(jmx.np.array(X)).asnumpy(), **RED)


def test_deferred_initialization():
    for nn, mx, err in ((jnn, jmx, jmx.gluon.DeferredInitializationError),
                        (tnn, tmx, tgluon.DeferredInitializationError)):
        gluon = mx.gluon
        d = nn.Dense(3)
        with pytest.raises(RuntimeError, match="not been initialized"):
            d.weight.data()
        d.initialize()
        assert d.weight.shape == (3, 0)
        with pytest.raises(err):
            d.weight.data()
        d(mx.np.array(X))
        assert d.weight.shape == (3, 6)
        assert d.weight.data().shape == (3, 6)
        with pytest.raises(ValueError, match="invalid shape"):
            gluon.Parameter("w", shape=(3, 0)).initialize()
    # a layer without initialize() refuses its first forward
    with pytest.raises(RuntimeError, match="not been initialized"):
        tnn.Dense(3, in_units=6)(tmx.np.array(X))
    # set_data finishes a deferred initialization from the given shape
    d = tnn.Dense(3)
    d.initialize()
    d.weight.set_data(onp.ones((3, 6), "f4"))
    assert d.weight.shape == (3, 6) and d.weight.data().asnumpy().sum() == 18
    # the layer's own initializer wins over the global one
    d = tnn.Dense(3, in_units=2, bias_initializer="ones")
    d.initialize(tmx.init.Zero())
    assert d.bias.data().asnumpy().tolist() == [1.0, 1.0, 1.0]
    assert d.weight.data().asnumpy().sum() == 0
    d.initialize(tmx.init.One())           # no force_reinit: unchanged
    assert d.weight.data().asnumpy().sum() == 0
    d.initialize(tmx.init.One(), force_reinit=True)
    assert d.weight.data().asnumpy().sum() == 6


def test_hooks():
    calls = {}
    for nn, mx in ((jnn, jmx), (tnn, tmx)):
        d = nn.Dense(2, in_units=6)
        d.initialize()
        seen = []
        h1 = d.register_forward_pre_hook(
            lambda blk, args: seen.append(("pre", len(args))))
        h2 = d.register_forward_hook(
            lambda blk, args, out: seen.append(("post", out.shape)))
        d(mx.np.array(X))
        h1.remove()
        h2.detach()
        d(mx.np.array(X))
        calls[nn] = seen
    assert calls[jnn] == calls[tnn] == [("pre", 1), ("post", (4, 2))]


def test_share_parameters_and_rebuilt_entries():
    a, b = _net(tnn), _net(tnn)
    a.initialize()
    a(tmx.np.array(X))
    b.hybridize()
    b.share_parameters(a.collect_params())
    for (na, pa), (nb, pb) in zip(a.collect_params().items(),
                                  b.collect_params().items()):
        assert na == nb and pa is pb
    onp.testing.assert_array_equal(b(tmx.np.array(X)).asnumpy(),
                                   a(tmx.np.array(X)).asnumpy())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tnn.Dense(2).share_parameters({"nothing": a[1].weight})
    assert any("not in the current model" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="Dict"):
        b.share_parameters([1])


def test_cast_and_reset_ctx():
    _, tnet, _ = _pair()
    jnet = _net(jnn)
    jnet.initialize()
    jnet(jmx.np.array(X))
    jnet.cast("float16")
    tnet.cast("float16")
    for (n, jp), tp in zip(jnet.collect_params().items(),
                           tnet.collect_params().values()):
        assert str(tp.data().dtype) == str(jp.data().dtype) == "float16", n
    out = tnet(tmx.np.array(X.astype("f2")))
    assert out.dtype == onp.float16
    tnet.cast("float32")
    tnet.reset_ctx(tmx.cpu())
    assert tnet[1].weight.list_ctx() == [tmx.cpu()]
    assert tnet[1].weight.grad().dtype == onp.float32


def test_parameter_api(tmp_path):
    p = tgluon.Parameter("w", shape=(2, 3), lr_mult=2.0)
    p.initialize(tmx.init.Constant(1.0))
    assert p.lr_mult == 2.0 and p.list_ctx() == [tmx.cpu()]
    nd = p.data()
    assert p.list_data()[0] is nd and isinstance(nd, tmx.NDArray)
    nd[:] = 3.0                      # writes the parameter in place
    assert p._var().sum().item() == 18.0
    assert p.data()._data.data_ptr() == p._var().data_ptr()
    p.set_data(tmx.np.ones((2, 3)))
    assert p.data().asnumpy().sum() == 6
    with pytest.raises(ValueError, match="does not match"):
        p.set_data(onp.ones((3, 3)))
    assert p.list_grad()[0].asnumpy().sum() == 0
    p.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        p.grad()
    with pytest.raises(ValueError):
        p.grad_req = "sometimes"
    with pytest.raises(NotPortedError, match="item 26"):
        p.var()
    c = tgluon.Constant(onp.arange(4, dtype="f4"))
    jc = jmx.gluon.Constant(onp.arange(4, dtype="f4"))
    c.initialize()
    jc.initialize()
    onp.testing.assert_array_equal(c.data().asnumpy(), jc.data().asnumpy())
    assert c.grad_req == jc.grad_req == "null"
    c.grad_req = "write"
    assert c.grad_req == "null"
    import copy
    assert copy.copy(p) is p and copy.deepcopy(p) is p
    pd = tgluon.ParameterDict(w=tgluon.Parameter("w", shape=(2,)))
    pd.initialize(tmx.init.One())
    pd.setattr("grad_req", "add")
    assert pd["w"].grad_req == "add"
    pd.zero_grad()
    # ParameterDict.save/load (item 18a) round-trip in place
    path = str(tmp_path / "pd.params")
    pd.save(path)
    ptr = pd["w"]._var().data_ptr()
    pd["w"].set_data(onp.zeros(2, "f4"))
    pd.load(path)
    assert pd["w"]._var().data_ptr() == ptr
    assert pd["w"].data().asnumpy().tolist() == [1.0, 1.0]


def test_grad_req_write_and_add():
    res = {}
    for nn, mx in ((jnn, jmx), (tnn, tmx)):
        d = nn.Dense(2, in_units=6)
        d.initialize(mx.init.One())
        d.bias.grad_req = "add"
        for _ in range(2):
            with mx.autograd.record():
                loss = (d(mx.np.array(X)) ** 2).sum()
            loss.backward()
        res[nn] = (d.weight.grad().asnumpy(), d.bias.grad().asnumpy())
        d.zero_grad()
        assert not d.bias.grad().asnumpy().any()
    for got, ref in zip(res[tnn], res[jnn]):
        onp.testing.assert_allclose(got, ref, **RED)


def test_no_graph_outside_record_and_tensor_inputs():
    _, tnet, _ = _pair()
    out = tnet(torch.from_numpy(X))
    assert torch.is_tensor(out) and not out.requires_grad
    assert not any(p._read().requires_grad
                   for p in tnet.collect_params().values())
    with tmx.autograd.record():
        leaf = tnet[1].weight._read()
        assert leaf.requires_grad and leaf is tnet[1].weight._read()
        assert tnet[1].weight.data()._data is leaf
    assert not tnet[1].weight._read().requires_grad


class _UserBlock:
    """A user's block over NDArrays, around a port (or JAX) Dense."""

    @staticmethod
    def make(gluon, nn):
        class UserBlock(gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.dense = nn.Dense(3, in_units=6)
                self.scale = gluon.Parameter("scale", shape=(3,))

            def forward(self, x):
                return self.dense(x) * self.scale.data() + x[:, :3]
        return UserBlock()


def test_user_block_over_ndarrays():
    res = {}
    for gluon, nn, mx in ((jmx.gluon, jnn, jmx), (tgluon, tnn, tmx)):
        blk = _UserBlock.make(gluon, nn)
        blk.initialize(mx.init.Constant(0.5))
        x = mx.np.array(X)
        with mx.autograd.record():
            y = blk(x)
            s = (y * y).sum()
        s.backward()
        res[mx] = [y.asnumpy(), blk.scale.grad().asnumpy(),
                   blk.dense.weight.grad().asnumpy()]
        assert list(blk.collect_params()) == ["scale", "dense.weight",
                                              "dense.bias"]
    for got, ref in zip(res[tmx], res[jmx]):
        onp.testing.assert_allclose(got, ref, **RED)


def test_summary(capsys):
    _, tnet, _ = _pair()
    tnet.summary(tmx.np.array(X))
    text = capsys.readouterr().out
    assert "Dense" in text and "BatchNorm" in text
    assert "Total params: 72" in text


def test_hybridize_entries_and_telemetry():
    _, tnet, _ = _pair()
    ref = tnet(tmx.np.array(X)).asnumpy()
    tnet.hybridize()
    prev = telemetry.set_enabled(True)
    telemetry.reset()
    try:
        for _ in range(3):
            onp.testing.assert_array_equal(
                tnet(tmx.np.array(X)).asnumpy(), ref)
        tnet(tmx.np.array(X[:2]))
        tnet(torch.from_numpy(X))
        assert telemetry.counter_value("gluon.cachedop.cache_miss") == 3
        assert telemetry.counter_value("gluon.cachedop.cache_hit") == 2
        assert len(tnet._cached_op._entries) == 3
        # only the outermost hybridized block owns entries
        assert tnet[0]._cached_op is None
        out = tnet.infer(tmx.np.array(X))
        onp.testing.assert_array_equal(out.asnumpy(), ref)
        assert telemetry.counter_value("gluon.cachedop.infer") == 1
        with tmx.autograd.record():
            tnet(tmx.np.array(X))
        assert len(tnet._cached_op._entries) == 4    # the training flag
    finally:
        telemetry.set_enabled(prev)
    tnet.hybridize(False)
    assert tnet._cached_op is None and not tnet[0]._active


def test_bucketing_pads_and_slices_inference():
    _, tnet, _ = _pair()
    tnet.hybridize()
    x = onp.random.RandomState(1).uniform(-1, 1, (5, 6)).astype("f4")
    ref = tnet(tmx.np.array(x)).asnumpy()
    with tmx.bucketing.policy_scope(tmx.bucketing.BucketingPolicy(
            buckets=[8])):
        tnet._clear_cached_op()
        for n in (5, 3, 8):
            out = tnet(tmx.np.array(x[:n] if n <= 5 else
                                    onp.concatenate([x, x[:3]])))
            assert out.shape == (n, 3)
        assert len(tnet._cached_op._entries) == 1
        onp.testing.assert_allclose(
            tnet(tmx.np.array(x)).asnumpy(), ref, **RED)
        # under record() nothing is padded
        with tmx.autograd.record():
            tnet(tmx.np.array(x))
        assert len(tnet._cached_op._entries) == 2


def test_warmup_infer_shape_optimize_for():
    net = _net(tnn)
    net.initialize()
    net.warmup(tmx.np.array(X))
    assert net._active and len(net._cached_op._entries) == 1
    assert net[1].weight.shape == (3, 5)
    # shape inference runs in predict mode: the running stats stay put
    assert net[2].running_mean.data().asnumpy().tolist() == [0.0] * 3
    net2 = _net(tnn)
    net2.initialize()
    net2.infer_shape(tmx.np.array(X))
    assert all(p._initialized for p in net2.collect_params().values())
    assert net2.optimize_for(tmx.np.array(X)).shape == (4, 3)
    assert net2._active


def test_later_items_raise(tmp_path):
    net = _net(tnn)
    for call, item in ((lambda: net.export("p"), "15c"),
                       (lambda: tgluon.SymbolBlock, "15c"),
                       (lambda: tgluon.data.RecordFileDataset("d.rec"),
                        "17b"),
                       (lambda: tnn.SyncBatchNorm(num_devices=2), "19")):
        with pytest.raises(NotPortedError, match=f"item {item}"):
            call()
    # item 15b's modules and item 18a's save/load are ported
    assert tgluon.rnn.LSTM and tgluon.metric.Accuracy
    net.initialize()
    net.infer_shape(tmx.np.array(X))
    prefix = str(tmp_path / "net")
    net.save(prefix)
    other = _net(tnn)
    other.initialize()
    other.load(prefix)
    for a, b in zip(net.collect_params().values(),
                    other.collect_params().values()):
        onp.testing.assert_array_equal(a.data().asnumpy(),
                                       b.data().asnumpy())
    other.save_parameters(prefix + ".params")
    net.load_parameters(prefix + ".params")


def test_load_jax_params_validates_first():
    _, _, params = _pair()
    net = _net(tnn)
    net.initialize()
    bad_shape = dict(params, **{"1.weight": onp.zeros((4, 5), "f4")})
    for bad, err in (({k: v for k, v in params.items() if k != "1.weight"},
                      KeyError),
                     (dict(params, extra=onp.zeros(1)), KeyError),
                     (bad_shape, ValueError)):
        with pytest.raises(err):
            load_jax_params(net, bad)
        assert not net[1].weight._initialized
    # each parameter keeps its dtype
    net.cast("float16")
    load_jax_params(net, params)
    assert net[1].weight.data().dtype == onp.float16


def test_gluon_utils():
    x = onp.arange(24, dtype="f4").reshape(6, 4)
    for pkg in (jmx, tmx):
        parts = pkg.gluon.utils.split_data(pkg.np.array(x), 3)
        assert [p.shape for p in parts] == [(2, 4)] * 3
        with pytest.raises(ValueError, match="evenly"):
            pkg.gluon.utils.split_data(pkg.np.array(x), 4)
        uneven = pkg.gluon.utils.split_data(pkg.np.array(x), 4,
                                            even_split=False)
        assert [p.shape[0] for p in uneven] == [1, 1, 1, 3]
        assert pkg.gluon.utils.shape_is_known((2, 3))
        assert not pkg.gluon.utils.shape_is_known((2, 0))
    loaded = tgluon.split_and_load(x, [tmx.cpu()])
    assert len(loaded) == 1 and loaded[0].ctx == tmx.cpu()
    two = tgluon.split_and_load(x, [tmx.cpu(0), tmx.cpu(0)], batch_axis=1)
    assert [a.shape for a in two] == [(6, 2), (6, 2)]
    res = {}
    for pkg in (jmx, tmx):
        arrs = [pkg.np.array(x), pkg.np.array(-x[:2])]
        norm = pkg.gluon.utils.clip_global_norm(arrs, 10.0)
        res[pkg] = (norm, [a.asnumpy() for a in arrs])
    assert abs(res[tmx][0] - res[jmx][0]) <= 1e-6 * res[jmx][0]
    for got, ref in zip(res[tmx][1], res[jmx][1]):
        onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # without check_isfinite the norm stays on the device
    arrs = [tmx.np.array(x)]
    norm = tgluon.utils.clip_global_norm(arrs, 1e6, check_isfinite=False)
    assert isinstance(norm, tmx.NDArray)
    onp.testing.assert_array_equal(arrs[0].asnumpy(), x)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tgluon.utils.clip_global_norm([tmx.np.array([onp.inf])], 1.0)
    assert any("nan or inf" in str(m.message) for m in w)
    import hashlib
    import tempfile
    with tempfile.NamedTemporaryFile() as f:
        f.write(b"abc")
        f.flush()
        assert tgluon.utils.check_sha1(f.name,
                                       hashlib.sha1(b"abc").hexdigest())
