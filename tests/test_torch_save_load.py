"""The port's file layer against the JAX package's, on the CPU, with
files crossed both ways.

``mx.save``/``mx.load`` (and ``nd``/``npx`` ``save``/``load``, the same
functions): ``.npz`` dicts and lists, csr and row_sparse members, a
bfloat16 array stored as float32, arrays made on the current context;
the legacy binary NDArray list: ``save_legacy`` writes the JAX writer's
bytes, and a hand-built file of V1, pre-V1, V2 (dense, row_sparse, csr)
and V3 entries reads the same in both packages; ``Block.save_parameters``
/ ``load_parameters`` (``allow_missing``, ``ignore_extra``,
``cast_dtype``, the NCHW kernel transposed into a channels-last
``Conv2D``), ``Block.save``/``load``, ``ParameterDict.save``/``load``
(``strip_prefix``/``restore_prefix``), ``model.save_checkpoint``/
``load_params`` and ``callback.do_checkpoint``; ``Trainer.save_states``
/ ``load_states`` across the packages, and a run resumed from its saved
parameters and states after step k continuing bit-identically, its
parameters kept in the same storage.

Tolerance: none for what a file carries (float32 of a bfloat16 array is
exact) and for the resumed run (the uninterrupted run's operations on
the same values); the Adam states that each package's own two steps
made, before they cross, within 1e-5 relative and 1e-6 absolute (two
frameworks' float32 arithmetic).
"""
import os
import pickle
import struct

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import legacy_serialization as jlegacy
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import legacy_serialization as tlegacy
from mxnet_tpu_torch.base import NotPortedError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import load_jax_params

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _u(shape, seed):
    return onp.random.RandomState(seed).uniform(-1, 1, shape).astype("f4")


def _dense(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(a, b):
    """Two loaded containers (dict or list) with equal keys, dtypes and
    values."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        a, b = list(a.values()), list(b.values())
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert getattr(x, "stype", "default") == getattr(y, "stype",
                                                         "default")
        dx, dy = _dense(x), _dense(y)
        assert dx.dtype == dy.dtype and dx.shape == dy.shape
        onp.testing.assert_array_equal(dx, dy)


def _arrays(pkg):
    sp = pkg.nd.sparse
    dense = onp.array([[0, 2, 0], [0, 0, 0], [3, 0, 4]], "f4")
    return {"w": pkg.np.array(_u((3, 4), 1)),
            "i": pkg.np.array(onp.arange(6, dtype="i4").reshape(2, 3)),
            "b": pkg.np.array(_u((5,), 2)).astype("bfloat16"),
            "csr": sp.csr_matrix(dense),
            "rsp": sp.row_sparse_array(dense)}


def test_npz_crosses_both_ways(tmp_path):
    for writer, reader in ((tmx, jmx), (jmx, tmx)):
        f = str(tmp_path / f"{writer.__name__}.npz")
        writer.save(f, _arrays(writer))
        with onp.load(f) as npz:
            assert npz["b"].dtype == onp.float32
        _same(reader.load(f), writer.load(f))
        _same(tmx.load(f), {k: v.astype("float32") if k == "b" else v
                            for k, v in _arrays(tmx).items()})
        lf = str(tmp_path / f"{writer.__name__}_list.npz")
        writer.save(lf, [writer.np.array(_u((2,), k)) for k in range(12)])
        got = reader.load(lf)
        assert isinstance(got, list) and len(got) == 12
        _same(got, [_u((2,), k) for k in range(12)])
    one = str(tmp_path / "one.npz")
    tmx.nd.save(one, torch.arange(3.0))
    assert tmx.npx.load(one)[0].ctx == tmx.cpu()
    _same(tmx.npx.load(one), jmx.nd.load(one))
    assert tmx.nd.save is not None and tmx.npx.save is not None


def test_save_legacy_bytes_match_reference(tmp_path):
    data = {"arg:w": _u((3, 2), 3), "aux:m": onp.arange(4, dtype="i4"),
            "h": onp.ones((2, 2, 2), "f2"), "u": onp.arange(3, dtype="u1")}
    tf, jf = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tlegacy.save_legacy(tf, {k: tmx.np.array(v) for k, v in data.items()})
    jlegacy.save_legacy(jf, {k: jmx.np.array(v) for k, v in data.items()})
    with open(tf, "rb") as a, open(jf, "rb") as b:
        assert a.read() == b.read()
    tlegacy.save_legacy(tf, list(data.values()))
    jlegacy.save_legacy(jf, list(data.values()))
    with open(tf, "rb") as a, open(jf, "rb") as b:
        assert a.read() == b.read()
    _same(tmx.load(jf), jmx.load(tf))


def _shape(shape):
    return struct.pack("<i", len(shape)) + struct.pack(
        f"<{len(shape)}q", *shape)


def _legacy_file():
    """A reference-format list of six entries: V1, pre-V1 and V2 dense,
    V2 row_sparse, V2 csr and V3 dense, named."""
    f32 = _u((2, 3), 4)
    body = []
    body.append(struct.pack("<I", tlegacy.NDARRAY_V1_MAGIC) + _shape((2, 3))
                + struct.pack("<iii", 1, 0, 0) + f32.tobytes())
    i32 = onp.arange(4, dtype="i4")
    body.append(struct.pack("<I", 1) + struct.pack("<I", 4)
                + struct.pack("<iii", 1, 0, 4) + i32.tobytes())
    f64 = onp.linspace(0, 1, 5)
    body.append(struct.pack("<Ii", tlegacy.NDARRAY_V2_MAGIC, 0)
                + _shape((5,)) + struct.pack("<iii", 1, 0, 1)
                + f64.tobytes())
    rows, vals = onp.array([0, 2], "i8"), _u((2, 3), 5)
    body.append(struct.pack("<Ii", tlegacy.NDARRAY_V2_MAGIC, 1)
                + _shape((2, 3)) + _shape((4, 3))
                + struct.pack("<iii", 1, 0, 0)
                + struct.pack("<i", 6) + _shape((2,))
                + vals.tobytes() + rows.tobytes())
    ptr, idx = onp.array([0, 1, 1, 3], "i8"), onp.array([2, 0, 1], "i8")
    cv = onp.array([1.5, -2.0, 3.0], "f4")
    body.append(struct.pack("<Ii", tlegacy.NDARRAY_V2_MAGIC, 2)
                + _shape((3,)) + _shape((3, 3))
                + struct.pack("<iii", 1, 0, 0)
                + struct.pack("<i", 6) + _shape((4,))
                + struct.pack("<i", 6) + _shape((3,))
                + cv.tobytes() + ptr.tobytes() + idx.tobytes())
    u16 = onp.arange(6, dtype="u2").reshape(3, 2)
    body.append(struct.pack("<Ii", tlegacy.NDARRAY_V3_MAGIC, 0)
                + _shape((3, 2)) + struct.pack("<iii", 1, 0, 9)
                + u16.tobytes())
    names = [b"v1", b"prev1", b"v2", b"rsp", b"csr", b"v3"]
    out = struct.pack("<QQQ", tlegacy.LIST_MAGIC, 0, len(body)) \
        + b"".join(body) + struct.pack("<Q", len(names)) \
        + b"".join(struct.pack("<Q", len(n)) + n for n in names)
    return out


def test_legacy_reader_matches_reference(tmp_path):
    f = str(tmp_path / "legacy.params")
    with open(f, "wb") as fh:
        fh.write(_legacy_file())
    got, ref = tmx.load(f), jmx.load(f)
    _same(got, ref)
    assert got["rsp"].stype == "row_sparse" and got["csr"].stype == "csr"
    assert got["v1"].ctx == tmx.cpu()
    onp.testing.assert_array_equal(got["csr"].asnumpy(),
                                   [[0, 0, 1.5], [0, 0, 0], [-2, 3, 0]])
    with open(f, "rb") as fh:
        assert tlegacy.is_legacy_file(fh.read(8))
    with open(f, "wb") as fh:
        fh.write(_legacy_file()[:-9])
    with pytest.raises(ValueError, match="truncated"):
        tmx.load(f)


def _net(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3, activation="tanh"),
            nn.Dense(2, in_units=4))
    return net


def _pair():
    """A JAX net with seeded weights and the port's copy of it."""
    jnet = _net(jnn)
    jnet.initialize(jmx.init.Zero())
    rs = onp.random.RandomState(7)
    params = {}
    for name, p in jnet.collect_params().items():
        params[name] = rs.uniform(-1, 1, p.shape).astype("f4")
        p.set_data(jmx.np.array(params[name]))
    tnet = _net(tnn)
    tnet.initialize()
    load_jax_params(tnet, params)
    return jnet, tnet, params


def test_save_load_parameters_cross_both_ways(tmp_path):
    jnet, tnet, params = _pair()
    x = _u((5, 3), 8)
    ref = jnet(jmx.np.array(x)).asnumpy()
    for writer in (jnet, tnet):
        f = str(tmp_path / f"{type(writer).__module__.split('.')[0]}.params")
        writer.save_parameters(f)
        fresh_t, fresh_j = _net(tnn), _net(jnn)
        fresh_t.initialize()
        fresh_j.initialize(jmx.init.Zero())
        ptrs = [p._var().data_ptr() for p in
                fresh_t.collect_params().values()]
        fresh_t.load_parameters(f)
        fresh_j.load_parameters(f)
        assert ptrs == [p._var().data_ptr() for p in
                        fresh_t.collect_params().values()]
        onp.testing.assert_array_equal(
            fresh_t(tmx.np.array(x)).asnumpy(),
            tnet(tmx.np.array(x)).asnumpy())
        onp.testing.assert_array_equal(fresh_j(jmx.np.array(x)).asnumpy(),
                                       ref)
    # a deferred net takes the shapes from the file; Block.save/load
    prefix = str(tmp_path / "blk")
    tnet.save(prefix)
    deferred = tnn.HybridSequential()
    deferred.add(tnn.Dense(4, activation="tanh"), tnn.Dense(2))
    deferred.initialize()
    deferred.load(prefix)
    onp.testing.assert_array_equal(deferred(tmx.np.array(x)).asnumpy(),
                                   tnet(tmx.np.array(x)).asnumpy())
    # missing and extra names
    f = str(tmp_path / "part.params")
    tmx.save(f, {"0.weight": params["0.weight"], "extra": onp.ones(2)})
    net = _net(tnn)
    net.initialize()
    with pytest.raises(AssertionError, match="missing"):
        net.load_parameters(f)
    with pytest.raises(AssertionError, match="not present"):
        net.load_parameters(f, allow_missing=True)
    net.load_parameters(f, allow_missing=True, ignore_extra=True)
    onp.testing.assert_array_equal(net[0].weight.data().asnumpy(),
                                   params["0.weight"])


def test_load_parameters_cast_dtype_and_conv_transpose(tmp_path):
    f = str(tmp_path / "half.params")
    net = tnn.Dense(2, in_units=3)
    net.initialize()
    tmx.save(f, {"weight": onp.ones((2, 3), "f2"),
                 "bias": onp.zeros(2, "f2")})
    net.load_parameters(f, cast_dtype=True, dtype_source="saved")
    assert net.weight.data().dtype == onp.float16
    net.load_parameters(f, cast_dtype=True)
    assert net.weight.data().dtype == onp.float16
    # a reference NCHW kernel (O, I, H, W) into an NHWC layer (O, H, W, I)
    oihw = _u((5, 2, 3, 3), 9)
    g = str(tmp_path / "conv.params")
    tmx.save(g, {"weight": oihw, "bias": onp.zeros(5, "f4")})
    for in_channels in (2, 0):
        conv = tnn.Conv2D(5, 3, layout="NHWC", in_channels=in_channels)
        conv.initialize()
        with pytest.warns(UserWarning, match="transposed") \
                if in_channels else _no_warning():
            conv.load_parameters(g)
        onp.testing.assert_array_equal(conv.weight.data().asnumpy(),
                                       oihw.transpose(0, 2, 3, 1))
    amb = str(tmp_path / "amb.params")
    tmx.save(amb, {"weight": _u((5, 3, 3, 3), 10),
                   "bias": onp.zeros(5, "f4")})
    conv = tnn.Conv2D(5, 3, layout="NHWC")
    conv.initialize()
    with pytest.raises(ValueError, match="ambiguous"):
        conv.load_parameters(amb)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_parameter_dict_save_load_prefixes(tmp_path):
    jnet, tnet, params = _pair()
    f = str(tmp_path / "pd.params")
    tnet.collect_params().save(f, strip_prefix="")
    with pytest.raises(ValueError, match="striped"):
        tnet.collect_params().save(f, strip_prefix="1.")
    tnet.collect_params("1\\..*").save(f, strip_prefix="1.")
    with onp.load(f) as npz:
        assert sorted(npz.files) == ["bias", "weight"]
    other = _net(tnn)
    other.initialize()
    ptr = other[1].weight._var().data_ptr()
    other.collect_params("1\\..*").load(f, restore_prefix="1.")
    assert other[1].weight._var().data_ptr() == ptr
    onp.testing.assert_array_equal(other[1].weight.data().asnumpy(),
                                   params["1.weight"])
    with pytest.raises(AssertionError, match="missing"):
        other.collect_params().load(f, restore_prefix="1.")
    with pytest.raises(ValueError, match="not present"):
        other.collect_params("0\\..*").load(f, restore_prefix="1.",
                                            allow_missing=True)
    jd = str(tmp_path / "jpd.params")
    jnet.collect_params("1\\..*").save(jd, strip_prefix="1.")
    _same(tmx.load(jd), tmx.load(f))


def test_model_checkpoint_cross_both_ways(tmp_path):
    arg = {"fc_weight": _u((3, 2), 11), "fc_bias": _u((3,), 12)}
    aux = {"bn_moving_mean": _u((3,), 13)}
    for pkg in (tmx, jmx):
        prefix = str(tmp_path / pkg.__name__)
        pkg.model.save_checkpoint(prefix, 3, None,
                                  {k: pkg.np.array(v) for k, v in
                                   arg.items()},
                                  {k: pkg.np.array(v) for k, v in
                                   aux.items()})
        assert os.path.exists(f"{prefix}-0003.params")
        for reader in (tmx, jmx):
            a, x = reader.model.load_params(prefix, 3)
            _same(a, arg)
            _same(x, aux)
    # a Gluon file: unprefixed running statistics go to aux
    bn = tnn.BatchNorm(in_channels=2)
    bn.initialize()
    prefix = str(tmp_path / "gluon")
    bn.save_parameters(f"{prefix}-0001.params")
    a, x = tmx.model.load_params(prefix, 1)
    assert sorted(x) == ["running_mean", "running_var"]
    assert sorted(a) == sorted(jmx.model.load_params(prefix, 1)[0])
    with pytest.raises(NotPortedError, match="item 26"):
        tmx.model.save_checkpoint(prefix, 1, object(), {}, {})
    with pytest.raises(NotPortedError, match="item 26"):
        tmx.model.load_checkpoint(prefix, 1)
    cb = tmx.callback.do_checkpoint(str(tmp_path / "cb"), period=2)
    cb(0, None, {"w": tmx.np.ones(2)}, {})
    assert not os.path.exists(str(tmp_path / "cb-0001.params"))
    cb(1, None, {"w": tmx.np.ones(2)}, {})
    _same(tmx.model.load_params(str(tmp_path / "cb"), 2)[0],
          {"w": onp.ones(2, "f4")})
    assert tmx.model.BatchEndParam is tmx.callback.BatchEndParam


def _steps(pkg, net, trainer, x, y, n):
    for _ in range(n):
        with pkg.autograd.record():
            loss = ((net(pkg.np.array(x)) - pkg.np.array(y)) ** 2).mean()
        loss.backward()
        trainer.step(x.shape[0])


def test_trainer_states_cross_both_ways(tmp_path):
    x, y = _u((6, 3), 14), _u((6, 2), 15)
    jnet, tnet, _ = _pair()
    opt = ("adam", {"learning_rate": 0.05})
    jtr = jmx.gluon.Trainer(jnet.collect_params(), *opt)
    ttr = tmx.gluon.Trainer(tnet.collect_params(), *opt)
    _steps(jmx, jnet, jtr, x, y, 2)
    _steps(tmx, tnet, ttr, x, y, 2)
    jf, tf = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    jtr.save_states(jf)
    ttr.save_states(tf)
    with open(jf, "rb") as a, open(tf, "rb") as b:
        jb, tb = pickle.load(a), pickle.load(b)
    assert {k: v for k, v in jb.items() if k != "states"} == \
        {k: v for k, v in tb.items() if k != "states"}
    for js, ts in zip(jb["states"], tb["states"]):
        assert len(js) == len(ts)
        for a, b in zip(js, ts):
            assert a.dtype == b.dtype and a.shape == b.shape
            onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # each package reads the other's file
    _, tnet2, _ = _pair()
    ttr2 = tmx.gluon.Trainer(tnet2.collect_params(), *opt)
    ttr2.load_states(jf)
    for saved, have in zip(jb["states"], ttr2._states):
        for a, b in zip(saved, have):
            onp.testing.assert_array_equal(b.numpy(), a)
    assert ttr2.optimizer.num_update == jb["num_update"]
    jnet2 = _pair()[0]
    jtr2 = jmx.gluon.Trainer(jnet2.collect_params(), *opt)
    jtr2.load_states(tf)
    assert jtr2._optimizer._index_update_count == tb["index_update_count"]
    for saved, have in zip(tb["states"], jtr2._states):
        for a, b in zip(saved, have):
            onp.testing.assert_array_equal(onp.asarray(b), a)


@pytest.mark.parametrize("opt", [("adam", {"learning_rate": 0.05}),
                                 ("sgd", {"learning_rate": 0.1,
                                          "momentum": 0.9})],
                         ids=["adam", "sgd_momentum"])
def test_trainer_resume_is_bit_identical(tmp_path, opt):
    """Save after step 2, continue 3 steps; a fresh net and trainer
    loaded from the files take the same 3 steps to the same bits."""
    x, y = _u((6, 3), 16), _u((6, 2), 17)
    _, net, _ = _pair()
    tr = tmx.gluon.Trainer(net.collect_params(), *opt)
    _steps(tmx, net, tr, x, y, 2)
    pf, sf = str(tmp_path / "net.params"), str(tmp_path / "tr.states")
    net.save_parameters(pf)
    tr.save_states(sf)
    _steps(tmx, net, tr, x, y, 3)
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    _, net2, _ = _pair()
    tr2 = tmx.gluon.Trainer(net2.collect_params(), *opt)
    _steps(tmx, net2, tr2, x, _u((6, 2), 18), 1)   # states exist already
    ptrs = [p._var().data_ptr() for p in net2.collect_params().values()]
    states = [s[0].data_ptr() for s in tr2._states]
    net2.load_parameters(pf)
    tr2.load_states(sf)
    assert ptrs == [p._var().data_ptr()
                    for p in net2.collect_params().values()]
    assert states == [s[0].data_ptr() for s in tr2._states]
    _steps(tmx, net2, tr2, x, y, 3)
    for k, p in net2.collect_params().items():
        onp.testing.assert_array_equal(p.data().asnumpy(), want[k])
    assert tr2.optimizer.num_update == tr.optimizer.num_update
