"""The port's small top-level modules (``registry``, ``error``, ``log``,
``name``, ``attribute``, ``util``, ``random``, ``dlpack``, ``runtime``,
``compile_cache``, ``callback``, ``misc``, ``context``'s ``cpu_pinned``/
``gpu_memory_info`` and the top-level names) against the JAX package's,
on the CPU. Each behaviour is crossed once: the same calls on both
packages give the same names, values and errors; what differs by
design (the device a DLPack capsule names, the features a CUDA build
reports) is checked on the port alone. Exact comparisons throughout.
"""
import logging

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import NotPortedError

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODULES = ("registry", "error", "log", "name", "attribute", "util",
           "random", "dlpack", "runtime", "compile_cache", "callback",
           "misc", "initializer", "init")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _public(mod):
    """The public callables a module defines (not those it imports from
    the rest of its package)."""
    out = set()
    for n, v in vars(mod).items():
        m = getattr(v, "__module__", "") or ""
        if n.startswith("_") or not callable(v) or (
                m.startswith("mxnet_tpu.") and m != mod.__name__):
            continue
        out.add(n)
    return out


@pytest.mark.parametrize("mod", MODULES)
def test_module_names(mod):
    """Every public callable of the reference module is in the port's."""
    jm, tm = getattr(jmx, mod), getattr(tmx, mod)
    missing = sorted(n for n in _public(jm) if not hasattr(tm, n))
    assert not missing, missing


def test_top_level_names():
    for name in ("AttrScope", "rnd", "cpu_pinned", "gpu_memory_info",
                 "init", "initializer", "random", "util", "runtime"):
        assert hasattr(jmx, name) and hasattr(tmx, name), name
    assert tmx.rnd is tmx.random
    assert tmx.AttrScope is tmx.attribute.AttrScope


def test_registry():
    out = {}
    for pkg in (jmx, tmx):
        class Base:
            pass

        register = pkg.registry.get_register_func(Base, "thing")
        alias = pkg.registry.get_alias_func(Base, "thing")
        create = pkg.registry.get_create_func(Base, "thing")

        @alias("other")
        @register
        class Foo(Base):
            def __init__(self, a=1):
                self.a = a

        f = create("foo", a=3)
        g = create('{"name": "other", "a": 5}')
        with pytest.raises(ValueError):
            create("nothing")
        with pytest.raises(TypeError):
            register(int)
        out[pkg] = (type(f).__name__, f.a, g.a, create(f) is f,
                    sorted(pkg.registry.get_registry(Base)))
    assert out[jmx] == out[tmx]


def test_error_types():
    for pkg in (jmx, tmx):
        err = pkg.error
        assert issubclass(err.ValueError, ValueError)
        assert issubclass(err.ValueError, pkg.base.MXNetError)
        assert err.get_error_type("IndexError") is err.IndexError
        assert err.get_error_type("nothing") is None

        @err.register_error
        class MyError(pkg.base.MXNetError):
            pass
        assert err.get_error_type("MyError") is MyError
    msgs = [str(pkg.error.NotImplementedForSymbol("f", "g", 1))
            for pkg in (jmx, tmx)]
    assert msgs[0] == msgs[1]


def test_log_name_attribute():
    lg = tmx.log.get_logger("mx_port_test", level=tmx.log.INFO)
    assert lg is tmx.log.getLogger("mx_port_test")
    assert lg.level == logging.INFO and len(lg.handlers) == 1
    res = []
    for pkg in (jmx, tmx):
        nm = pkg.name.NameManager()
        names = [nm.get(None, "conv"), nm.get(None, "conv"),
                 nm.get("given", "conv")]
        with pkg.name.Prefix("p_") as pre:
            names.append(pkg.name.current().get(None, "fc"))
            assert pkg.name.current() is pre
        with pkg.attribute.AttrScope(group="a") as outer:
            with pkg.attribute.AttrScope(lr="2"):
                attrs = pkg.attribute.current().get({"x": "1"})
            assert pkg.attribute.current() is outer
        with pytest.raises(ValueError):
            pkg.attribute.AttrScope(x=1)
        res.append((names, attrs))
    assert res[0] == res[1]


def test_util():
    for pkg in (jmx, tmx):
        u = pkg.util
        assert u.is_np_shape() and u.is_np_array()
        with u.np_shape(True), u.np_array(True):
            pass
        f = u.use_np(lambda x: x + 1)
        assert f(1) == 2 and u.use_np_shape(len)("ab") == 2
        assert not u.is_np_default_dtype()
        with u.np_default_dtype(True):
            assert u.is_np_default_dtype()
        assert not u.is_np_default_dtype()

        @u.use_np_default_dtype
        def dt():
            return str(pkg.np.ones((2,)).dtype)
        assert dt() == "float64" and not u.is_np_default_dtype()
        with pytest.raises(TypeError):
            u.use_np_default_dtype(3)
        assert u.np_ufunc_legal_option("casting", "same_kind")
        assert not u.np_ufunc_legal_option("order", "F")
    assert tmx.util.get_gpu_count() == torch.cuda.device_count()
    with pytest.raises(ValueError):
        tmx.util.get_cuda_compute_capability(tmx.cpu())


def test_random_seed_repeats_draws():
    tmx.random.seed(7)
    a = tmx.random.uniform(size=(5,)).asnumpy()
    tmx.rnd.seed(7, ctx="all")
    b = tmx.random.uniform(size=(5,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    for name in ("normal", "randint", "poisson", "exponential", "gamma",
                 "multinomial", "shuffle", "randn", "beta", "laplace",
                 "negative_binomial"):
        assert getattr(tmx.random, name) is getattr(tmx.np.random, name)


def test_dlpack_round_trip_shares_memory():
    x = tmx.np.array(onp.arange(6, dtype="f4").reshape(2, 3))
    for export in (tmx.dlpack.to_dlpack_for_read,
                   tmx.dlpack.to_dlpack_for_write):
        y = tmx.dlpack.from_dlpack(export(x))
        assert y._data.data_ptr() == x._data.data_ptr()
        assert y.ctx == x.ctx and y.dtype == x.dtype
        onp.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
    # a write through the consumer is seen by the exporter
    t = torch.utils.dlpack.from_dlpack(tmx.dlpack.to_dlpack_for_write(x))
    t[0, 0] = 42.0
    assert x.asnumpy()[0, 0] == 42.0
    # the reference's capsule round trip gives the same values
    j = jmx.dlpack.from_dlpack(jmx.dlpack.to_dlpack_for_read(
        jmx.np.array(x.asnumpy())))
    onp.testing.assert_array_equal(j.asnumpy(), x.asnumpy())
    # any object speaking __dlpack__
    z = tmx.dlpack.from_dlpack(torch.ones(3))
    assert z.asnumpy().tolist() == [1.0, 1.0, 1.0]


def test_runtime_features():
    feats = tmx.runtime.Features()
    jfeats = jmx.runtime.Features()
    assert set(jfeats) <= set(feats)
    assert not feats.is_enabled("tpu") and not feats.is_enabled("PALLAS")
    assert feats.is_enabled("CUDA") == (torch.version.cuda is not None
                                        and torch.cuda.is_available())
    assert feats.is_enabled("NVRTC") == feats.is_enabled("CUDA_RTC")
    with pytest.raises(RuntimeError, match="unknown"):
        feats.is_enabled("NOPE")
    assert [f.name for f in tmx.runtime.feature_list()] == list(feats)
    assert repr(tmx.runtime.Feature("X", True)).endswith("X")


def test_compile_cache(tmp_path, monkeypatch):
    from mxnet_tpu_torch import _build
    cc = tmx.compile_cache
    before = _build.BUILD_DIR
    monkeypatch.delenv("MXTPU_COMPILE_CACHE_DIR", raising=False)
    assert cc.configure() is None and _build.BUILD_DIR == before
    assert cc.enabled() and cc.cache_dir() == str(before)
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "t"))
    try:
        assert cc.configure(str(tmp_path)) == str(tmp_path)
        assert cc.cache_dir() == str(tmp_path)
        assert cc.entry_count() == 0
        (tmp_path / "libk-abc.so").write_bytes(b"")
        assert cc.entry_count() == 1
        prev = tmx.telemetry.set_enabled(True)
        try:
            n = tmx.telemetry.counter_value("compile_cache.miss")
            with cc.measure():
                (tmp_path / "libk-def.so").write_bytes(b"")
            assert tmx.telemetry.counter_value("compile_cache.miss") == n + 1
        finally:
            tmx.telemetry.set_enabled(prev)
    finally:
        _build.BUILD_DIR = before


def test_callbacks(caplog, tmp_path):
    class Metric:
        def __init__(self):
            self.resets = 0

        def get_name_value(self):
            return [("acc", 0.5)]

        def reset(self):
            self.resets += 1

    m = Metric()
    p = tmx.callback.BatchEndParam(epoch=1, nbatch=0, eval_metric=m,
                                   locals=None)
    with caplog.at_level(logging.INFO):
        sp = tmx.callback.Speedometer(batch_size=4, frequent=2)
        for n in range(5):
            sp(p._replace(nbatch=n))
        tmx.callback.log_train_metric(2, auto_reset=True)(p)
        tmx.callback.ProgressBar(total=4)(p._replace(nbatch=2))
        tmx.callback.LogValidationMetricsCallback()(p)
    text = caplog.text
    assert "samples/sec" in text and "Train-acc" in text
    assert "Validation-acc" in text and "[" in text
    assert m.resets == 3
    # do_checkpoint (item 18a) writes prefix-NNNN.params every period
    prefix = str(tmp_path / "ck")
    tmx.callback.do_checkpoint(prefix)(0, None, {"w": tmx.np.ones(2)}, {})
    arg, aux = tmx.model.load_params(prefix, 1)
    assert list(arg) == ["w"] and aux == {}


def test_misc_and_context():
    assert tmx.misc.FactorScheduler is tmx.lr_scheduler.FactorScheduler
    sched = tmx.misc.FactorScheduler(step=2, factor=0.5, base_lr=1.0)
    jsched = jmx.misc.FactorScheduler(step=2, factor=0.5, base_lr=1.0)
    assert [sched(i) for i in range(6)] == [jsched(i) for i in range(6)]
    assert issubclass(tmx.misc.LearningRateScheduler,
                      tmx.lr_scheduler.LRScheduler)
    pinned = tmx.cpu_pinned(0)
    assert pinned.device_type == "cpu_pinned"
    assert pinned.torch_device == torch.device("cpu")
    assert str(pinned) == str(jmx.cpu_pinned(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.gpu_memory_info(0)
        with pytest.raises(RuntimeError):
            tmx.util.get_gpu_memory(0)
