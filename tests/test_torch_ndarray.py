"""The port's NDArray (mxnet_tpu_torch.ndarray) against the JAX
package's on the same numpy inputs, both on the CPU (the port under
``with mx.cpu():``).

Covered: creation and the dtype policy (float32 default, 64→32-bit
narrowing, OverflowError), get/set indexing with NDArray and float
indices, the operator dunders, ``astype``/``copyto``/
``as_in_context``/``detach``, the functional write (a write after
``record()`` leaves the earlier gradients right) and the device rule
(array creation without a context raises on a machine without a card).
Tolerances: elementwise fp32 rtol=1e-6, atol=1e-6; dtypes and shapes
equal.
"""
import operator as op

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EW = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _same(t, j):
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape, (t.shape, j.shape)
    onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **EW)


R = onp.random.RandomState(0)
X = R.uniform(-2, 2, (3, 4)).astype("f4")
Y = R.uniform(0.5, 2, (3, 4)).astype("f4")
I = R.randint(1, 9, (3, 4)).astype("i4")


@pytest.mark.parametrize("obj,dtype", [
    ([1, 2, 3], None), ([[1.5, 2.0]], None), (3.0, None), (True, None),
    (onp.arange(4), None), (onp.arange(4, dtype="i8"), None),
    (onp.ones(3, "f8"), None), (onp.ones(3, "f2"), None),
    (onp.array([True, False]), None), (onp.arange(3, dtype="u1"), None),
    ([1, 2], "int64"), ([1.7, -2.2], "int32"), (onp.arange(3), "float16"),
    ([1, 2], "float64"), ([0, 1], "bool"), (onp.ones(2, "f4"), "uint8"),
], ids=lambda v: repr(v)[:20])
def test_creation_dtype_policy(obj, dtype):
    _same(tmx.np.array(obj, dtype=dtype), jmx.np.array(obj, dtype=dtype))


@pytest.mark.parametrize("obj,dtype", [
    (onp.array([2 ** 40], "i8"), None), ([1e12], "int64"),
    ([float("nan")], "int64")])
def test_overflow_raises_like_reference(obj, dtype):
    for pkg in (tmx, jmx):
        with pytest.raises(OverflowError):
            pkg.np.array(obj, dtype=dtype)


def test_bfloat16_resolves_to_torch():
    a = tmx.np.array([1.5, 2.0], dtype="bfloat16")
    assert a.dtype == torch.bfloat16 == tmx.np.bfloat16
    onp.testing.assert_array_equal(a.asnumpy(), [1.5, 2.0])


def test_array_without_context_raises_without_a_card():
    """In a thread with no context scope the default is gpu(0), which
    raises here; so does asking for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is "
                    "the CUDA-less refusal")
    import threading
    seen = []

    def make():
        try:
            tmx.np.array([1.0])
        except RuntimeError as e:
            seen.append((tmx.current_context(), str(e)))

    th = threading.Thread(target=make)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert len(seen) == 1 and seen[0][0] == tmx.gpu(0)
    assert "device='cpu'" in seen[0][1]
    with tmx.gpu(0):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmx.np.zeros((2,))
    assert tmx.context.default_context() == tmx.gpu(0)


def test_context_surface():
    assert tmx.cpu() == tmx.Context("cpu", 0) != tmx.gpu(0)
    assert tmx.gpu(1).device_type == "gpu" and str(tmx.gpu(1)) == "gpu(1)"
    assert tmx.current_context() == tmx.cpu()
    with tmx.gpu(0):
        assert tmx.current_context() == tmx.gpu(0)
    assert tmx.current_context() == tmx.cpu()
    with pytest.raises(ValueError, match="gpu"):
        tmx.context.tpu()
    with pytest.raises(ValueError):
        tmx.Context("tpu")
    free, total = tmx.cpu().memory_info()
    assert 0 < free <= total
    tmx.cpu().empty_cache()
    assert tmx.num_gpus() == torch.cuda.device_count()


def test_properties_and_conversion():
    t, j = tmx.np.array(X), jmx.np.array(X)
    for attr in ("shape", "dtype", "size", "ndim", "stype"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert len(t) == len(j) == 3
    assert t.ctx == t.context == t.device == tmx.cpu()
    onp.testing.assert_array_equal(t.asnumpy(), X)
    onp.testing.assert_array_equal(onp.asarray(t), X)
    assert t.tolist() == j.tolist()
    assert t[1, 2].item() == j[1, 2].item()
    assert float(t[0, 0]) == float(j[0, 0])
    assert int(tmx.np.array(I)[0, 1]) == int(I[0, 1])
    _same(t.T, j.T)
    # the host copy is a copy: writing to it leaves the array alone
    h = t.asnumpy()
    h[:] = 0
    onp.testing.assert_array_equal(t.asnumpy(), X)
    back = torch.from_dlpack(t)
    onp.testing.assert_array_equal(back.numpy(), X)


BINOPS = [op.add, op.sub, op.mul, op.truediv, op.floordiv, op.mod,
          op.pow, op.eq, op.ne, op.lt, op.le, op.gt, op.ge]


@pytest.mark.parametrize("fn", BINOPS, ids=lambda f: f.__name__)
def test_binary_dunders(fn):
    a, b = (X, Y) if fn is not op.pow else (Y, X)
    _same(fn(tmx.np.array(a), tmx.np.array(b)),
          fn(jmx.np.array(a), jmx.np.array(b)))
    _same(fn(tmx.np.array(a), 1.5), fn(jmx.np.array(a), 1.5))
    _same(fn(2.0, tmx.np.array(b)), fn(2.0, jmx.np.array(b)))
    # a numpy array on the left defers to the NDArray's reflected op
    _same(fn(a, tmx.np.array(b)), fn(a, jmx.np.array(b)))


@pytest.mark.parametrize("fn", [op.and_, op.or_, op.xor, op.lshift,
                                op.rshift], ids=lambda f: f.__name__)
def test_integer_dunders(fn):
    a, b = I, (I % 3).astype("i4")
    _same(fn(tmx.np.array(a), tmx.np.array(b)),
          fn(jmx.np.array(a), jmx.np.array(b)))
    _same(fn(tmx.np.array(a), 2), fn(jmx.np.array(a), 2))


def test_unary_dunders_and_matmul():
    t, j = tmx.np.array(X), jmx.np.array(X)
    _same(-t, -j)
    _same(+t, +j)
    _same(abs(t), abs(j))
    _same(~tmx.np.array(I), ~jmx.np.array(I))
    w = R.uniform(-1, 1, (4, 2)).astype("f4")
    _same(t @ tmx.np.array(w), j @ jmx.np.array(w))
    q, r = divmod(tmx.np.array(Y), 0.7)
    jq, jr = divmod(jmx.np.array(Y), 0.7)
    _same(q, jq)
    _same(r, jr)


#: the operator and method forms on uint16/uint32 arrays (holding 0
#: and the dtype's maximum): they follow the mx.np functions' int64 route
WIDE_FORMS = [
    ("neg", op.neg), ("abs", abs), ("max_axis0", lambda a: a.max(axis=0)),
    ("max", lambda a: a.max()), ("min_axis1", lambda a: a.min(axis=1)),
    ("argmax", lambda a: a.argmax()),
    ("argmax_axis1", lambda a: a.argmax(axis=1)),
    ("argmin_axis0", lambda a: a.argmin(axis=0)),
    ("clip", lambda a: a.clip(2, 600)), ("abs_method", lambda a: a.abs()),
    ("prod_axis1", lambda a: a.prod(axis=1)), ("invert", op.invert),
]


@pytest.mark.parametrize("dt", ["uint16", "uint32"])
@pytest.mark.parametrize("fn", [f for _, f in WIDE_FORMS],
                         ids=[n for n, _ in WIDE_FORMS])
def test_wide_unsigned_operator_forms(fn, dt):
    a = onp.random.RandomState(3).randint(1, 1000, (3, 4)).astype(dt)
    a[1, 0], a[0, 2] = 0, onp.iinfo(dt).max
    t, j = fn(tmx.np.array(a)), fn(jmx.np.array(a))
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape
    onp.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


#: the NDArray forms of the ops torch refuses on a bool array
BOOL_FORMS = [
    ("argmax", lambda a: a.argmax()),
    ("argmax_axis0", lambda a: a.argmax(axis=0)),
    ("argmin", lambda a: a.argmin()),
    ("argmin_axis1", lambda a: a.argmin(axis=1)),
    ("abs_dunder", abs), ("abs_method", lambda a: a.abs()),
    ("relu_method", lambda a: a.relu()),
]


@pytest.mark.parametrize("fn", [f for _, f in BOOL_FORMS],
                         ids=[n for n, _ in BOOL_FORMS])
def test_bool_operator_forms(fn):
    a = onp.array([[True, False, True], [False, False, True]])
    t, j = fn(tmx.np.array(a)), fn(jmx.np.array(a))
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape
    onp.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


#: the operator forms of products of two dtypes and of bool arithmetic
#: (``@``, ``-``, ``//``, ``%``, ``**``, ``<<``, ``>>``): they take the
#: mx.np functions' promotion and int32 routes
BM = R.rand(3, 4) > 0.5
BN = R.rand(3, 4) > 0.5
MIXED_FORMS = [
    ("matmul_f16_f32", op.matmul, X.astype("f2"), Y.T),
    ("matmul_i32_f32", op.matmul, I, Y.T),
    ("matmul_u8_i8", op.matmul, I.astype("u1"), (I - 4).T.astype("i1")),
    ("matmul_i32", op.matmul, I, I.T),
    ("matmul_bool", op.matmul, BM, BN.T),
    ("matmul_bool_i32", op.matmul, BM, I.T),
    ("sub_bool_i32", op.sub, BM, I), ("rsub_bool_f32", op.sub, X, BM),
    ("sub_bool_int", op.sub, BM, 3), ("rsub_bool_int", op.sub, 3, BM),
    ("floordiv_bool", op.floordiv, BM, onp.ones_like(BM)),
    ("mod_bool", op.mod, BM, onp.ones_like(BM)),
    ("pow_bool", op.pow, BM, BN), ("lshift_bool", op.lshift, BM, BN),
    ("rshift_bool", op.rshift, BM, BN),
]


@pytest.mark.parametrize("fn,a,b", [c[1:] for c in MIXED_FORMS],
                         ids=[c[0] for c in MIXED_FORMS])
def test_mixed_and_bool_operator_forms(fn, a, b):
    def lift(pkg, x):
        return pkg.np.array(x) if isinstance(x, onp.ndarray) else x
    t, j = fn(lift(tmx, a), lift(tmx, b)), fn(lift(jmx, a), lift(jmx, b))
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape
    tol = dict(rtol=2e-3, atol=2e-3) if onp.asarray(a).dtype == onp.float16 \
        else dict(rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(t.asnumpy().astype("f8"),
                                j.asnumpy().astype("f8"), **tol)


def test_inplace_dunders_bump_version():
    t, j = tmx.np.array(X), jmx.np.array(X)
    v = t._version
    for fn in (op.iadd, op.isub, op.imul, op.itruediv):
        t = fn(t, 1.5)
        j = fn(j, 1.5)
    assert t._version == v + 4
    _same(t, j)


def test_methods():
    t, j = tmx.np.array(X), jmx.np.array(X)
    _same(t.reshape(2, 6), j.reshape(2, 6))
    _same(t.reshape((4, 3)), j.reshape((4, 3)))
    _same(t.transpose(), j.transpose())
    _same(t.flatten(), j.flatten())
    _same(t.expand_dims(0), j.expand_dims(0))
    _same(t.sum(axis=1), j.sum(axis=1))
    _same(t.mean(), j.mean())
    _same(t.max(axis=0, keepdims=True), j.max(axis=0, keepdims=True))
    _same(t.clip(-1, 1), j.clip(-1, 1))
    _same(t.exp(), j.exp())
    _same(t.sigmoid(), j.sigmoid())
    _same(t.relu(), j.relu())
    _same(t.slice_axis(1, 1, 3), j.slice_axis(1, 1, 3))
    for a, b in zip(t.split(2, axis=1), j.split(2, axis=1)):
        _same(a, b)
    _same(t.cumsum(), j.cumsum())
    _same(t.cumsum(axis=1), j.cumsum(axis=1))
    _same(t.var(), j.var())
    _same(t.var(axis=0, ddof=1), j.var(axis=0, ddof=1))
    _same(t.round(1), j.round(1))
    _same(t.take(tmx.np.array(onp.array([0, 5, 11], "i4"), dtype="int32")),
          j.take(jmx.np.array(onp.array([0, 5, 11], "i4"), dtype="int32")))
    _same(t.repeat(2, axis=0), j.repeat(2, axis=0))
    for a, b in zip(t.nonzero(), j.nonzero()):
        _same(a, b)
    _same(t.all(), j.all())
    _same(t.any(axis=0), j.any(axis=0))
    _same(t.swapaxes(0, 1), j.swapaxes(0, 1))


@pytest.mark.parametrize("dtype", ["int32", "float16", "bool", "float64",
                                   "int64", "uint8"])
def test_astype(dtype):
    # a negative float cast to an unsigned type is undefined in C and
    # differs between backends: the uint8 case casts magnitudes
    v = onp.abs(X * 3) if dtype == "uint8" else X * 3
    _same(tmx.np.array(v).astype(dtype), jmx.np.array(v).astype(dtype))


def test_astype_no_copy_and_copies():
    t = tmx.np.array(X)
    assert t.astype("float32", copy=False) is t
    c = t.copy()
    assert c is not t and c._data.data_ptr() != t._data.data_ptr()
    onp.testing.assert_array_equal(c.asnumpy(), X)
    assert t.as_in_context(tmx.cpu()) is t
    m = t.copyto(tmx.cpu())
    assert m is not t and m.ctx == tmx.cpu()
    dst = tmx.np.zeros((3, 4), dtype="int32")
    assert t.copyto(dst) is dst
    _same(dst, jmx.np.array(X).copyto(jmx.np.zeros((3, 4), dtype="int32")))


GETS = [
    (1,), (slice(1, 3),), ((1, slice(None, None, 2)),), ((Ellipsis, 2),),
    ((None, 1),), (-1,),
]


@pytest.mark.parametrize("key", GETS, ids=lambda k: repr(k)[:20])
def test_getitem_basic(key):
    _same(tmx.np.array(X)[key[0]], jmx.np.array(X)[key[0]])


@pytest.mark.parametrize("idx", [
    onp.array([0, 2], "f4"), onp.array([2, 0, 2], "i4"),
    onp.array([True, False, True])], ids=["float", "int", "bool"])
def test_getitem_ndarray_index(idx):
    t, j = tmx.np.array(X), jmx.np.array(X)
    _same(t[tmx.np.array(idx)], j[jmx.np.array(idx)])
    if idx.dtype != bool:
        _same(t[1, tmx.np.array(idx)], j[1, jmx.np.array(idx)])
        _same(t[tmx.np.array(idx), 1:3], j[jmx.np.array(idx), 1:3])


SETS = [
    (slice(None), 5.0), (Ellipsis, onp.arange(4, dtype="f4")), ((), 1.0),
    (1, 7.0), ((0, 2), -3.0), (slice(0, 2), onp.ones((2, 4), "f4")),
    ((slice(None), 1), onp.arange(3, dtype="f4")),
]


@pytest.mark.parametrize("key,val", SETS, ids=lambda v: repr(v)[:20])
def test_setitem(key, val):
    t, j = tmx.np.array(X), jmx.np.array(X)
    t[key] = val
    j[key] = val
    _same(t, j)


@pytest.mark.parametrize("idx", [onp.array([0, 2], "f4"),
                                 onp.array([2, 1], "i4")],
                         ids=["float", "int"])
def test_setitem_ndarray_index_and_value(idx):
    t, j = tmx.np.array(X), jmx.np.array(X)
    v = R.uniform(size=(2, 4)).astype("f4")
    t[tmx.np.array(idx)] = tmx.np.array(v)
    j[jmx.np.array(idx)] = jmx.np.array(v)
    _same(t, j)
    # a value of another dtype takes the target's dtype
    ti, ji = tmx.np.array(I), jmx.np.array(I)
    ti[tmx.np.array(idx)] = tmx.np.array(v * 10)
    ji[jmx.np.array(idx)] = jmx.np.array(v * 10)
    _same(ti, ji)


A10 = onp.arange(10, dtype="f4")
IDX = onp.array([0, 2], "i4")
#: negative-step slices (torch refuses them; the port flips): (array,
#: key), with ``"idx"`` standing for an NDArray index
NEG_GETS = [
    (A10, slice(None, None, -1)), (A10, slice(8, 2, -3)),
    (A10, slice(5, 5, -1)), (A10, slice(-2, None, -4)),
    (X, (-1, slice(None, None, -1))), (X, (slice(None, None, -1), "idx")),
    (X, (Ellipsis, slice(None, None, -2))),
    (X, (slice(None, None, -2), None, slice(1, None))),
    (X, (slice(None, None, -1), slice(3, 0, -2))),
]


def _key(pkg, key):
    items = key if isinstance(key, tuple) else (key,)
    out = tuple(pkg.np.array(IDX) if k == "idx" else k for k in items)
    return out if isinstance(key, tuple) else out[0]


@pytest.mark.parametrize("a,key", NEG_GETS,
                         ids=[repr(k) for _, k in NEG_GETS])
def test_getitem_negative_step(a, key):
    _same(tmx.np.array(a)[_key(tmx, key)], jmx.np.array(a)[_key(jmx, key)])


NEG_SETS = [
    (slice(None, None, -1), onp.arange(4, dtype="f4") * 10),
    (slice(None, None, -1), X * 10),
    ((1, slice(None, None, -2)), onp.array([7, 8], "f4")),
    ((slice(None, None, -1), "idx"), 5.0),
    ((slice(2, 0, -1), slice(None, None, -3)), onp.ones((2, 2), "f4")),
]


@pytest.mark.parametrize("key,val", NEG_SETS,
                         ids=[f"{k!r}-{i}" for i, (k, _) in
                              enumerate(NEG_SETS)])
def test_setitem_negative_step(key, val):
    t, j = tmx.np.array(X), jmx.np.array(X)
    t[_key(tmx, key)] = val
    j[_key(jmx, key)] = val
    _same(t, j)


def test_setitem_is_functional_and_checks_shape():
    t = tmx.np.array(X)
    view = t[0]
    before = t._data
    t[0] = 9.0
    # a new tensor was installed; the earlier read and tensor keep
    # their values
    assert t._data is not before and t._version == 1
    onp.testing.assert_array_equal(view.asnumpy(), X[0])
    onp.testing.assert_array_equal(before.numpy(), X)
    with pytest.raises(ValueError):
        t[...] = onp.ones((5, 4), "f4")


def test_write_after_record_keeps_earlier_grads():
    """The forward's saved values are the ones before the write: the
    gradient is 2*x of the old x, as in the reference."""
    grads = []
    for pkg in (tmx, jmx):
        x = pkg.np.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x).sum()
        x[:] = 10.0
        x[1] = -4.0
        y.backward()
        grads.append(x.grad.asnumpy())
        onp.testing.assert_array_equal(x.asnumpy(), [10.0, -4.0, 10.0])
    onp.testing.assert_allclose(grads[0], grads[1], **EW)
    onp.testing.assert_allclose(grads[0], [2.0, 4.0, 6.0], **EW)


def test_written_variable_stays_on_the_tape():
    x = tmx.np.array([1.0, 2.0])
    x.attach_grad()
    x[:] = tmx.np.array([3.0, 4.0])
    x.copyto(x)
    with tmx.autograd.record():
        y = (x * x).sum()
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [6.0, 8.0], **EW)


def test_detach():
    for pkg in (tmx, jmx):
        x = pkg.np.array([2.0])
        x.attach_grad()
        with pkg.autograd.record():
            d = (x * 3).detach()
            assert not pkg.autograd._on_tape(d)
            y = (d * x).sum()
        y.backward()
        onp.testing.assert_allclose(x.grad.asnumpy(), [6.0])


def test_waitall_and_engine(tmp_path):
    from mxnet_tpu_torch import engine, telemetry
    a = tmx.np.array(X) * 2
    a.wait_to_read()
    tmx.waitall()
    tmx.nd.waitall()
    assert isinstance(tmx.nd.NDArray, type)
    assert telemetry.gauge_value("engine.live_arrays") == 0
    prev = engine.engine_type()
    try:
        engine.set_engine_type("NaiveEngine")
        assert engine.is_naive()
        onp.testing.assert_allclose((tmx.np.array(X) + 1).asnumpy(), X + 1)
    finally:
        engine.set_engine_type(prev)
    with pytest.warns(UserWarning, match="no-op"):
        engine.bulk._warned = False
        with engine.bulk(8):
            pass
    # nd.save/nd.load (item 18a) round-trip a dict
    path = str(tmp_path / "nd.npz")
    tmx.nd.save(path, {"x": tmx.np.array(X)})
    onp.testing.assert_array_equal(tmx.nd.load(path)["x"].asnumpy(), X)


#: ROADMAP queue 3, F3: negative-step slices of every dtype, read and
#: written (uint16/uint32 move through a signed view of their width)
F3_DT = ["bool", "uint8", "uint16", "uint32", "int8", "int16", "int32",
         "float16", "float32"]


def _moved(dt):
    a = onp.random.RandomState(30).randint(0, 100, (3, 4)).astype(dt)
    if dt in ("uint16", "uint32"):
        a[2, 1] = onp.iinfo(dt).max
    return a


@pytest.mark.parametrize("dt", F3_DT)
@pytest.mark.parametrize("key", [slice(None, None, -1),
                                 (slice(None, None, -2), slice(1, None)),
                                 (Ellipsis, slice(3, 0, -2))],
                         ids=["rev", "rev2", "ell"])
def test_negative_step_every_dtype(dt, key):
    a = _moved(dt)
    _same(tmx.np.array(a)[key], jmx.np.array(a)[key])
    t, j = tmx.np.array(a), jmx.np.array(a)
    val = onp.flip(a[key], 0).copy()
    t[key] = val
    j[key] = val
    _same(t, j)
