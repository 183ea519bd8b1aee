"""The port's mx.np / mx.npx functions (mxnet_tpu_torch.numpy and
.numpy_extension) against the JAX package's on the same numpy inputs,
both on the CPU (the port under ``with mx.cpu():``).

Tolerances: elementwise fp32 rtol=1e-6, atol=1e-6; reductions, matmul
and softmax 1e-5 (another summation order); dtypes and shapes equal.
Random functions are compared by shape, dtype, range and moments only:
torch's Philox/Mersenne streams and JAX's Threefry differ.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EW = dict(rtol=1e-6, atol=1e-6)
RED = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(*shape, lo=-2.0, hi=2.0, seed=0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype("f4")


def _ints(*shape, lo=-20, hi=20, seed=1):
    return onp.random.RandomState(seed).randint(lo, hi, shape).astype("i4")


def _lift(pkg, a):
    return pkg.np.array(a) if isinstance(a, onp.ndarray) else a


def _run(pkg, fn, args, kw):
    out = getattr(pkg.np, fn)(*[_lift(pkg, a) for a in args], **kw)
    return out


def _same(t, j, tol):
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b, tol)
        return
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape, (t.shape, j.shape)
    tn, jn = t.asnumpy(), j.asnumpy()
    if onp.issubdtype(jn.dtype, onp.inexact):
        onp.testing.assert_allclose(tn, jn, **tol)
    else:
        onp.testing.assert_array_equal(tn, jn)


X = _rand(3, 4)
Y = _rand(3, 4, seed=2)
P = _rand(3, 4, lo=0.1, hi=3.0, seed=3)
I = _ints(3, 4)
J = _ints(3, 4, lo=1, hi=7, seed=4)
S = _ints(3, 4, lo=0, hi=5, seed=5)
B = X > 0

BINARY = [
    ("add", X, Y), ("subtract", X, Y), ("multiply", X, Y),
    ("divide", X, P), ("true_divide", I, J), ("floor_divide", X, P),
    ("floor_divide", I, J), ("mod", X, P), ("mod", I, J),
    ("remainder", I, J), ("power", P, Y), ("power", I, 2),
    ("maximum", X, Y), ("minimum", X, Y),
    ("bitwise_and", I, J), ("bitwise_or", I, J), ("bitwise_xor", I, J),
    ("left_shift", S, S), ("right_shift", J, S),
    ("equal", I, J), ("not_equal", X, Y), ("less", X, Y),
    ("less_equal", X, Y), ("greater", X, Y), ("greater_equal", X, Y),
    # scalars promote like weak-typed scalars
    ("add", I, 2), ("multiply", I, 2.5), ("subtract", 3.0, X),
    ("add", B, 1), ("true_divide", 1, J), ("maximum", X, 0.0),
    ("power", 2.0, X), ("add", X, onp.float32(1.5)), ("add", 2, 3.5),
]


@pytest.mark.parametrize("fn,a,b", BINARY,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(BINARY)])
def test_binary(fn, a, b):
    _same(_run(tmx, fn, (a, b), {}), _run(jmx, fn, (a, b), {}), EW)


U8 = onp.arange(1, 13, dtype="u1").reshape(3, 4)
#: binary ops mixing uint16/uint32 with integers: the reference takes
#: NumPy's promotion table with x64 off (torch refuses to promote them)
UNSIGNED = [
    ("add", U8.astype("u4"), I), ("add", U8.astype("u2"), U8),
    ("multiply", U8.astype("u2"), I.astype("i2")),
    ("subtract", U8.astype("u4"), I.astype("i1")),
    ("maximum", U8.astype("u4"), I), ("less", U8.astype("u4"), I),
    ("bitwise_and", U8.astype("u2"), U8), ("add", U8.astype("u4"), B),
    ("add", U8.astype("u4"), U8.astype("u4")), ("add", U8.astype("u4"), 2),
    ("multiply", U8.astype("u4"), 2.5), ("add", 3, U8.astype("u2")),
    ("true_divide", U8.astype("u4"), J),
]


@pytest.mark.parametrize("fn,a,b", UNSIGNED,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(UNSIGNED)])
def test_unsigned_promotion(fn, a, b):
    _same(_run(tmx, fn, (a, b), {}), _run(jmx, fn, (a, b), {}), EW)


@pytest.mark.parametrize("fn", ["sum", "prod"])
@pytest.mark.parametrize("dt", ["uint8", "uint16", "uint32"])
@pytest.mark.parametrize("axis", [None, 1])
def test_unsigned_reductions_give_uint32(fn, dt, axis):
    a = (U8 % 3 + 1).astype(dt)
    _same(_run(tmx, fn, (a,), {"axis": axis}),
          _run(jmx, fn, (a,), {"axis": axis}), EW)


def _wide(dt, seed=12):
    """numpy-seeded (3, 4) ``dt`` values holding 0 and the dtype's
    maximum, so that negative, square and prod wrap."""
    a = onp.random.RandomState(seed).randint(1, 1000, (3, 4)).astype(dt)
    a[0, 1], a[2, 3] = 0, onp.iinfo(dt).max
    return a


#: single-operand ops of uint16/uint32 arrays, which torch's kernels
#: refuse: the port computes them in int64 and casts an integer result
#: back (an index stays an index)
WIDE_UNARY = [
    ("negative", {}), ("abs", {}), ("absolute", {}), ("square", {}),
    ("sign", {}), ("clip", {"a_min": 3, "a_max": 500}),
    ("clip", {"a_min": 200}), ("max", {}), ("max", {"axis": 0}),
    ("amax", {"axis": 1, "keepdims": True}), ("min", {}),
    ("min", {"axis": 1}), ("argmax", {}), ("argmax", {"axis": 1}),
    ("argmin", {}), ("argmin", {"axis": 0}), ("prod", {}),
    ("prod", {"axis": 0}), ("invert", {}),
]


@pytest.mark.parametrize("dt", ["uint16", "uint32"])
@pytest.mark.parametrize("fn,kw", WIDE_UNARY,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(WIDE_UNARY)])
def test_wide_unsigned_unary_and_reductions(fn, kw, dt):
    a = _wide(dt)
    _same(_run(tmx, fn, (a,), kw), _run(jmx, fn, (a,), kw), EW)


@pytest.mark.parametrize("dt", ["uint16", "uint32"])
def test_wide_unsigned_negative_wraps(dt):
    a = onp.array([1, 5, 3], dt)
    t = tmx.np.negative(tmx.np.array(a))
    assert t.dtype == onp.dtype(dt)
    assert t.asnumpy().tolist() == [int(onp.iinfo(dt).max) + 1 - v
                                    for v in (1, 5, 3)]


@pytest.mark.parametrize("base,exp", [
    (I, -1), (U8, -1), (I, -2), (I, onp.int32(-1)), (B, -1)],
    ids=["int32", "uint8", "int32-2", "numpy-scalar", "bool"])
def test_integer_power_to_negative_integer_raises(base, exp):
    for pkg in (tmx, jmx):
        with pytest.raises(TypeError, match="negative powers"):
            pkg.np.power(pkg.np.array(base), exp)
        with pytest.raises(TypeError, match="negative powers"):
            pkg.np.array(base) ** exp


@pytest.mark.parametrize("base,exp", [(I, -1.0), (P, -1), (I, 0)],
                         ids=["float-exponent", "float-base", "zero"])
def test_power_negative_exponent_allowed(base, exp):
    _same(_run(tmx, "power", (base, exp), {}),
          _run(jmx, "power", (base, exp), {}), EW)


UNARY = [
    ("negative", X), ("positive", X), ("abs", X), ("absolute", I),
    ("sign", X), ("square", X), ("square", I), ("sqrt", P), ("exp", X),
    ("exp", I), ("log", P), ("tanh", X), ("invert", I),
    ("bitwise_not", I), ("copy", X),
]


@pytest.mark.parametrize("fn,a", UNARY,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(UNARY)])
def test_unary(fn, a):
    _same(_run(tmx, fn, (a,), {}), _run(jmx, fn, (a,), {}), EW)


X3 = _rand(2, 3, 4, seed=6)
REDUCE = [
    ("sum", {}), ("sum", {"axis": 0}), ("sum", {"axis": (0, 2)}),
    ("sum", {"axis": -1, "keepdims": True}), ("sum", {"keepdims": True}),
    ("mean", {}), ("mean", {"axis": 1}), ("mean", {"axis": [0, 1]}),
    ("max", {}), ("max", {"axis": 2}), ("max", {"axis": (0, 1),
                                               "keepdims": True}),
    ("min", {"axis": 0}), ("amax", {"axis": 1}), ("amin", {}),
    ("prod", {}), ("prod", {"axis": (0, 2)}),
    ("prod", {"axis": 1, "keepdims": True}), ("argmax", {"axis": 1}),
    ("argmin", {}),
]


@pytest.mark.parametrize("fn,kw", REDUCE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(REDUCE)])
def test_reduction(fn, kw):
    a = X3 * 0.5 if fn == "prod" else X3
    _same(_run(tmx, fn, (a,), kw), _run(jmx, fn, (a,), kw), RED)


@pytest.mark.parametrize("fn,a,kw", [
    ("sum", _ints(2, 3, 4), {"axis": 1}), ("sum", B, {}),
    ("mean", _ints(2, 3), {}), ("max", _ints(2, 3, 4), {"axis": 0}),
    ("prod", _ints(2, 3, lo=1, hi=4), {"axis": 1}),
    ("sum", X3, {"dtype": "float16"}),
], ids=["int_sum", "bool_sum", "int_mean", "int_max", "int_prod",
        "sum_dtype"])
def test_reduction_dtypes(fn, a, kw):
    _same(_run(tmx, fn, (a,), kw), _run(jmx, fn, (a,), kw),
          dict(rtol=1e-3, atol=1e-3) if "dtype" in kw else RED)


A = _rand(2, 3, 4, seed=7)
SHAPE = [
    ("reshape", (A, (4, 6)), {}), ("reshape", (A, (-1, 4)), {}),
    ("reshape", (A, 24), {}), ("transpose", (A,), {}),
    ("transpose", (A, (1, 0, 2)), {}), ("expand_dims", (A, 1), {}),
    ("expand_dims", (A, (0, -1)), {}),
    ("squeeze", (A[:, :1], ), {}), ("squeeze", (A[:1, :, :1], 2), {}),
    ("broadcast_to", (A[:, :1], (2, 5, 4)), {}), ("tile", (A, (2, 1, 2)),
                                                  {}),
    ("tile", (X, 2), {}), ("flip", (A,), {}), ("flip", (A, 1), {}),
    ("flip", (A, (0, 2)), {}), ("ravel", (A,), {}),
    ("concatenate", ([X, Y],), {}), ("concatenate", ([X, Y],),
                                     {"axis": 1}),
    ("concatenate", ([X, A[0]],), {"axis": None}),
    ("stack", ([X, Y],), {}), ("stack", ([X, Y],), {"axis": -1}),
    ("split", (A, 3), {"axis": 1}), ("split", (A, [1, 3]), {"axis": 2}),
    ("clip", (X, -0.5, 0.5), {}), ("clip", (X, None, 0.2), {}),
    ("where", (B, X, Y), {}), ("where", (X, X, 0.0), {}),
]


@pytest.mark.parametrize("fn,args,kw", SHAPE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SHAPE)])
def test_shape_and_select(fn, args, kw):
    def lift(pkg, a):
        if isinstance(a, list):
            return [pkg.np.array(x) for x in a]
        return _lift(pkg, a)
    t = getattr(tmx.np, fn)(*[lift(tmx, a) for a in args], **kw)
    j = getattr(jmx.np, fn)(*[lift(jmx, a) for a in args], **kw)
    _same(t, j, EW)


def test_split_unequal_raises():
    with pytest.raises(ValueError):
        tmx.np.split(tmx.np.array(A), 5, axis=1)
    with pytest.raises(ValueError):
        tmx.np.squeeze(tmx.np.array(A), axis=1)


MATMUL = [
    ("matmul", _rand(3, 5), _rand(5, 2, seed=8)),
    ("matmul", _rand(4, 3, 5), _rand(4, 5, 2, seed=8)),
    ("matmul", _rand(5), _rand(5, 2, seed=8)),
    ("matmul", _rand(5), _rand(5, seed=8)),
    ("dot", _rand(3, 5), _rand(5, 2, seed=8)),
    ("dot", _rand(5), _rand(5, seed=8)),
    ("dot", _rand(2, 3, 5), _rand(5, 4, seed=8)),
    ("dot", _rand(2, 3, 5), _rand(5, seed=8)),
    ("dot", _rand(3, 4), 2.0),
]


@pytest.mark.parametrize("fn,a,b", MATMUL,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MATMUL)])
def test_matmul_dot(fn, a, b):
    _same(_run(tmx, fn, (a, b), {}), _run(jmx, fn, (a, b), {}), RED)


def _typed(dt, shape, seed):
    """numpy-seeded ``dt`` values: floats in [-2, 2), signed integers in
    [-5, 6), uint8 in [0, 6), bools."""
    rs = onp.random.RandomState(seed)
    if dt == "bool":
        return rs.rand(*shape) > 0.5
    if dt.startswith("float"):
        return rs.uniform(-2, 2, shape).astype(dt)
    return rs.randint(0 if dt.startswith("u") else -5, 6, shape).astype(dt)


#: operand pairs of two dtypes (and a bool and an int product): the
#: reference promotes (int32 with float16 -> float16, uint8 with int8 ->
#: int16, bool with x -> x's type); integer and bool products are exact
MIXED_PAIRS = [
    ("float16", "float32"), ("int32", "float32"), ("int32", "float16"),
    ("int32", "int8"), ("uint8", "int8"), ("int16", "uint8"),
    ("bool", "float32"), ("int8", "bool"), ("bool", "bool"),
    ("int32", "int32"),
]
#: (a's shape, b's shape): vectors, a batch broadcast, dot's tensordot
MIXED_SHAPES = [((3, 4), (4, 2)), ((4,), (4,)), ((2, 3, 4), (1, 4, 2)),
                ((2, 3, 4), (4,)), ((2, 3, 4), (5, 4, 2))]


@pytest.mark.parametrize("fn", ["matmul", "dot"])
@pytest.mark.parametrize("shapes", MIXED_SHAPES,
                         ids=[f"{len(a)}d-{len(b)}d" for a, b in MIXED_SHAPES])
@pytest.mark.parametrize("da,db", MIXED_PAIRS,
                         ids=[f"{a}-{b}" for a, b in MIXED_PAIRS])
def test_mixed_dtype_products(fn, shapes, da, db):
    if fn == "matmul" and shapes == ((2, 3, 4), (5, 4, 2)):
        shapes = ((5, 3, 4), (5, 4, 2))
    a, b = _typed(da, shapes[0], 21), _typed(db, shapes[1], 22)
    _same(_run(tmx, fn, (a, b), {}), _run(jmx, fn, (a, b), {}),
          dict(rtol=2e-3, atol=2e-3) if "float16" in (da, db) else RED)


def test_integer_product_wraps_like_reference():
    a = onp.full((2, 300), 30000, "i4")
    _same(_run(tmx, "matmul", (a, a.T), {}), _run(jmx, "matmul", (a, a.T), {}),
          EW)


#: bool operands of the ops torch refuses on bool: ``subtract`` with one
#: bool operand computes in the other's type (a Python int gives int32),
#: the others of two bool arrays compute in int32
BM = _typed("bool", (3, 4), 23)
BN = _typed("bool", (3, 4), 24)
BOOL_ARITH = [
    ("subtract", BM, I), ("subtract", I, BM), ("subtract", BM, X),
    ("subtract", X, BM), ("subtract", BM, _typed("int8", (3, 4), 25)),
    ("subtract", _typed("uint8", (3, 4), 26), BM),
    ("subtract", _typed("float16", (3, 4), 27), BM),
    ("subtract", BM, 2), ("subtract", 2, BM), ("subtract", BM, 1.5),
    ("floor_divide", BM, onp.ones_like(BM)), ("mod", BM, onp.ones_like(BM)),
    ("remainder", BN, onp.ones_like(BN)), ("power", BM, BN),
    ("left_shift", BM, BN), ("right_shift", BM, BN),
]


@pytest.mark.parametrize("fn,a,b", BOOL_ARITH,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(BOOL_ARITH)])
def test_bool_arithmetic(fn, a, b):
    _same(_run(tmx, fn, (a, b), {}), _run(jmx, fn, (a, b), {}), EW)


CREATE = [
    ("zeros", ((2, 3),), {}), ("zeros", (4,), {"dtype": "int32"}),
    ("ones", ((2, 3),), {"dtype": "int64"}), ("empty", ((3,),), {}),
    ("full", ((2, 2), 7), {}), ("full", ((2,), True), {}),
    ("full", ((2,), 3), {"dtype": "int32"}), ("arange", (5,), {}),
    ("arange", (2, 10, 3), {}), ("arange", (0.5, 2.0, 0.25), {}),
    ("arange", (6,), {"dtype": "int32"}), ("linspace", (0, 1, 7), {}),
    ("linspace", (-2, 3, 6), {"endpoint": False}), ("eye", (3,), {}),
    ("eye", (3, 4, 1), {}), ("eye", (4,), {"k": -2, "dtype": "int32"}),
]


@pytest.mark.parametrize("fn,args,kw", CREATE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CREATE)])
def test_creation(fn, args, kw):
    _same(getattr(tmx.np, fn)(*args, **kw), getattr(jmx.np, fn)(*args, **kw),
          EW)


def test_linspace_retstep():
    t, ts = tmx.np.linspace(0, 2, 5, retstep=True)
    j, js = jmx.np.linspace(0, 2, 5, retstep=True)
    _same(t, j, EW)
    assert ts == pytest.approx(js)


@pytest.mark.parametrize("fn", ["zeros_like", "ones_like", "empty_like"])
def test_like(fn):
    _same(getattr(tmx.np, fn)(tmx.np.array(I)),
          getattr(jmx.np, fn)(jmx.np.array(I)), EW)
    _same(getattr(tmx.np, fn)(tmx.np.array(X), dtype="int32"),
          getattr(jmx.np, fn)(jmx.np.array(X), dtype="int32"), EW)


def test_full_like():
    _same(tmx.np.full_like(tmx.np.array(X), 3.5),
          jmx.np.full_like(jmx.np.array(X), 3.5), EW)


def test_out_argument():
    for pkg in (tmx, jmx):
        o = pkg.np.zeros((3, 4))
        r = pkg.np.add(pkg.np.array(X), pkg.np.array(Y), out=o)
        assert r is o
        onp.testing.assert_allclose(o.asnumpy(), X + Y, **EW)
        s = pkg.np.zeros(())
        pkg.np.sum(pkg.np.array(X), out=s)
        onp.testing.assert_allclose(s.asnumpy(), X.sum(), **RED)
        m = pkg.np.zeros((3, 4))
        pkg.np.exp(pkg.np.array(X), out=m)
        onp.testing.assert_allclose(m.asnumpy(), onp.exp(X), rtol=1e-6)


def test_dtype_names_match_reference():
    for name in ("float16", "float32", "float64", "int8", "int16", "int32",
                 "int64", "uint8", "bool_"):
        assert getattr(tmx.np, name) == getattr(jmx.np, name), name
    assert tmx.np.dtype("float32") == jmx.np.dtype("float32")


def test_unported_function_raises_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="item 20"):
        tmx.npx.ring_attention(None, None, None)
    with pytest.raises(AttributeError):
        tmx.np.no_such_function
    with pytest.raises(AttributeError):
        tmx.npx.no_such_function
    # nd.save/nd.load are item 18a's: a list comes back as a list
    path = str(tmp_path / "x.params")
    tmx.nd.save(path, [tmx.np.arange(3)])
    got = tmx.nd.load(path)
    assert isinstance(got, list) and got[0].asnumpy().tolist() == [0, 1, 2]
    assert hasattr(tmx.npx, "box_nms") and hasattr(tmx.nd, "sparse")


# ---------------------------------------------------------------------------
# npx
# ---------------------------------------------------------------------------
Z = _rand(3, 5, seed=9)
L = onp.array([2, 5, 1], "i4")
NPX = [
    ("relu", (Z,), {}), ("sigmoid", (Z,), {}), ("softmax", (Z,), {}),
    ("softmax", (Z,), {"axis": 0}), ("softmax", (Z,), {"temperature": 2.0}),
    ("softmax", (Z, L), {"use_length": True}),
    ("log_softmax", (Z,), {}), ("log_softmax", (Z,), {"axis": 0,
                                                      "temperature": 0.5}),
    ("one_hot", (onp.array([0, 3, 1], "i4"), 4), {}),
    ("one_hot", (onp.array([0., 2., 5.], "f4"), 4),
     {"on_value": 2.0, "off_value": -1.0}),
    ("pick", (Z, onp.array([0, 4, 2], "f4")), {}),
    ("pick", (Z, onp.array([1, 0, 1, 2, 0], "i4")), {"axis": 0}),
    ("pick", (Z, onp.array([1, 2, 3], "i4")), {"keepdims": True}),
    ("topk", (Z,), {"k": 2}), ("topk", (Z,), {"k": 3, "ret_typ": "value"}),
    ("topk", (Z,), {"k": 2, "ret_typ": "both", "axis": 0}),
    ("topk", (Z,), {"k": 2, "ret_typ": "mask"}),
    ("topk", (Z,), {"k": 2, "is_ascend": True, "dtype": "int32"}),
]


@pytest.mark.parametrize("fn,args,kw", NPX,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NPX)])
def test_npx(fn, args, kw):
    t = getattr(tmx.npx, fn)(*[_lift(tmx, a) for a in args], **kw)
    j = getattr(jmx.npx, fn)(*[_lift(jmx, a) for a in args], **kw)
    _same(t, j, RED)


#: npx ops of uint16/uint32 arrays; topk's mask takes sum's dtype
WIDE_NPX = [
    ("relu", {}), ("topk", {"k": 2}), ("topk", {"k": 3, "ret_typ": "value"}),
    ("topk", {"k": 2, "ret_typ": "both", "axis": 0}),
    ("topk", {"k": 2, "ret_typ": "mask"}),
    ("topk", {"k": 2, "is_ascend": True, "ret_typ": "both"}),
]


#: softmax of an integer array: float32. The reference shifts by the
#: max in the input's own type, so an unsigned input wraps below its max
#: and gives inf / NaN, which the port gives too (equal_nan)
INT_SOFTMAX = [("softmax", {}), ("softmax", {"axis": 0}),
               ("softmax", {"temperature": 2.0}),
               ("log_softmax", {}), ("log_softmax", {"axis": 0})]


@pytest.mark.parametrize("dt", ["int8", "uint8", "int16", "int32",
                                "uint16", "uint32"])
@pytest.mark.parametrize("fn,kw", INT_SOFTMAX,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(INT_SOFTMAX)])
def test_integer_softmax(fn, kw, dt):
    a = _typed(dt, (3, 5), 28)
    _same(getattr(tmx.npx, fn)(tmx.np.array(a), **kw),
          getattr(jmx.npx, fn)(jmx.np.array(a), **kw), RED)


@pytest.mark.parametrize("fn", ["softmax", "log_softmax"])
def test_integer_softmax_by_length(fn):
    a = _typed("int32", (3, 5), 29)
    _same(getattr(tmx.npx, fn)(tmx.np.array(a), length=tmx.np.array(L),
                               use_length=True),
          getattr(jmx.npx, fn)(jmx.np.array(a), length=jmx.np.array(L),
                               use_length=True), RED)


@pytest.mark.parametrize("dt", ["uint16", "uint32"])
@pytest.mark.parametrize("fn,kw", WIDE_NPX,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(WIDE_NPX)])
def test_npx_wide_unsigned(fn, kw, dt):
    a = _wide(dt, seed=13)
    t = getattr(tmx.npx, fn)(tmx.np.array(a), **kw)
    j = getattr(jmx.npx, fn)(jmx.np.array(a), **kw)
    _same(t, j, RED)


@pytest.mark.parametrize("dt", ["int8", "uint8", "int16"])
def test_topk_mask_takes_sum_dtype(dt):
    a = _wide(dt, seed=14) if dt.startswith("u") else _ints(3, 4)
    a = a.astype(dt)
    kw = {"k": 2, "ret_typ": "mask"}
    _same(tmx.npx.topk(tmx.np.array(a), **kw),
          jmx.npx.topk(jmx.np.array(a), **kw), RED)


#: a bool operand, which torch's relu, topk, argmax/argmin and abs
#: refuse: the port computes on an int32 copy and gives each result the
#: reference's dtype
BOOL = onp.array([[True, False, True], [False, False, True]])


@pytest.mark.parametrize("a", [BOOL, BOOL[0]], ids=["2d", "1d"])
def test_bool_relu(a):
    _same(tmx.npx.relu(tmx.np.array(a)), jmx.npx.relu(jmx.np.array(a)), EW)


BOOL_TOPK = [
    {"k": 2, "ret_typ": "value"}, {"k": 2, "ret_typ": "mask"},
    {"k": 1, "axis": 0, "ret_typ": "indices"},
    {"k": 2, "ret_typ": "indices", "dtype": "int32"},
    {"k": 2, "ret_typ": "both"},
    {"k": 2, "ret_typ": "value", "is_ascend": True},
]


@pytest.mark.parametrize("a", [BOOL, BOOL[0]], ids=["2d", "1d"])
@pytest.mark.parametrize("kw", BOOL_TOPK,
                         ids=[f"{c['ret_typ']}-{i}"
                              for i, c in enumerate(BOOL_TOPK)])
def test_bool_topk(a, kw):
    if a.ndim == 1 and kw.get("axis") == 0:
        kw = dict(kw, k=2)
    _same(tmx.npx.topk(tmx.np.array(a), **kw),
          jmx.npx.topk(jmx.np.array(a), **kw), EW)


@pytest.mark.parametrize("fn", ["argmax", "argmin"])
@pytest.mark.parametrize("axis", [None, 0, -1])
def test_bool_argmax_argmin(fn, axis):
    _same(_run(tmx, fn, (BOOL,), {"axis": axis}),
          _run(jmx, fn, (BOOL,), {"axis": axis}), EW)


@pytest.mark.parametrize("fn", ["abs", "absolute"])
@pytest.mark.parametrize("a", [BOOL, BOOL[0]], ids=["2d", "1d"])
def test_bool_abs(fn, a):
    _same(_run(tmx, fn, (a,), {}), _run(jmx, fn, (a,), {}), EW)


def test_npx_helpers():
    assert tmx.npx.current_device() == tmx.cpu()
    assert tmx.npx.num_gpus() == tmx.num_gpus()
    tmx.npx.waitall()


@pytest.mark.parametrize("pkg", [tmx, jmx], ids=["port", "jax"])
def test_dropout_moments(pkg):
    x = pkg.np.ones((4000,))
    onp.testing.assert_array_equal(pkg.npx.dropout(x, p=0.3).asnumpy(),
                                   onp.ones(4000))
    with pkg.autograd.train_mode():
        a = pkg.npx.dropout(x, p=0.3).asnumpy()
        sp = pkg.npx.dropout(pkg.np.ones((50, 40)), p=0.5,
                             axes=(1,)).asnumpy()
    assert a.dtype == onp.float32
    assert set(onp.unique(a)) <= {0.0, onp.float32(1 / 0.7)}
    assert abs((a == 0).mean() - 0.3) < 0.04
    assert abs(a.mean() - 1.0) < 0.06
    # spatial dropout: one draw per row, broadcast along axis 1
    assert all(len(onp.unique(r)) == 1 for r in sp)


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [tmx, jmx], ids=["port", "jax"])
def test_random_moments(pkg):
    pkg.np.random.seed(7)
    u = pkg.np.random.uniform(-1.0, 3.0, size=(20000,))
    n = pkg.np.random.normal(2.0, 0.5, size=(200, 100))
    r = pkg.np.random.randint(3, 9, size=(20000,))
    h = pkg.np.random.uniform(size=(5,), dtype="float16")
    assert (u.shape, u.dtype) == ((20000,), onp.float32)
    assert (n.shape, n.dtype) == ((200, 100), onp.float32)
    assert (r.shape, r.dtype) == ((20000,), onp.int32)
    assert h.dtype == onp.float16
    ua, na, ra = u.asnumpy(), n.asnumpy(), r.asnumpy()
    assert ua.min() >= -1.0 and ua.max() < 3.0
    assert abs(ua.mean() - 1.0) < 0.05 and abs(ua.var() - 16 / 12) < 0.05
    assert abs(na.mean() - 2.0) < 0.02 and abs(na.std() - 0.5) < 0.02
    assert ra.min() == 3 and ra.max() == 8
    assert abs(ra.mean() - 5.5) < 0.05
    # a broadcast of array bounds sets the shape
    lo = pkg.np.array([0.0, 10.0])
    b = pkg.np.random.uniform(lo, lo + 1.0)
    assert b.shape == (2,)
    assert 0 <= b.asnumpy()[0] < 1 and 10 <= b.asnumpy()[1] < 11


def test_random_seed_repeats_and_randint_bounds():
    tmx.np.random.seed(3)
    a = tmx.np.random.normal(size=(6,)).asnumpy()
    tmx.np.random.seed(3)
    onp.testing.assert_array_equal(tmx.np.random.normal(size=(6,)).asnumpy(),
                                   a)
    for pkg in (tmx, jmx):
        with pytest.raises(OverflowError):
            pkg.np.random.randint(0, 2 ** 40, size=(2,))


def test_random_state_snapshot_restores_the_stream():
    from mxnet_tpu_torch import random_state
    tmx.np.random.seed(5)
    tmx.np.random.uniform(size=(3,))
    snap = random_state.get_state()
    a = tmx.np.random.normal(size=(4,)).asnumpy()
    with tmx.autograd.train_mode():
        m = tmx.npx.dropout(tmx.np.ones((50,)), p=0.5).asnumpy()
    random_state.set_state(*snap)
    onp.testing.assert_array_equal(tmx.np.random.normal(size=(4,)).asnumpy(),
                                   a)
    with tmx.autograd.train_mode():
        onp.testing.assert_array_equal(
            tmx.npx.dropout(tmx.np.ones((50,)), p=0.5).asnumpy(), m)
    assert snap[0] == 5


# -- ROADMAP queue 3, F1-F4: each case crossed over these dtypes ----------
ALL_DT = ["bool", "uint8", "uint16", "uint32", "int8", "int16", "int32",
          "float16", "float32"]


def _tied(dt, seed=20):
    """numpy-seeded (3, 5) ``dt`` values drawn from 0..3, so that every
    row holds ties."""
    return onp.random.RandomState(seed).randint(0, 4, (3, 5)).astype(dt)


@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_topk_tie_keeps_lower_index(dt):
    """F1: the row [5, 5, 0, 5] with k = 2 gives indices [0, 1], the
    reference's ``top_k`` order (torch.topk gave [1, 3])."""
    a = onp.array([5, 5, 0, 5], dt)
    t = tmx.npx.topk(tmx.np.array(a), k=2, ret_typ="indices", dtype="int32")
    assert t.asnumpy().tolist() == [0, 1]
    _same(t, jmx.npx.topk(jmx.np.array(a), k=2, ret_typ="indices",
                          dtype="int32"), EW)


TIE_TOPK = [
    {"k": 3, "ret_typ": "indices"}, {"k": 3, "ret_typ": "both"},
    {"k": 2, "ret_typ": "mask"}, {"k": 2, "axis": 0, "ret_typ": "indices"},
    {"k": 4, "ret_typ": "value"},
    {"k": 3, "ret_typ": "indices", "is_ascend": True},
]


@pytest.mark.parametrize("dt", ALL_DT)
@pytest.mark.parametrize("kw", TIE_TOPK,
                         ids=[f"{c['ret_typ']}-{i}"
                              for i, c in enumerate(TIE_TOPK)])
def test_topk_ties(kw, dt):
    """F1 over every dtype: a stable descending sort ranks ties by
    index, as the reference does, for indices, both and the mask."""
    a = _tied(dt)
    _same(tmx.npx.topk(tmx.np.array(a), **kw),
          jmx.npx.topk(jmx.np.array(a), **kw), EW)


#: F2's examples (ROADMAP queue 3): a reduction under an integer or bool
#: ``dtype=`` returns that dtype and wraps as the reference's does
REDUCE_DTYPE = [
    ("sum", onp.array([100] * 4, "i4"), {"dtype": "int8"}),        # -112
    ("prod", onp.array([7] * 3, "i4"), {"dtype": "int8"}),         # 87
    ("mean", onp.array([1, 2, 2, 2], "i4"), {"dtype": "int8"}),    # 1
    ("mean", onp.array([-1, -2, -2, -2], "i4"), {"dtype": "int8"}),
    ("mean", onp.array([200, 200, 2, 2], "i4"), {"dtype": "uint8"}),
    ("sum", onp.array([1, 2, 2, 2], "i4"), {"dtype": "bool"}),     # True
    ("prod", onp.array([1, 2, 0, 2], "i4"), {"dtype": "bool"}),
    ("sum", onp.array([[100] * 3, [1, 2, 3]], "i4"),
     {"axis": 1, "dtype": "int8"}),                                # [44, 6]
    ("sum", onp.array([[100] * 3, [1, 2, 3]], "i4"),
     {"axis": 1, "dtype": "int8", "keepdims": True}),
    ("prod", onp.array([[7] * 3, [1, 2, 3]], "i4"),
     {"axis": 0, "dtype": "int16"}),
    ("mean", onp.array([[100] * 3, [1, 2, 3]], "i4"),
     {"axis": 1, "dtype": "int8"}),
    ("sum", onp.array([40000, 40000], "i4"), {"dtype": "uint16"}),
    ("sum", onp.array([3, 4], "i4"), {"axis": (), "dtype": "int8"}),
]


@pytest.mark.parametrize("fn,a,kw", REDUCE_DTYPE,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(REDUCE_DTYPE)])
def test_reduction_integer_dtype_examples(fn, a, kw):
    _same(_run(tmx, fn, (a,), kw), _run(jmx, fn, (a,), kw), RED)


@pytest.mark.parametrize("src", ALL_DT)
@pytest.mark.parametrize("fn,dt", [
    ("sum", "int8"), ("sum", "uint8"), ("sum", "bool"), ("sum", "int16"),
    ("sum", "uint32"), ("prod", "int8"), ("prod", "uint16"),
    ("prod", "int32"), ("mean", "int8"), ("mean", "uint8"),
    ("mean", "int32")])
def test_reduction_integer_dtype(fn, dt, src):
    """F2 over every input dtype: the input cast to ``dtype``, reduced in
    it (sums and products wrap; a mean is the wrapped sum over the
    count, truncated). A bool mean raises in the reference and is not
    asked for."""
    a = onp.random.RandomState(21).randint(0, 90, (3, 4)).astype(src)
    for axis in (None, 1):
        kw = {"dtype": dt, "axis": axis}
        _same(_run(tmx, fn, (a,), kw), _run(jmx, fn, (a,), kw), RED)


#: F3: data movement of every dtype (uint16/uint32 go through a signed
#: view of their width, bit for bit)
def _moved(dt, seed=22):
    a = onp.random.RandomState(seed).randint(0, 100, (3, 4)).astype(dt)
    if dt in ("uint16", "uint32"):
        a[1, 2] = onp.iinfo(dt).max
    return a


@pytest.mark.parametrize("dt", ALL_DT)
@pytest.mark.parametrize("axis", [None, 0, (0, 1)])
def test_flip_every_dtype(dt, axis):
    a = _moved(dt)
    _same(tmx.np.flip(tmx.np.array(a), axis=axis),
          jmx.np.flip(jmx.np.array(a), axis=axis), EW)


@pytest.mark.parametrize("dt", ALL_DT)
@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_pick_every_dtype(dt, mode):
    """In-range indices only: the reference's ``pick`` ignores ``mode``
    past the axis (ROADMAP "not queued")."""
    a, idx = _moved(dt), onp.array([3, 0, 2], "i4")
    kw = {"axis": 1, "mode": mode}
    _same(tmx.npx.pick(tmx.np.array(a), tmx.np.array(idx), **kw),
          jmx.npx.pick(jmx.np.array(a), jmx.np.array(idx), **kw), EW)


@pytest.mark.parametrize("dt", ALL_DT)
@pytest.mark.parametrize("k", [0, 1, -2])
def test_eye_every_dtype(dt, k):
    _same(tmx.np.eye(3, 4, k=k, dtype=dt), jmx.np.eye(3, 4, k=k, dtype=dt),
          EW)


#: F4: operands of two dtypes, one of them uint16/uint32, which torch
#: does not promote: every operand is cast to the reference's type first
def _pairs():
    return [(w, o) for w in ("uint16", "uint32") for o in ALL_DT]


@pytest.mark.parametrize("w,o", _pairs(), ids=[f"{w}-{o}" for w, o in
                                                _pairs()])
@pytest.mark.parametrize("fn", ["concatenate", "stack", "where"])
def test_wide_unsigned_promotion(fn, w, o):
    a, b = _moved(w), _moved(o, seed=23)
    cond = onp.random.RandomState(24).randint(0, 2, (3, 4)).astype(bool)

    def run(pkg):
        x, y = pkg.np.array(a), pkg.np.array(b)
        if fn == "where":
            return pkg.np.where(pkg.np.array(cond), x, y)
        return getattr(pkg.np, fn)([x, y, x], axis=1)
    _same(run(tmx), run(jmx), EW)


@pytest.mark.parametrize("w", ["uint16", "uint32"])
def test_wide_unsigned_promotion_scalars(w):
    """A Python float beside a wide unsigned array gives the default
    float; a Python int takes the array's type; three operands promote
    in turn (uint16, uint8, bool -> uint16)."""
    a, cond = _moved(w), onp.array([[True, False] * 2] * 3)
    for y in (1.5, 7):
        _same(tmx.np.where(tmx.np.array(cond), tmx.np.array(a), y),
              jmx.np.where(jmx.np.array(cond), jmx.np.array(a), y), EW)
    parts = (a, _moved("uint8"), _moved("bool"))
    _same(tmx.np.concatenate([tmx.np.array(p) for p in parts]),
          jmx.np.concatenate([jmx.np.array(p) for p in parts]), EW)
