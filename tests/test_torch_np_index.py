"""The port's sorting, searching and indexing, top-level products, logic
and numerical helpers (mx.np) against the JAX package's, on the CPU:
``sort``/``argsort`` (stable: ties keep their order), ``searchsorted``
and ``take`` crossed over bool, uint8, uint16, uint32, int8, int32,
float16 and float32; ``lexsort``, ``partition``/``argpartition``,
``nonzero`` and its kin, ``take_along_axis``/``put_along_axis``,
``compress``/``extract``; ``vdot`` ... ``vander`` (integer products
exact), ``isclose`` and the equality tests, ``diff`` ... ``polyval``;
gradients of ``take``, ``sort``'s values, ``einsum`` and ``tensordot``
under ``autograd.record()``. Tolerances in ``test_torch_np_common.py``."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import DTYPES, EW, RED, check, grad_pair, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_search_take_every_dtype(dtype):
    x = values(dtype, shape=(3, 4), seed=60)          # ties in every row
    s = onp.sort(values(dtype, shape=(6,), seed=61))
    v = values(dtype, shape=(2, 3), seed=62)
    idx = onp.array([[0, 3, -1], [5, 2, 11]], "i4")
    for name, args, kw in (
            ("sort", (x,), {"axis": 0}), ("argsort", (x,), {}),
            ("searchsorted", (s, v), {"side": "right"}),
            ("take", (x, idx), {"axis": 1, "mode": "wrap"})):
        check(name, (*args,), kw)


def test_sort_family():
    x = values("float32", shape=(4, 7), seed=63)
    x[1, 2] = onp.nan
    k1 = values("int32", shape=(8,), seed=64)
    k2 = values("int32", shape=(8,), seed=65)
    for name, args, kw in (
            ("sort", (x,), {"axis": None}), ("msort", (x,), {}),
            ("lexsort", ((k1, k2),), {}), ("lexsort", ((k2, k1),), {}),
            ("partition", (x[0], 3), {}), ("partition", (x, 2), {"axis": 1}),
            ("argpartition", (x[0], 3), {}),
            ("argpartition", (k1.reshape(2, 4), 1), {"axis": 1})):
        check(name, args, kw)


def test_nonzero_family():
    x = values("int32", shape=(3, 5), seed=66) % 3
    for name in ("nonzero", "flatnonzero", "argwhere"):
        check(name, (x,))
        check(name, (x.astype("f4"),))
    check("nonzero", (x > 0,))
    check("argwhere", (onp.zeros((2, 2), "f4"),))
    check("where", (x > 0,))
    c = x[0] > 0
    check("compress", (c, x), {"axis": 1})
    check("compress", (c[:3], x))
    check("extract", (x > 0, x))
    check("count_nonzero", (x.astype("uint16"),))


def test_take_along_and_put_along():
    x = values("float32", shape=(3, 4), seed=67)
    i = onp.argsort(x, axis=1).astype("i4")
    check("take_along_axis", (x, i, 1))
    check("take_along_axis", (x, i[:, :2] - 4, 1))
    check("take_along_axis", (x.ravel(), i.ravel(), None))
    outs = []
    for pkg in (tmx, jmx):
        a = pkg.np.array(x)
        pkg.np.put_along_axis(a, pkg.np.array(i[:, :1]), 9.0, 1)
        b = pkg.np.array(values("uint32", shape=(3, 4), seed=68),
                         dtype="uint32")
        pkg.np.put_along_axis(b, pkg.np.array(i[:1] % 3),
                              pkg.np.array(onp.full((1, 4), 7, "u4")), 0)
        outs.append([a, b])
    same(outs[0], outs[1])


def test_index_helpers():
    x = values("float32", shape=(3, 4), seed=69)
    assert tmx.np.ndim(x) == jmx.np.ndim(x) == 2
    assert tmx.np.shape(tmx.np.array(x)) == jmx.np.shape(jmx.np.array(x))
    assert tmx.np.size(x, 1) == jmx.np.size(x, 1)
    assert tmx.np.may_share_memory(x, x) == jmx.np.may_share_memory(x, x)
    assert tmx.np.shares_memory(x, x) == jmx.np.shares_memory(x, x)
    check("unravel_index", (onp.array([0, 5, 11, 13, -3], "i4"), (3, 4)))
    check("unravel_index", (onp.array([1, 7], "i4"), (3, 4)),
          {"order": "F"})
    check("ravel_multi_index", ((onp.array([0, 2, 1], "i4"),
                                 onp.array([3, 1, 0], "i4")), (3, 4)))
    check("ravel_multi_index", ((onp.array([0, 5], "i4"),
                                 onp.array([-1, 2], "i4")), (3, 4)),
          {"mode": "wrap", "order": "F"})


PRODUCTS = [
    ("vdot", "f4", (6,), (6,), {}), ("inner", "f4", (3, 4), (2, 4), {}),
    ("outer", "i4", (3,), (4,), {}), ("kron", "f4", (2, 2), (3, 2), {}),
    ("tensordot", "f4", (3, 4, 5), (4, 5, 2), {}),
    ("tensordot", "i4", (3, 4), (4, 2), {"axes": 1}),
    ("tensordot", "f4", (3, 4, 5), (5, 3), {"axes": ([0, 2], [1, 0])}),
    ("cross", "f4", (4, 3), (4, 3), {}), ("cross", "f4", (2,), (2,), {}),
    ("cross", "i4", (3, 2), (3, 3), {}),
    ("vdot", "i4", (2, 3), (2, 3), {}), ("inner", "u1", (4,), (4,), {}),
]


@pytest.mark.parametrize("name,dt,sa,sb,kw", PRODUCTS,
                         ids=lambda v: repr(v))
def test_products(name, dt, sa, sb, kw):
    a = values(onp.dtype(dt).name, shape=sa, seed=70)
    b = values(onp.dtype(dt).name, shape=sb, seed=71)
    check(name, (a, b), kw, tol=RED)


@pytest.mark.parametrize("expr,shapes,dt", [
    ("ij,jk->ik", [(3, 4), (4, 5)], "f4"), ("ii->i", [(4, 4)], "f4"),
    ("ij->", [(3, 4)], "i4"), ("bij,bjk->bik", [(2, 3, 4), (2, 4, 2)], "i4"),
    ("...j,j", [(2, 3, 4), (4,)], "f4"), ("i,i", [(5,), (5,)], "i1"),
    ("ij,kj", [(2, 3), (4, 3)], "u1"), ("ii", [(3, 3)], "i4"),
], ids=repr)
def test_einsum(expr, shapes, dt):
    ops = [values(onp.dtype(dt).name, shape=s, seed=72 + i)
           for i, s in enumerate(shapes)]
    check("einsum", (expr, *ops), tol=RED)


def test_trace_matrix_power_vander():
    m = values("float32", shape=(3, 3), seed=80)
    i = values("int32", shape=(3, 3), seed=81)
    check("trace", (m,), tol=RED)
    check("trace", (i,), {"offset": 1})
    check("trace", (values("int8", shape=(2, 3, 3), seed=82),),
          {"axis1": 1, "axis2": 2})
    for n in (0, 1, 3):
        check("matrix_power", (i, n))
    check("matrix_power", (m, 4), tol=RED)
    check("matrix_power", (m + 3 * onp.eye(3, dtype="f4"), -2), tol=RED)
    check("vander", (values("int32", shape=(4,), seed=83),))
    check("vander", (values("float32", shape=(5,), seed=84),),
          {"N": 3, "increasing": True}, tol=EW)


def test_logic():
    a = values("float32", shape=(3, 4), seed=85)
    b = a + onp.float32(1e-6) * values("float32", shape=(3, 4), seed=86)
    b[0, 0] = onp.nan
    a[0, 0] = onp.nan
    b[1, 1] = a[1, 1] = onp.inf
    for kw in ({}, {"equal_nan": True}, {"rtol": 0.0, "atol": 1e-7}):
        check("isclose", (a, b), kw)
        assert tmx.np.allclose(a, b, **kw) == jmx.np.allclose(a, b, **kw)
    i = values("int32", shape=(3, 4), seed=87)
    check("isclose", (i, i + 1))
    for x, y, kw in ((a, a, {}), (a, a, {"equal_nan": True}), (i, i, {}),
                     (i, i[:2], {})):
        assert tmx.np.array_equal(x, y, **kw) == jmx.np.array_equal(x, y,
                                                                  **kw)
    for x, y in ((i, i[:1]), (i, i[:2]), (i[:1], i)):
        assert tmx.np.array_equiv(x, y) == jmx.np.array_equiv(x, y)


def test_numerical_helpers():
    x = values("float32", shape=(3, 6), seed=88)
    i = values("int32", shape=(3, 6), seed=89)
    u = values("uint8", shape=(7,), seed=90)
    v = values("float32", shape=(7,), seed=91)
    w = values("float32", shape=(4,), seed=92)
    cases = [
        ("diff", (x,), {}), ("diff", (i,), {"n": 2, "axis": 0}),
        ("diff", (u,), {}), ("diff", (x > 0,), {}),
        ("diff", (x,), {"prepend": 0.0, "append": x[:, :1]}),
        ("ediff1d", (i,), {}), ("ediff1d", (v,), {"to_begin": 7.0,
                                                  "to_end": 1.5}),
        ("gradient", (x,), {}), ("gradient", (v, 0.5), {}),
        ("gradient", (x,), {"axis": 1, "edge_order": 2}),
        ("gradient", (i.astype("f4"),), {}),
        ("convolve", (w, v), {"mode": "same"}),
        ("convolve", (v, w), {"mode": "valid"}),
        ("correlate", (w, v), {"mode": "full"}),
        ("correlate", (v, w), {"mode": "same"}),
        ("convolve", (u, u[:3]), {}),
        ("cov", (x, x[::-1]), {"rowvar": False}),
        ("cov", (v,), {"bias": True}), ("cov", (x,), {"ddof": 2}),
        ("corrcoef", (x,), {}), ("corrcoef", (v, w[::-1].repeat(2)[:7]), {}),
        ("polyval", (w, x), {}), ("polyval", (i[0], i[1]), {}),
    ]
    for name, args, kw in cases:
        check(name, args, kw, tol=RED)


@pytest.mark.parametrize("name,args,kw", [
    ("take", (onp.array([[0, 2], [3, 3]], "i4"),), {"axis": 1}),
    ("sort", (), {"axis": 1}),
    ("einsum_ij,jk", (), {}),
], ids=lambda v: repr(v))
def test_gradient(name, args, kw):
    x = values("float32", shape=(3, 4), seed=93)
    if name.startswith("einsum") or name == "tensordot":
        y = values("float32", shape=(4, 2), seed=94)
        grads = []
        for pkg in (tmx, jmx):
            a = pkg.np.array(x)
            a.attach_grad()
            with pkg.autograd.record():
                if name == "tensordot":
                    r = pkg.np.tensordot(a, pkg.np.array(y), **kw)
                else:
                    r = pkg.np.einsum("ij,jk->ik", a, pkg.np.array(y))
                s = (r * r).sum()
            s.backward()
            grads.append(a.grad)
        same(grads[0], grads[1], RED)
        return
    t, j = grad_pair(name, x, dict(kw, **({"indices": args[0]} if args
                                         else {})), reduce="sq")
    same(t, j, RED)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "float16", "float32"])
def test_products_keep_type_beside_python_scalar(dtype):
    """F6: a Python scalar beside an array is weak in ``kron``, ``outer``
    and ``polyval``: an int8 array with 2 stays int8, a float16 one with
    0.5 float16."""
    a = values(dtype, shape=(2, 3), seed=72)
    for s in (2, 0.5, True):
        check("kron", (a, s), tol=RED, nojit=True)
        check("kron", (s, a), tol=RED, nojit=True)
        check("outer", (a[0], s), tol=RED, nojit=True)
    check("polyval", (a[0], 0.5), tol=RED)
    check("polyval", (a[0], 2), tol=RED)
