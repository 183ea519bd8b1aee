"""The port's reductions and statistics (mx.np) against the JAX
package's, on the CPU: the reduction table crossed over bool, uint8,
uint16, uint32, int8, int32, float16 and float32, axes and keepdims,
``cumsum``/``cumprod`` with ``dtype=``, NaN handling of the nan*
functions, ``median``/``quantile``/``percentile`` in every method,
``average``, ``bincount``, ``histogram``, and the gradients of
``cumsum``, ``cumprod``, ``std`` and ``var`` under
``autograd.record()``. Tolerances in ``test_torch_np_common.py`` (reductions at
1e-5)."""
import numpy as onp
import pytest

import mxnet_tpu_torch as tmx

from test_torch_np_common import DTYPES, RED, check, grad_pair, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


#: the reductions this slice ports (sum, prod, mean, max, min, argmax and
#: argmin, ported before, are crossed in ``tests/test_torch_numpy.py``)
TABLE = ["nansum", "nanprod", "nanmean", "nanmax", "nanmin", "all", "any",
         "std", "var", "ptp", "nanargmax", "nanargmin", "cumsum", "cumprod",
         "median", "nanmedian", "count_nonzero", "average"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", TABLE)
def test_reduction_table(name, dtype):
    x = values(dtype, shape=(3, 4), lo=-1.5, hi=1.5, seed=20)
    check(name, (x,), tol=RED, nojit=True)


AXES = [{"axis": 1}, {"axis": -1, "keepdims": True}, {"axis": (0, 2)}]
AXIS_FUNCS = ["nansum", "nanmax", "all", "std", "median",
              "count_nonzero"]


@pytest.mark.parametrize("kw", AXES, ids=repr)
@pytest.mark.parametrize("name", AXIS_FUNCS)
def test_reduction_axes(name, kw):
    kw = dict(kw)
    if name == "count_nonzero":
        kw.pop("keepdims", None)
    x = values("float32", shape=(4, 3, 5), seed=21)
    x[x > 1.2] = 0.0
    check(name, (x,), kw, tol=RED)


def test_nan_functions():
    x = values("float32", shape=(4, 6), seed=22)
    x[0, 1] = x[2, 3] = x[2, 4] = onp.nan
    x[3, :] = onp.nan                      # a row of NaN only
    for name in ("nansum", "nanprod", "nanmean", "nanmax", "nanmin",
                 "median", "nanmedian", "max"):
        check(name, (x,), {"axis": 1}, tol=RED)
    for name in ("nanargmax", "nanargmin"):
        check(name, (x,), {"axis": 0})


@pytest.mark.parametrize("ddof", [0, 1, 2])
def test_std_var_ddof(ddof):
    x = values("float32", shape=(5, 4), seed=23)
    for name in ("std", "var"):
        check(name, (x,), {"ddof": ddof}, tol=RED)
        check(name, (x,), {"ddof": ddof, "axis": 0}, tol=RED)
    check("var", (values("int32", shape=(5, 4), seed=24),),
          {"dtype": "float32", "axis": 1}, tol=RED)


@pytest.mark.parametrize("dtype", [None, "int8", "uint8", "int32",
                                   "float32", "float16"])
@pytest.mark.parametrize("name", ["cumsum", "cumprod"])
def test_cumulative_dtype(name, dtype):
    x = values("int32", shape=(3, 6), seed=25) * 7
    kw = {"axis": 1} if dtype is None else {"axis": 1, "dtype": dtype}
    check(name, (x,), kw, tol=RED, nojit=True)


@pytest.mark.parametrize("method", ["linear", "lower", "higher", "midpoint",
                                    "nearest"])
def test_quantile_methods(method):
    x = values("float32", shape=(5, 7), seed=27)
    q = onp.array([0.0, 0.1, 0.5, 0.75, 1.0], "f4")
    check("quantile", (x, 0.3), {"axis": 1, "interpolation": method},
          tol=RED)
    check("percentile", (x, q * 100), {"axis": 0, "interpolation": method,
                                       "keepdims": True}, tol=RED)


def test_median_even_and_odd_counts():
    for shape in ((6,), (7,)):
        check("median", (values("float32", shape=shape, seed=29),), tol=RED)
    check("median", (values("int8", shape=(4, 6), seed=30),), {"axis": 0},
          tol=RED)


def test_average():
    x = values("float32", shape=(4, 5), seed=31)
    w = values("float32", shape=(4, 5), lo=0.1, hi=1.0, seed=32)
    check("average", (x,), {"weights": None}, tol=RED)
    check("average", (x, 0), {"weights": None, "returned": True}, tol=RED)
    check("average", (x,), {"axis": 1, "weights": w[0]}, tol=RED)
    check("average", (x,), {"axis": 0, "weights": w[:, 0],
                             "returned": True}, tol=RED)
    check("average", (x,), {"weights": w}, tol=RED)


def test_bincount():
    x = values("int32", shape=(20,), seed=33) + 5
    w = values("float32", shape=(20,), seed=34)
    check("bincount", (x,), {"minlength": 15})
    check("bincount", (x, w), tol=RED)


@pytest.mark.parametrize("kw", [{}, {"bins": 5}, {"bins": 7, "range": (-1.0,
                                                                     1.0)},
                                {"density": True},
                                {"bins": [-2.0, -0.5, 0.0, 0.3, 2.0]}],
                         ids=repr)
def test_histogram(kw):
    x = values("float32", shape=(50,), seed=36)
    x[:3] = [x.max(), x.min(), 1.0]
    check("histogram", (x,), kw, tol=RED)
    w = values("float32", shape=(50,), lo=0.0, hi=1.0, seed=37)
    check("histogram", (x,), dict(kw, weights=w), tol=RED)


def test_histogram_constant_and_int():
    check("histogram", (onp.full(6, 3.0, "f4"),), tol=RED)
    check("histogram", (values("int32", shape=(30,), seed=38),),
          {"bins": 4}, tol=RED)


@pytest.mark.parametrize("name,kw", [
    ("cumsum", {"axis": 1}), ("cumprod", {"axis": 0}),
    ("std", {"axis": 1, "ddof": 1}), ("var", {"axis": 0})],
    ids=lambda v: repr(v))
def test_gradient(name, kw):
    x = values("float32", shape=(3, 4), lo=0.3, hi=1.5, seed=39)
    t, j = grad_pair(name, x, kw, reduce="sq")
    same(t, j, RED)


@pytest.mark.parametrize("kw", [{}, {"bins": 5}, {"bins": 7, "range": (-1.0,
                                                                     1.0)}],
                         ids=repr)
def test_histogram_float16_edges(kw):
    """F8: a float16 input's edges are float16, computed (and binned by)
    as NumPy computes them."""
    x = values("float16", shape=(40,), seed=41)
    x[:3] = [x.max(), x.min(), 0.5]
    check("histogram", (x,), kw, tol=RED)


def test_gradient_over_several_axes_float16():
    """F8: ``gradient`` of a float16 array over several axes is float32
    (the reference lifts NumPy's tuple at the default float); over one
    axis it keeps float16."""
    x = values("float16", shape=(3, 4), seed=42)
    check("gradient", (x,), tol=RED)
    check("gradient", (x,), {"axis": 1}, tol=RED)
