"""The port's unary elementwise mx.np functions and dtype utilities
against the JAX package's, on the CPU: the unary table crossed over
bool, uint8, uint16, uint32, int8, int32, float16 and float32 (dtype,
shape and values), special values, ``around`` at every sign of
``decimals``, ``nan_to_num``, ``interp``, the dtype utilities, and the
gradients of the differentiable table under ``autograd.record()``.
Tolerances in ``test_torch_np_common.py``."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import DTYPES, EW, TR, check, grad_pair, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


#: unary functions and their float domain: any (-2, 2), unit (-0.9,
#: 0.9), pos (0.1, 3), ge1 (1, 3); a transcendental function is held at TR
UNARY = {
    "negative": "any", "positive": "any", "abs": "any", "fabs": "any",
    "sign": "any", "rint": "any", "ceil": "any", "floor": "any",
    "trunc": "any", "fix": "any", "square": "any", "sqrt": "pos",
    "cbrt": "any", "reciprocal": "pos", "exp": "any", "exp2": "any",
    "expm1": "any", "log": "pos", "log2": "pos", "log10": "pos",
    "log1p": "pos", "sin": "any", "cos": "any", "tan": "unit",
    "arcsin": "unit", "arccos": "unit", "arctan": "any", "sinh": "any",
    "cosh": "any", "tanh": "any", "arcsinh": "any", "arccosh": "ge1",
    "arctanh": "unit", "degrees": "any", "radians": "any",
    "deg2rad": "any", "rad2deg": "any", "invert": "any",
    "logical_not": "any", "isnan": "any", "isinf": "any",
    "isneginf": "any", "isposinf": "any", "isfinite": "any",
    "signbit": "any", "conjugate": "any", "real": "any", "imag": "any",
    "angle": "any", "around": "any", "nan_to_num": "any",
}
EXACT = {"negative", "positive", "abs", "fabs", "sign", "rint", "ceil",
         "floor", "trunc", "fix", "square", "degrees", "radians",
         "deg2rad", "rad2deg", "conjugate", "real", "imag", "around",
         "nan_to_num", "invert", "logical_not", "isnan", "isinf",
         "isneginf", "isposinf", "isfinite", "signbit", "reciprocal",
         "sqrt", "angle"}
DOMAIN = {"any": (-2.0, 2.0), "unit": (-0.9, 0.9), "pos": (0.1, 3.0),
          "ge1": (1.0, 3.0)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_table(name, dtype):
    lo, hi = DOMAIN[UNARY[name]]
    x = values(dtype, lo=lo, hi=hi, seed=1)
    check(name, (x,), tol=EW if name in EXACT else TR, nojit=True)


def test_unary_special_values():
    x = onp.array([0.0, -0.0, onp.inf, -onp.inf, onp.nan, 1e-30, -2.5,
                   2.5, 0.5, -0.5], "f4")
    for name in ("isnan", "isinf", "isneginf", "isposinf", "isfinite",
                 "signbit", "nan_to_num", "rint", "around", "sign", "abs",
                 "fabs", "exp2", "log1p", "cbrt", "floor", "ceil"):
        check(name, (x,), tol=TR)
    check("nan_to_num", (x,), {"nan": 7.0, "posinf": 9.0, "neginf": -9.0})


@pytest.mark.parametrize("decimals", [0, 2, -1])
@pytest.mark.parametrize("dtype", ["float32", "float16", "int32"])
def test_around_decimals(decimals, dtype):
    x = values(dtype, shape=(4, 5), lo=-60.0, hi=60.0, seed=2)
    if dtype == "float32":
        x[0, :] = [0.5, 1.5, 2.5, -0.5, -2.5]   # halves: to even
        x[1, :] = [0.25, 0.35, 12.5, 15.0, -25.0]
    check("around", (x,), {"decimals": decimals})
    check("round", (x,), {"decimals": decimals})


def test_interp():
    xp = onp.array([0.0, 1.0, 1.0, 2.5, 4.0], "f4")
    fp = onp.array([1.0, 3.0, 5.0, -1.0, 2.0], "f4")
    x = onp.linspace(-1, 5, 25).astype("f4")
    check("interp", (x, xp, fp), {"left": -7.0, "right": 9.0})


# ---------------------------------------------------------------------------
# dtype utilities
# ---------------------------------------------------------------------------
RESULT_TYPE_CASES = [
    ("int32", 2.0), ("int32", 2), ("bool", 1), ("float16", 1j),
    ("uint32", "int32"), ("int8", "uint8"), ("int32", "float16"),
    ("float16", "float32"), ("bool", "bool"), ("uint8", 3.5),
    ("int64",), ("float64",), ("float16", 2.0),
]


@pytest.mark.parametrize("case", RESULT_TYPE_CASES, ids=repr)
def test_result_type(case):
    def args(pkg):
        return [pkg.np.zeros((2,), dtype=c) if isinstance(c, str) and
                c not in ("int64", "float64") else
                (onp.dtype(c) if isinstance(c, str) else c) for c in case]
    assert tmx.np.result_type(*args(tmx)) == jmx.np.result_type(*args(jmx))


@pytest.mark.parametrize("pair", [("int8", "uint8"), ("int32", "float16"),
                                  ("uint32", "int32"), ("int64", "int32"),
                                  ("bool", "int8"), ("float16", "float32"),
                                  ("uint8", "uint16")], ids="-".join)
def test_promote_types_and_can_cast(pair):
    assert tmx.np.promote_types(*pair) == jmx.np.promote_types(*pair)
    for casting in ("safe", "same_kind", "unsafe"):
        assert tmx.np.can_cast(pair[0], pair[1], casting) \
            == jmx.np.can_cast(pair[0], pair[1], casting)
    a = onp.zeros(2, pair[0])
    assert tmx.np.can_cast(tmx.np.array(a, dtype=pair[0]), pair[1]) \
        == jmx.np.can_cast(jmx.np.array(a, dtype=pair[0]), pair[1])


def test_finfo_iinfo():
    for dt in ("float16", "float32"):
        assert tmx.np.finfo(dt).eps == jmx.np.finfo(dt).eps
    for dt in ("int8", "uint16", "int32"):
        assert tmx.np.iinfo(dt).max == jmx.np.iinfo(dt).max


# ---------------------------------------------------------------------------
# gradients under autograd.record()
# ---------------------------------------------------------------------------
GRAD_UNARY = ["cbrt", "reciprocal", "exp2", "log1p", "tan", "arcsin",
              "arccosh", "arctanh"]


@pytest.mark.parametrize("name", GRAD_UNARY)
def test_unary_gradient(name):
    lo, hi = DOMAIN[UNARY[name]]
    x = values("float32", lo=lo, hi=hi, seed=9)
    t, j = grad_pair(name, x)
    same(t, j, TR)


#: F5: functions of one operand that lifted a bare Python int or bool
#: to float32, or raised, grouped by the helper they go through
SCALAR_GROUPS = {
    "elementwise": ("abs", "ceil", "floor", "trunc", "fix", "around",
                    "square", "negative", "conjugate", "real", "imag",
                    "nan_to_num", "invert", "sign"),
    "shapes": ("flip", "ravel", "squeeze", "transpose", "permute_dims",
               "atleast_1d", "atleast_2d", "atleast_3d", "diagflat"),
    "reductions": ("sum", "prod", "nansum", "nanprod", "max", "min",
                   "nanmax", "nanmin", "ptp", "cumsum", "cumprod"),
    "likes": ("zeros_like", "ones_like", "empty_like"),
    "statistics": ("median", "nanmedian", "cov", "corrcoef"),
}


@pytest.mark.parametrize("scalar", [3, True, 2.5], ids=repr)
@pytest.mark.parametrize("group", sorted(SCALAR_GROUPS))
def test_python_scalar_operand(group, scalar):
    for name in SCALAR_GROUPS[group]:
        check(name, (scalar,), tol=EW, nojit=True)


def test_python_scalar_beside_an_array():
    x = values("int8", seed=3)
    check("atleast_1d", (x, 2))
    check("atleast_2d", (True, x))
    # the port takes a bool's ediff1d (as xor), which jnp refuses
    check("ediff1d", (3,))
    check("ediff1d", (2.5,))
