"""The port's binary elementwise mx.np functions against the JAX
package's, on the CPU: the rest of the binary table (``fmod`` ...
``logical_xor``) crossed over bool, uint8, uint16, uint32, int8, int32,
float16 and float32, mixed operand types, Python scalars, and the
gradients of the differentiable functions under ``autograd.record()``.
Tolerances in ``test_torch_np_common.py``."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import DTYPES, EW, TR, check, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


#: the binary functions this slice ports (the arithmetic, bitwise and
#: comparison functions ported before are held by
#: ``tests/test_torch_numpy.py``)
BINARY = ["fmod", "float_power", "fmax", "fmin", "hypot", "arctan2",
          "logaddexp", "logaddexp2", "copysign", "nextafter", "ldexp",
          "heaviside", "gcd", "lcm", "logical_and", "logical_or",
          "logical_xor"]

BIN_TR = {"hypot", "arctan2", "logaddexp", "logaddexp2", "float_power",
          "power"}
INT_DIVISION = {"floor_divide", "mod", "remainder", "fmod"}


@pytest.mark.parametrize("name,dtype", [(n, d) for n in BINARY
                                        for d in DTYPES])
def test_binary_table(name, dtype):
    x = values(dtype, lo=0.2, hi=2.0, seed=3)
    y = values(dtype, lo=0.2, hi=2.0, seed=4)
    if name == "ldexp" and dtype.startswith("float"):
        y = values("int8", seed=4)
    if name in ("left_shift", "right_shift") and dtype.startswith("int"):
        y = onp.abs(y)
    if name in INT_DIVISION and not dtype.startswith("float"):
        # an integer divisor of 0 is outside the domain (the reference
        # gives XLA's values, torch raises on the CPU)
        y = onp.where(y == 0, 1, y).astype(dtype)
    check(name, (x, y), tol=TR if name in BIN_TR else EW, nojit=True)


MIXED = [("float32", "int32"), ("int32", "float16"), ("uint8", "int8"),
         ("bool", "float32"), ("uint16", "int32"), ("float16", "float32")]


@pytest.mark.parametrize("pair", MIXED, ids="-".join)
@pytest.mark.parametrize("name", ["fmod", "fmax", "hypot", "heaviside",
                                  "float_power"])
def test_binary_mixed(name, pair):
    x = values(pair[0], lo=0.2, hi=2.0, seed=5)
    y = values(pair[1], lo=0.2, hi=2.0, seed=6)
    check(name, (x, y), tol=TR, nojit=True)


@pytest.mark.parametrize("name", ["fmod", "hypot", "heaviside", "fmax",
                                  "ldexp", "gcd"])
def test_binary_scalars(name):
    x = values("float32", lo=0.2, hi=2.0, seed=7)
    i = values("int32", seed=8)
    if name in ("gcd",):
        check(name, (i, 6))
        return
    if name == "ldexp":
        check(name, (x, 3))
        return
    check(name, (x, 0.5), tol=TR)
    check(name, (2.0, x), tol=TR)
    check(name, (i, 3), tol=TR)



# ---------------------------------------------------------------------------
# gradients under autograd.record()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["hypot", "arctan2", "logaddexp",
                                  "float_power"])
def test_binary_gradient(name):
    x = values("float32", lo=0.3, hi=2.0, seed=10)
    y = values("float32", lo=0.3, hi=2.0, seed=11)
    grads = []
    for pkg in (tmx, jmx):
        a, b = pkg.np.array(x), pkg.np.array(y)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            s = getattr(pkg.np, name)(a, b).sum()
        s.backward()
        grads.append((a.grad, b.grad))
    same(list(grads[0]), list(grads[1]), TR)
