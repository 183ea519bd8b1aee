"""Shared helpers of the ``tests/test_torch_np_*.py`` files: seeded
inputs in every dtype of the crosses, the comparison of a port result
with the JAX package's, and a cache of the JAX package's results.

Tolerances (the port against the JAX package, both on the CPU): dtype
and shape exactly; integers and bool exactly; elementwise fp32 at
rtol = atol = 1e-6 (``EW``), 2e-6 for transcendental functions
(``TR``); reductions, products and ``linalg`` solves at 1e-5 (``RED``);
decompositions by reconstruction at 1e-4 relative; ``fft`` at 1e-5 x
max|X|. A float16 (bfloat16) result is held to one step of its type,
2^-10 (2^-7), relative and absolute: both packages compute a 16-bit op
in float32 and round once, but the two float32 results may round to
neighbouring 16-bit values.

The elementwise crosses run the JAX package's calls under
``jax.disable_jit()`` (``check(..., nojit=True)``): its functions then
run primitive by primitive, and each primitive compiles once per dtype
and shape for every case that uses it, not once per function (an
integer input of a float function reuses the float32 primitive). A
composite function (a median, a gradient) is faster jitted, as the
package runs it by default.
"""
import contextlib

import jax
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EW = dict(rtol=1e-6, atol=1e-6)
TR = dict(rtol=2e-6, atol=2e-6)
RED = dict(rtol=1e-5, atol=1e-5)
F16 = dict(rtol=2.0 ** -10, atol=2.0 ** -10)

#: the dtypes of the crosses
DTYPES = ("bool", "uint8", "uint16", "uint32", "int8", "int32", "float16",
          "float32")


def values(dtype, shape=(3, 4), lo=-2.0, hi=2.0, seed=0):
    """Seeded values of ``dtype``: floats uniform in [lo, hi), integers
    in [0, 5) (unsigned) or [-5, 5), bools half true."""
    rs = onp.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(*shape) > 0.5
    if dtype.startswith("uint"):
        return rs.randint(0, 5, shape).astype(dtype)
    if dtype.startswith("int"):
        return rs.randint(-5, 5, shape).astype(dtype)
    return rs.uniform(lo, hi, shape).astype(dtype)


def ref(nojit=True):
    """The scope of a JAX package call (see the module docstring)."""
    return jax.disable_jit() if nojit else contextlib.nullcontext()


def lift(pkg, a):
    if isinstance(a, onp.ndarray):
        return pkg.np.array(a, dtype=a.dtype)
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], onp.ndarray):
        return type(a)(lift(pkg, x) for x in a)
    return a


def resolve(pkg, path):
    """``pkg.np.<path>``; ``path`` may name a submodule (``linalg.inv``),
    and a path under ``npx.`` names ``pkg.npx.<rest>``."""
    fn = pkg.np
    if path.startswith("npx."):
        fn, path = pkg.npx, path[4:]
    for part in path.split("."):
        fn = getattr(fn, part)
    return fn


def call(pkg, path, args, kw):
    """``resolve(pkg, path)(*args, **kw)`` with numpy arrays lifted."""
    return resolve(pkg, path)(*[lift(pkg, a) for a in args], **kw)


def tol_for(dtype, tol):
    dt = onp.dtype(dtype) if not isinstance(dtype, onp.dtype) else dtype
    return F16 if dt == onp.float16 else tol


def same(t, j, tol=EW):
    """The port's result ``t`` against the JAX package's ``j``: the same
    structure, dtype and shape; integers and bools equal; inexact values
    within ``tol`` (or one float16 step)."""
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(t) == len(j), (t, j)
        for a, b in zip(t, j):
            same(a, b, tol)
        return
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            same(t[k], j[k], tol)
        return
    if not hasattr(j, "asnumpy"):
        assert type(t) is type(j), (type(t), type(j))
        if isinstance(j, float):
            onp.testing.assert_allclose(t, j, **tol)
        else:
            assert t == j, (t, j)
        return
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape, (t.shape, j.shape)
    tn, jn = t.asnumpy(), j.asnumpy()
    if onp.issubdtype(jn.dtype, onp.inexact):
        onp.testing.assert_allclose(tn, jn, **tol_for(jn.dtype, tol))
    else:
        onp.testing.assert_array_equal(tn, jn)


def _ref_call(path, args, kw, nojit):
    with ref(nojit):
        return _host(call(jmx, path, args, kw))


class Host:
    """A JAX package result kept as a host copy (its dtype, shape and
    values): the cache holds no JAX arrays, whose number slows every
    later compile in the process."""

    def __init__(self, a):
        self.dtype, self.shape, self._v = a.dtype, a.shape, a.asnumpy()

    def asnumpy(self):
        return self._v


def _host(r):
    if isinstance(r, (list, tuple)):
        return type(r)(_host(v) for v in r)
    if isinstance(r, dict):
        return {k: _host(v) for k, v in r.items()}
    return Host(r) if hasattr(r, "asnumpy") else r


class RefCache:
    """The JAX package's result of each case, computed once per process
    and shared by every test that reads it, aliases included (``round``
    and ``around`` are one function); an exception is kept and re-raised
    to each reader."""

    def __init__(self):
        self._memo = {}

    def get(self, key, thunk):
        if key not in self._memo:
            try:
                self._memo[key] = (True, thunk())
            except Exception as e:       # noqa: BLE001 (re-raised below)
                self._memo[key] = (False, e)
        ok, v = self._memo[key]
        if not ok:
            raise v
        return v


REF = RefCache()


def _key(x):
    """A hashable stand-in for a case's arguments (arrays by their bytes:
    numpy's repr elides large ones)."""
    if isinstance(x, onp.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return repr(x)


def check(path, args=(), kw=None, tol=EW, nojit=False, wider=False):
    """One case: the port and the JAX package on the same inputs; if the
    reference raises, the port must raise too, unless ``wider`` (an
    input the port takes and the reference refuses, e.g. an integer
    input of ``npx.erf``: the port's result is then not compared).
    ``wider`` is refused for float inputs, arrays or Python floats."""
    kw = kw or {}
    if wider and any(isinstance(a, float) or (isinstance(a, onp.ndarray)
                                              and a.dtype.kind in "fc")
                     for a in args):
        raise ValueError(f"{path}: 'wider' is for integer and bool inputs")
    fn = resolve(jmx, path)
    key = (id(fn), _key(args), _key(sorted(kw.items())))
    try:
        j = REF.get(key, lambda: _ref_call(path, args, kw, nojit))
    except Exception:                    # noqa: BLE001
        try:
            call(tmx, path, args, kw)
        except Exception:                # noqa: BLE001
            return None
        if wider:
            return None
        raise AssertionError(f"{path}: the reference raises, the port "
                             f"does not")
    t = call(tmx, path, args, kw)
    same(t, j, tol)
    return t, j


def grad_pair(path, x, kw=None, reduce="sum"):
    """d sum(f(x)) / dx under ``autograd.record()`` in both packages."""
    kw = kw or {}
    out = []
    for pkg in (tmx, jmx):
        a = pkg.np.array(x, dtype=x.dtype)
        a.attach_grad()
        with pkg.autograd.record():
            y = call(pkg, path, (a,), kw)
            if isinstance(y, (list, tuple)):
                y = y[0]
            s = (y * y).sum() if reduce == "sq" else y.sum()
        s.backward()
        out.append(a.grad)
    return out


def grads(path, args, kw=None, wrt=(0,), reduce="w", seed=99, nojit=True):
    """The gradients of the arguments at ``wrt`` (numpy arrays) of
    ``reduce(f(*args))`` under ``autograd.record()`` in both packages:
    ``(port's, reference's)``, each a list of the first output and the
    gradients, the reference's run as ``ref(nojit)`` runs it. ``reduce``
    ``"w"`` weighs the first output by fixed seeded values (a plain sum
    would hide a permuted or mirrored gradient), ``"sum"`` sums it."""
    kw = kw or {}
    out = []
    for pkg in (tmx, jmx):
        with ref(nojit) if pkg is jmx else contextlib.nullcontext():
            xs = [lift(pkg, a) for a in args]
            for i in wrt:
                xs[i].attach_grad()
            with pkg.autograd.record():
                y = resolve(pkg, path)(*xs, **kw)
                if isinstance(y, (list, tuple)):
                    y = y[0]
                if reduce == "w":
                    w = pkg.np.array(values("float32", shape=y.shape,
                                            seed=seed))
                    s = (y * w).sum()
                else:
                    s = y.sum()
            s.backward()
            out.append([_host(y)] + [_host(xs[i].grad) for i in wrt])
    return out


def test_helpers_are_strict():
    """The comparison these files rest on refuses another dtype, another
    shape and a value past its tolerance, and ``values`` gives each dtype
    of the crosses."""
    with tmx.cpu():
        t = tmx.np.array(onp.ones((2, 3), "f4"))
        for other in (onp.ones((2, 3), "f2"), onp.ones((3, 2), "f4"),
                      onp.full((2, 3), 1.0 + 1e-5, "f4")):
            with pytest.raises(AssertionError):
                same(t, jmx.np.array(other, dtype=other.dtype))
        same(t, jmx.np.array(onp.ones((2, 3), "f4")))
    for dt in DTYPES:
        assert values(dt).dtype == onp.dtype(dt)
