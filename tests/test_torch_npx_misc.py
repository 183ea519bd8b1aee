"""The rest of the port's ``mx.npx`` against the JAX package's, on the
CPU: the special functions (over the dtypes; ``gamma`` signed), the
indexing and shape helpers (``index_add``/``index_update``,
``gather_nd``/``scatter_nd``, ``boolean_mask``, ``batch_dot`` with its
exact integer products, ``slice``/``slice_like``/``slice_axis``,
``arange_like``, ``broadcast_like``, ``reshape_like``, ``shape_array``,
``index_array``, ``smooth_l1``), the multi-tensor helpers, ``npx.random``,
the np-mode switches (``set_np(dtype=True)``'s float64 default), the
random-state helpers, and the name parity of the two modules: every
name the reference defines itself is ported but ``ring_attention``
(item 20) and ``load``/``save`` (item 18), and so are the 42 names it
imports from ``contrib_ops.py`` (item 13b-ii, held against the
reference in ``test_torch_npx_warp.py``, ``_detection.py`` and
``_contrib.py``).

Tolerances (``test_torch_np_common.py``): dtype and shape exactly;
integers and bools exactly; elementwise fp32 at 2e-6 (``TR``), the rest
at 1e-5 (``RED``), a float16 result within one float16 step."""

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import NotPortedError

from test_torch_np_common import (DTYPES, EW, RED, TR, check, grads, lift,
                                  same, values)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


SPECIAL = {"gammaln": (0.2, 3.0), "erf": (-2.0, 2.0), "erfinv": (-0.9, 0.9),
           "digamma": (0.2, 3.0), "rsqrt": (0.2, 3.0), "rcbrt": (0.2, 3.0),
           "gamma": (0.2, 3.0)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_special_functions(dtype):
    """Crossed over the dtypes; an integer or bool input, which the
    reference refuses, computes in float32 in the port (``wider``)."""
    for name, (lo, hi) in SPECIAL.items():
        x = values(dtype, lo=lo, hi=hi, seed=1)
        check("npx." + name, (x,), tol=TR, nojit=True,
              wider=not dtype.startswith("float"))


@pytest.mark.parametrize("scalar", [3, True, 2.5], ids=repr)
def test_python_scalar_operands(scalar):
    """A bare Python scalar lifts with jnp's weak rule (int32, bool,
    float32), as the reference hands it to jnp."""
    for name, kw in [("npx.relu", {}), ("npx.activation", {"act_type":
                                                           "tanh"}),
                     ("npx.erf", {}), ("npx.smooth_l1", {}),
                     ("npx.hard_sigmoid", {}), ("npx.gelu", {}),
                     ("npx.leaky_relu", {}), ("npx.mish", {})]:
        check(name, (scalar,), kw, tol=TR, nojit=True,
              wider=not isinstance(scalar, float))


def test_special_gradients():
    x = values("float32", lo=0.3, hi=2.0, seed=2)
    for name in ("gammaln", "erf", "digamma", "rsqrt", "gamma"):
        t, j = grads("npx." + name, (x,), {})
        same(t, j, RED)


def test_gamma_is_signed():
    """The port's ``gamma`` is Gamma(x) with its sign (MXNet's); the
    reference gives |Gamma(x)| below 0, so no case here takes its
    value there (ROADMAP.md, not queued)."""
    x = onp.array([-2.5, -1.5, -0.5, 0.5, 1.5, 4.0], "f4")
    want = onp.array([-0.9453087, 2.3632718, -3.5449077, 1.7724539,
                      0.8862269, 6.0], "f4")
    onp.testing.assert_allclose(tmx.npx.gamma(lift(tmx, x)).asnumpy(), want,
                                rtol=2e-6)


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "int8", "float32"])
def test_index_add_update(dtype):
    x = values(dtype, shape=(4, 3), seed=3)
    idx = onp.array([[0, 2, 2, 3], [1, 0, 0, 2]], "i4")
    v = values(dtype, shape=(4,), seed=4)
    check("npx.index_add", (x, idx, v), tol=RED, nojit=True)
    # distinct coordinates: a repeated one's winner is undefined
    check("npx.index_update", (x, idx[:, :2], v[:2]), tol=RED, nojit=True)
    check("npx.index_update", (x, idx[:1, 1:3].astype("f4"),
                               values(dtype, shape=(2, 3), seed=5)),
          tol=RED, nojit=True)


def test_index_add_gradient():
    x = values("float32", shape=(4, 3), seed=6)
    idx = onp.array([[0, 2, 2], [1, 0, 0]], "i4")
    v = values("float32", shape=(3,), seed=7)
    t, j = grads("npx.index_add", (x, idx, v), {}, wrt=(0, 2))
    same(t, j, RED)


@pytest.mark.parametrize("dtype", ["bool", "uint16", "uint32", "int32",
                                   "float16"])
def test_gather_scatter_boolean_mask(dtype):
    x = values(dtype, shape=(3, 4, 2), seed=8)
    idx = onp.array([[0, 2, 1, 2], [3, 0, 1, 3]], "i4")
    check("npx.gather_nd", (x, idx), nojit=True)
    d = values(dtype, shape=(4, 2), seed=9)
    check("npx.scatter_nd", (d[:3], idx[:, :3]), {"shape": (3, 4, 2)},
          nojit=True)
    m = onp.array([1, 0, 1], "i4")
    check("npx.boolean_mask", (x, m), nojit=True)
    check("npx.boolean_mask", (x, onp.array([0, 1, 1, 0], "f4")),
          {"axis": 1}, nojit=True)


def test_gather_nd_gradient():
    x = values("float32", shape=(3, 4), seed=10)
    idx = onp.array([[0, 2, 2], [3, 1, 1]], "i4")
    t, j = grads("npx.gather_nd", (x, idx), {})
    same(t, j, RED)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int8", "int32",
                                   "bool", "float16", "float32"])
def test_batch_dot(dtype):
    a = values(dtype, shape=(2, 3, 4), seed=11)
    b = values(dtype, shape=(2, 4, 5), seed=12)
    check("npx.batch_dot", (a, b), tol=RED, nojit=True)
    check("npx.batch_dot", (a, b.transpose(0, 2, 1).copy()),
          {"transpose_b": True}, tol=RED, nojit=True)
    if dtype == "float32":
        check("npx.batch_dot", (a.transpose(0, 2, 1).copy(), b),
              {"transpose_a": True}, tol=RED, nojit=True)
        t, j = grads("npx.batch_dot", (a, b), {}, wrt=(0, 1))
        same(t, j, RED)


def test_slices_and_shape_helpers():
    x = values("float32", shape=(4, 5, 3), seed=13)
    y = values("float32", shape=(2, 3), seed=14)
    check("npx.slice", (x, (1, None, 0), (3, None, 2)), nojit=True)
    check("npx.slice", (x, (None, 4), (None, 0), (None, -2)), nojit=True)
    check("npx.slice_like", (x, y), nojit=True)
    check("npx.slice_like", (x, y), {"axes": (1,)}, nojit=True)
    check("npx.slice_axis", (x, 1, 1, 4), nojit=True)
    check("npx.broadcast_like", (y[:1], y), nojit=True)
    check("npx.reshape_like", (x[:2, :3, :1], y), nojit=True)
    check("npx.shape_array", (x,), nojit=True)
    t, j = grads("npx.slice", (x, (None, 4), (None, 0), (None, -2)), {})
    same(t, j, RED)


@pytest.mark.parametrize("dtype", ["int8", "uint32", "float16", "float32"])
def test_arange_like_index_array_smooth_l1(dtype):
    x = values(dtype, shape=(2, 3), seed=15)
    check("npx.arange_like", (x,), nojit=True)
    check("npx.arange_like", (x,), {"start": 1.5, "step": 0.5, "axis": 1},
          nojit=True)
    check("npx.index_array", (x,), nojit=True)
    check("npx.index_array", (x,), {"axes": (1,)}, nojit=True)
    check("npx.smooth_l1", (x,), {"scalar": 1.5}, tol=EW, nojit=True)


def test_multi_tensor_helpers():
    a = values("float32", shape=(3, 4), seed=16)
    b = values("float16", shape=(5,), seed=17)
    c = values("int32", shape=(2, 2), seed=18)
    bad = a.copy()
    bad[1, 2] = onp.inf
    check("npx.multi_sum_sq", (a, b, c), tol=RED, nojit=True)
    check("npx.all_finite", (a,), nojit=True)
    check("npx.all_finite", (bad,), nojit=True)
    check("npx.multi_all_finite", (a, b, c), nojit=True)
    check("npx.multi_all_finite", (a, bad), nojit=True)


def test_npx_random():
    """``npx.random`` re-exports ``mx.np.random``'s samplers, seeded by
    the same generators."""
    names = ("seed", "bernoulli", "uniform", "normal", "randint", "gamma",
             "exponential", "multinomial")
    for name in names:
        assert getattr(tmx.npx.random, name) is getattr(tmx.np.random, name)
        assert hasattr(jmx.npx.random, name)
    tmx.npx.random.seed(5)
    a = tmx.npx.random.uniform(size=(4,)).asnumpy()
    b = tmx.npx.random.bernoulli(0.5, size=(3,))
    tmx.npx.random.seed(5)
    onp.testing.assert_array_equal(tmx.npx.random.uniform(size=(4,))
                                   .asnumpy(), a)
    assert b.shape == (3,)


def test_np_mode_switches():
    """``set_np(dtype=True)`` makes creation and random ops float64 and
    keeps 64-bit results, as in the reference (whose x64 switch flips
    for the whole process: both packages are restored)."""
    for pkg in (tmx, jmx):
        assert pkg.npx.is_np_array() and pkg.npx.is_np_shape()
        assert pkg.is_np_array() and pkg.is_np_shape()
    res = []
    try:
        for pkg in (tmx, jmx):
            pkg.npx.set_np(dtype=True)
            assert pkg.is_np_default_dtype()
            a = pkg.np.ones((2, 3))
            b = pkg.np.array([1.0, 2.0])
            c = a * 2.0 + 1.0
            r = pkg.np.random.uniform(size=(2,))
            res.append([a, b, c, pkg.np.sum(c)])
            assert r.dtype == onp.float64
    finally:
        for pkg in (tmx, jmx):
            pkg.npx.reset_np()
    same(res[0], res[1], EW)
    for pkg in (tmx, jmx):
        assert not pkg.is_np_default_dtype()
        assert pkg.np.ones((2,)).dtype == onp.float32


def test_integer_input_takes_the_default_float():
    """An integer input of a float function of ``npx`` computes in the
    default float, as ``np.sin``'s does: float64 under
    ``set_np(dtype=True)``, float32 after ``reset_np()``."""
    i = tmx.np.array(onp.array([[[[1, 2], [3, 4]]]], "i4"))
    fns = [lambda a: tmx.np.sin(a), lambda a: tmx.npx.erf(a),
           lambda a: tmx.npx.sigmoid(a), lambda a: tmx.npx.softmin(a),
           lambda a: tmx.npx.pooling(a, kernel=2, pool_type="avg"),
           lambda a: tmx.npx.pooling(a, pool_type="avg", global_pool=True)]
    try:
        tmx.npx.set_np(dtype=True)
        assert [f(i).dtype for f in fns] == [onp.float64] * len(fns)
    finally:
        tmx.npx.reset_np()
    assert [f(i).dtype for f in fns] == [onp.float32] * len(fns)


def test_random_state_helpers():
    """``next_key`` gives the device's global generator and
    ``request_key`` a generator of its own seed (the reference's JAX
    keys' counterparts); ``trace_rng`` is a scope that does nothing."""
    from mxnet_tpu_torch import random_state as rs
    rs.seed(11)
    k = rs.next_key("cpu")
    assert k is rs.generator(torch.device("cpu"))
    d1, d2 = (torch.rand(3, generator=rs.next_key("cpu")) for _ in "ab")
    rs.seed(11)
    d1b = torch.rand(3, generator=rs.next_key("cpu"))
    assert torch.equal(d1, d1b) and not torch.equal(d1, d2)
    r1, r2 = rs.request_key(7, "cpu"), rs.request_key(7, "cpu")
    assert torch.equal(torch.rand(3, generator=r1),
                       torch.rand(3, generator=r2))
    with rs.trace_rng(object()) as scope:
        assert scope is not None


def _contrib(mod):
    """The callables ``mod`` (the reference's npx) imports from its
    ``contrib_ops`` submodule."""
    co = vars(mod.contrib_ops)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and callable(v)
                  and co.get(n) is v and n != "apply_op")


def _own_public(mod):
    """The public functions ``mod`` (the reference's npx) defines itself
    or in ``control_flow``, with the np-mode switches and ``random``
    it exports."""
    contrib = set(_contrib(mod))
    out = {"set_np", "reset_np", "is_np_array", "is_np_shape", "random"}
    for name, v in vars(mod).items():
        if name.startswith("_") or name in contrib or isinstance(v, type) \
                or not callable(v):
            continue
        if (getattr(v, "__module__", "") or "").startswith(mod.__name__):
            out.add(name)
    return out


#: names the reference defines itself that wait for a later item
LATER = {"ring_attention": ("item 20", 3), "load": ("item 18", 1),
         "save": ("item 18", 2)}


def test_name_parity():
    ref = _own_public(jmx.npx)
    assert len(ref) >= 80
    missing = sorted(n for n in ref if n not in vars(tmx.npx))
    assert not missing, missing
    for name, (item, nargs) in LATER.items():
        with pytest.raises(NotPortedError, match=item):
            getattr(tmx.npx, name)(*([None] * nargs))
    assert set(tmx.npx.__all__) <= set(vars(tmx.npx))


def test_contrib_names_still_raise():
    """The reference's ``contrib_ops.py`` names (item 13b-ii) are all
    ported: each is in the port's ``npx.__all__`` and resolves to a
    function of its ``contrib_ops`` (``multi_proposal`` is
    ``proposal``, as in the reference)."""
    contrib = _contrib(jmx.npx)
    assert len(contrib) == 42
    missing = [n for n in contrib if n not in tmx.npx.__all__]
    assert not missing, missing
    for name in contrib:
        fn = getattr(tmx.npx, name)
        assert callable(fn)
        assert fn is getattr(tmx.npx.contrib_ops, name)
    assert tmx.npx.multi_proposal is tmx.npx.proposal
