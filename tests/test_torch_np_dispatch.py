"""The port's NumPy dispatch protocol, host fallback and module surface
against the JAX package's, on the CPU: the cases of
``tests/test_numpy_interop.py`` (``numpy.foo(mx_arr)`` and NumPy ufuncs
run the port's native functions; the rest falls back to the host and
counts), the parity of the public names of ``mxnet_tpu.numpy`` and its
``linalg``, ``fft`` and ``random`` with the port's (each defined
natively, none through the fallback), ``npx.decode_attention``'s plain
route at the card-sized shapes of ``chip_smoke.py``'s ``decode`` phase,
and the rest of the module (``save``/``savez``/``load``, the legacy
aliases, ``fill_diagonal``, ``genfromtxt``/``fromiter``, the financial
functions)."""
import io
import types

import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray.ndarray import NDArray

from test_torch_np_common import RED, check, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _mx(a):
    return tmx.np.array(onp.asarray(a, dtype=onp.float32))


def _fallbacks():
    return sum(tmx.np.FALLBACK_CALLS.values())


# ---------------------------------------------------------------------------
# the cases of tests/test_numpy_interop.py:17-128
# ---------------------------------------------------------------------------
def test_array_function_routes_to_native():
    n = _fallbacks()
    a = _mx([[1.0, 2.0], [3.0, 4.0]])
    out = onp.sum(a)
    assert isinstance(out, NDArray) and float(out.item()) == 10.0
    out = onp.concatenate([a, a], axis=1)
    assert isinstance(out, NDArray) and out.shape == (2, 4)
    out = onp.transpose(a)
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [[1, 3], [2, 4]])
    for fn, args in ((onp.cumsum, (a,)), (onp.sort, (a,)),
                     (onp.median, (a,)), (onp.pad, (a, 1)),
                     (onp.unique, (a,)), (onp.einsum, ("ij->j", a))):
        assert isinstance(fn(*args), NDArray), fn.__name__
    assert _fallbacks() == n


def test_array_function_mixed_args():
    a = _mx([1.0, 2.0])
    out = onp.stack([a, onp.array([3.0, 4.0], onp.float32)])
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [[1, 2], [3, 4]])


def test_array_ufunc_call():
    n = _fallbacks()
    a = _mx([1.0, 4.0, 9.0])
    out = onp.sqrt(a)
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [1, 2, 3])
    out = onp.add(a, onp.ones(3, onp.float32))
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [2, 5, 10])
    out = onp.arctan2(a, a)
    assert isinstance(out, NDArray)
    assert _fallbacks() == n


def test_array_ufunc_reduce_falls_back():
    n = _fallbacks()
    a = _mx([1.0, 2.0, 3.0])
    out = onp.add.reduce(a)
    assert float(out.item() if isinstance(out, NDArray) else out) == 6.0
    assert _fallbacks() == n + 1


def test_linalg_dispatch():
    m = _mx([[2.0, 0.0], [0.0, 3.0]])
    out = onp.linalg.inv(m)
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [[0.5, 0], [0, 1 / 3]],
                                rtol=1e-6)
    assert isinstance(onp.fft.fft(m), NDArray)


def test_fallback_for_unimplemented():
    n = _fallbacks()
    a = _mx([0.0, 1.0, 2.0])
    out = tmx.np.unwrap(a)
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), onp.unwrap([0.0, 1.0, 2.0]))
    assert tmx.np.FALLBACK_CALLS["unwrap"] >= 1 and _fallbacks() == n + 1


def test_fallback_docstring_marks_host():
    doc = tmx.np.unwrap.__doc__.lower()
    assert "fallback" in doc and "host" in doc


def test_fallback_unknown_name_raises():
    with pytest.raises(AttributeError):
        tmx.np.this_function_does_not_exist  # noqa: B018


def test_fft_roundtrip():
    x = _mx(onp.random.RandomState(0).randn(16))
    back = tmx.np.fft.ifft(tmx.np.fft.fft(x))
    onp.testing.assert_allclose(back.asnumpy().real, x.asnumpy(), atol=1e-5)
    r = tmx.np.fft.rfft(x)
    assert r.shape == (9,)
    onp.testing.assert_allclose(tmx.np.fft.irfft(r, n=16).asnumpy(),
                                x.asnumpy(), atol=1e-5)


def test_fft2():
    x = _mx(onp.random.RandomState(1).randn(4, 8))
    onp.testing.assert_allclose(tmx.np.fft.fft2(x).asnumpy(),
                                onp.fft.fft2(x.asnumpy()), rtol=1e-4,
                                atol=1e-4)


def test_einsum_matches_numpy():
    rng = onp.random.RandomState(2)
    a = rng.randn(3, 4).astype(onp.float32)
    b = rng.randn(4, 5).astype(onp.float32)
    got = tmx.np.einsum("ij,jk->ik", _mx(a), _mx(b)).asnumpy()
    onp.testing.assert_allclose(got, onp.einsum("ij,jk->ik", a, b),
                                rtol=1e-5)


def test_comparison_with_numpy_operand():
    a = _mx([1.0, 5.0])
    out = onp.array([2.0, 2.0], onp.float32) < a
    assert isinstance(out, NDArray)
    assert out.asnumpy().tolist() == [False, True]
    out = onp.array([1.0, 1.0], onp.float32) + a
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [2.0, 6.0])


# ---------------------------------------------------------------------------
# name parity: every public function of the JAX package's modules is
# defined natively in the port's counterpart
# ---------------------------------------------------------------------------
def _public(mod):
    """The public callables a module defines or re-exports from NumPy
    (not those it imports from the rest of its package)."""
    out = set()
    for name, v in vars(mod).items():
        if name.startswith("_") or isinstance(v, types.ModuleType) \
                or not callable(v):
            continue
        m = getattr(v, "__module__", "") or ""
        if m.startswith("mxnet_tpu.") and not m.startswith(mod.__name__):
            continue
        out.add(name)
    return out


@pytest.mark.parametrize("sub", ["", ".linalg", ".fft", ".random"])
def test_name_parity(sub):
    jm = eval("jmx.np" + sub)
    tm = eval("tmx.np" + sub)
    missing = sorted(n for n in _public(jm) if n not in vars(tm))
    assert not missing, missing
    n = _fallbacks()
    for name in _public(jm):
        # dtypes are names, not functions (the port's bfloat16 is torch's)
        assert callable(vars(tm)[name]) or isinstance(vars(jm)[name],
                                                      type), name
    assert _fallbacks() == n
    if not sub:
        for const in ("pi", "e", "euler_gamma", "inf", "nan", "newaxis",
                      "PZERO", "NZERO"):
            assert vars(tm)[const] == vars(jm)[const] \
                or onp.isnan(vars(jm)[const])


# ---------------------------------------------------------------------------
# npx.decode_attention: the plain route at the decode phase's shapes
# ---------------------------------------------------------------------------
def test_decode_attention_plain_route():
    rs = onp.random.RandomState(3)
    b, h, s, d = 8, 12, 1024, 64
    q = rs.randn(b, h, 1, d).astype("f4")
    k = rs.randn(b, h, s, d).astype("f4")
    v = rs.randn(b, h, s, d).astype("f4")
    ln = onp.array([0, 1, 63, 64, 65, 500, 1023, 1024], "i4")
    outs = []
    for pkg in (tmx, jmx):
        outs.append(pkg.npx.decode_attention(
            pkg.np.array(q), pkg.np.array(k), pkg.np.array(v),
            pkg.np.array(ln, dtype="int32")))
    same(outs[0], outs[1], RED)
    assert float(abs(outs[0].asnumpy()[0]).max()) == 0.0
    scaled = tmx.npx.decode_attention(tmx.np.array(q[:2, :, :, :]),
                                      tmx.np.array(k[:2, :, :64]),
                                      tmx.np.array(v[:2, :, :64]),
                                      tmx.np.array(ln[2:4]), scale=0.5)
    ref = jmx.npx.decode_attention(jmx.np.array(q[:2]),
                                   jmx.np.array(k[:2, :, :64]),
                                   jmx.np.array(v[:2, :, :64]),
                                   jmx.np.array(ln[2:4], dtype="int32"),
                                   scale=0.5)
    same(scaled, ref, RED)


# ---------------------------------------------------------------------------
# the rest of the module
# ---------------------------------------------------------------------------
def test_save_savez_load(tmp_path):
    x = values("float32", shape=(3, 4), seed=120)
    i = values("int32", shape=(5,), seed=121)
    for pkg, tag in ((tmx, "t"), (jmx, "j")):
        pkg.np.save(str(tmp_path / f"{tag}.npy"), pkg.np.array(x))
        pkg.np.savez(str(tmp_path / f"{tag}.npz"), pkg.np.array(x),
                     ints=pkg.np.array(i, dtype="int32"))
    for ext in ("npy", "npz"):
        same(tmx.np.load(str(tmp_path / f"t.{ext}")),
             jmx.np.load(str(tmp_path / f"j.{ext}")))


def test_legacy_aliases_and_windows():
    x = values("float32", shape=(3, 4), seed=122)
    for name in ("alltrue", "sometrue", "product", "msort"):
        check(name, (x,), tol=RED)
    for name in ("blackman", "hamming", "hanning"):
        check(name, (7,))
        check(name, (6,), {"dtype": "float16"})


@pytest.mark.parametrize("shape,val,wrap", [
    ((3, 3), 5.0, False), ((5, 3), onp.array([1.0, 2.0]), True),
    ((5, 3), 7.0, False), ((3, 3, 3), 2.0, False)], ids=repr)
def test_fill_diagonal(shape, val, wrap):
    x = values("float32", shape=shape, seed=123)
    outs = []
    for pkg in (tmx, jmx):
        a = pkg.np.array(x)
        v = pkg.np.array(val) if isinstance(val, onp.ndarray) else val
        assert pkg.np.fill_diagonal(a, v, wrap=wrap) is None
        outs.append(a)
    same(outs[0], outs[1])


def test_text_and_iter_sources():
    text = "1 2 3\n4 5 6\n"
    same(tmx.np.genfromtxt(io.StringIO(text)),
         jmx.np.genfromtxt(io.StringIO(text)))
    same(tmx.np.fromiter(range(5), dtype="int32"),
         jmx.np.fromiter(range(5), dtype="int32"))
    assert tmx.np.get_printoptions() == jmx.np.get_printoptions()
    assert tmx.np.get_include() == jmx.np.get_include()


FINANCIAL = [
    ("fv", (0.05 / 12, 120, -100, -100), {}),
    ("fv", (0.0, 10, -100, -1000), {"when": "begin"}),
    ("pv", (0.07 / 12, 240, -500), {}), ("pv", (0.0, 12, -100), {}),
    ("pmt", (0.075 / 12, 180, 200000), {}),
    ("pmt", (0.05, 10, 1000, 100), {"when": 1}),
    ("nper", (0.07 / 12, -150, 8000), {}), ("nper", (0.0, -100, 1000), {}),
    ("ipmt", (0.1 / 12, 3, 24, 2000), {}),
    ("ipmt", (0.1 / 12, 1, 24, 2000), {"when": "begin"}),
    ("ppmt", (0.1 / 12, 5, 60, 55000), {}),
    ("npv", (0.28, [-100, 39, 59, 55, 20]), {}),
    ("mirr", ([-4500, -800, 800, 800, 600, 600, 800, 800, 700, 3000],
              0.08, 0.055), {}),
    ("irr", ([-150000, 15000, 25000, 35000, 45000, 60000],), {}),
    ("irr", ([-100, 0, 0, 74],), {}),
    ("rate", (10, 0, -3500, 10000), {}),
    ("fv", (onp.array([0.05, 0.07], "f4") / 12, 120, -100, -100), {}),
    ("pmt", (0.05 / 12, onp.array([60, 120], "i4"), 1000), {}),
]


@pytest.mark.parametrize("name,args,kw", FINANCIAL, ids=lambda v: repr(v))
def test_financial(name, args, kw):
    check(name, args, kw, tol=dict(rtol=1e-6, atol=1e-9))
