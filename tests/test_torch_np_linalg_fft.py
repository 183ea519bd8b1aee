"""The port's mx.np.linalg and mx.np.fft against the JAX package's, on
the CPU. Solves, inverses, norms and other values at 1e-5;
decompositions by reconstruction at 1e-4 relative to the input's
largest entry (their factors' signs and phases may differ) with the
invariant parts (singular values, eigenvalues) at 1e-5; the FFTs at
1e-5 x max|X|, complex64 as JAX's; gradients of ``inv``, ``det``,
``solve`` and ``cholesky`` under ``autograd.record()``. ``eig`` and
``eigvals`` take the host route, as the reference's do."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import RED, call, check, lift, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _spd(n, seed):
    a = values("float32", shape=(n, n), seed=seed)
    return (a @ a.T + n * onp.eye(n, dtype="f4")).astype("f4")


A = values("float32", shape=(4, 4), seed=100) + 3 * onp.eye(4, dtype="f4")
B = values("float32", shape=(4, 2), seed=101)
R = values("float32", shape=(5, 3), seed=102)
S = _spd(4, 103)

VALUES = [
    ("linalg.inv", (A,), {}), ("linalg.det", (A,), {}),
    ("linalg.slogdet", (A,), {}), ("linalg.solve", (A, B), {}),
    ("linalg.solve", (A, B[:, 0]), {}), ("linalg.pinv", (R,), {}),
    ("linalg.norm", (A,), {}), ("linalg.norm", (A,), {"ord": "nuc"}),
    ("linalg.norm", (A,), {"ord": onp.inf}), ("linalg.norm", (R[:, 0],),
                                               {"ord": 3}),
    ("linalg.norm", (R,), {"axis": 0, "ord": 1, "keepdims": True}),
    ("linalg.matrix_rank", (R @ R.T,), {}),
    ("linalg.matrix_rank", (R[:, 0],), {}),
    ("linalg.matrix_power", (A, 3), {}), ("linalg.matrix_power", (A, -1), {}),
    ("linalg.multi_dot", ([R.T, R, R[0]],), {}),
    ("linalg.cond", (A,), {}), ("linalg.cond", (A,), {"p": -2}),
    ("linalg.cond", (A,), {"p": "fro"}),
    ("linalg.eigvalsh", (S,), {}), ("linalg.eigvalsh", (S,), {"UPLO": "U"}),
    ("linalg.tensorinv", (A.reshape(2, 2, 2, 2),), {}),
    ("linalg.tensorsolve", (A.reshape(2, 2, 2, 2), B[:, 0].reshape(2, 2)),
     {}),
    ("linalg.lstsq", (R, B[:, :1].repeat(2, 0)[:5]), {}),
    ("linalg.lstsq", (R, R[:, 0]), {"rcond": None}),
    ("linalg.inv", (values("int32", shape=(2, 2), seed=104)
                    + 9 * onp.eye(2, dtype="i4"),), {}),
]


@pytest.mark.parametrize("path,args,kw", VALUES, ids=lambda v: repr(v))
def test_values(path, args, kw):
    check(path, args, kw, tol=RED)


def _close_rel(t, j, scale):
    onp.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * scale)


def _decomp(path, a, kw=None):
    outs = [call(pkg, path, (a,), kw or {}) for pkg in (tmx, jmx)]
    for o_t, o_j in zip(outs[0], outs[1]):
        assert o_t.dtype == o_j.dtype and o_t.shape == o_j.shape, \
            (path, o_t.dtype, o_j.dtype, o_t.shape, o_j.shape)
    return [[o.asnumpy() for o in out] for out in outs]


def test_svd_by_reconstruction():
    for a in (R, A, values("float32", shape=(2, 3, 4), seed=105)):
        (u, s, vh), (_, sj, _) = _decomp("linalg.svd", a)
        onp.testing.assert_allclose(s, sj, **RED)
        _close_rel(u @ (s[..., None] * vh), a, onp.abs(a).max())


def test_qr_by_reconstruction():
    for mode in ("reduced", "complete"):
        (q, r), (qj, rj) = _decomp("linalg.qr", R, {"mode": mode})
        _close_rel(q @ r, R, onp.abs(R).max())
        onp.testing.assert_allclose(onp.abs(onp.diag(r)),
                                    onp.abs(onp.diag(rj)), **RED)
        _close_rel(q.T @ q, onp.eye(q.shape[1]), 1.0)


def test_cholesky_and_eigh_by_reconstruction():
    for upper in (False, True):
        lt = tmx.np.linalg.cholesky(lift(tmx, S), upper=upper).asnumpy()
        lj = jmx.np.linalg.cholesky(lift(jmx, S), upper=upper).asnumpy()
        onp.testing.assert_allclose(lt, lj, **RED)
        full = lt.T @ lt if upper else lt @ lt.T
        _close_rel(full, S, onp.abs(S).max())
    (w, v), (wj, _) = _decomp("linalg.eigh", S)
    onp.testing.assert_allclose(w, wj, **RED)
    _close_rel(v @ onp.diag(w) @ v.T, S, onp.abs(S).max())


def test_eig_host_route():
    a = values("float32", shape=(4, 4), seed=106)
    sym = a + a.T
    for m in (a, sym):
        check("linalg.eigvals", (m,), tol=RED)
        (w, v), (wj, vj) = _decomp("linalg.eig", m)
        onp.testing.assert_allclose(onp.sort_complex(w), onp.sort_complex(wj),
                                    **RED)
        _close_rel(m @ v, v * w, onp.abs(m).max() * 4)


@pytest.mark.parametrize("path", ["linalg.inv", "linalg.det",
                                  "linalg.cholesky", "linalg.solve"])
def test_gradient(path):
    grads = []
    for pkg in (tmx, jmx):
        a = pkg.np.array(S if path == "linalg.cholesky" else A)
        a.attach_grad()
        with pkg.autograd.record():
            args = (a, pkg.np.array(B)) if path == "linalg.solve" else (a,)
            fn = pkg.np.linalg
            for part in path.split(".")[1:]:
                fn = getattr(fn, part)
            r = fn(*args)
            s = (r * r).sum()
        s.backward()
        grads.append(a.grad)
    same(grads[0], grads[1], dict(rtol=1e-4, atol=1e-4))


# ---------------------------------------------------------------------------
# fft
# ---------------------------------------------------------------------------
X1 = values("float32", shape=(16,), seed=110)
X2 = values("float32", shape=(4, 8), seed=111)
C1 = (X1 + 1j * values("float32", shape=(16,), seed=112)).astype("c8")

FFTS = [
    ("fft", (X1,), {"n": 12, "norm": "ortho"}), ("ifft", (C1,), {}),
    ("rfft", (X2,), {"axis": 0}),
    ("irfft", (C1[:9],), {}), ("irfft", (C1[:9],), {"n": 16,
                                                    "norm": "forward"}),
    ("hfft", (C1[:9],), {}), ("ihfft", (X1,), {}),
    ("fft2", (X2,), {}), ("ifft2", (X2,), {"s": (4, 4)}),
    ("rfft2", (X2,), {}), ("irfft2", (X2.astype("c8"),), {}),
    ("fftn", (X2,), {}), ("ifftn", (X2,), {"axes": (1,)}),
    ("rfftn", (X2,), {"norm": "ortho"}), ("irfftn", (X2.astype("c8"),), {}),
    ("fft", (values("int32", shape=(8,), seed=113),), {}),
    ("fftshift", (X2,), {}), ("ifftshift", (X2,), {"axes": (1,)}),
]


@pytest.mark.parametrize("name,args,kw", FFTS, ids=lambda v: repr(v))
def test_fft(name, args, kw):
    scale = float(onp.abs(args[0]).max()) * args[0].size
    check(f"fft.{name}", args, kw, tol=dict(rtol=0, atol=1e-5 * scale))


def test_fftfreq():
    for n, d in ((8, 1.0), (9, 0.25)):
        check("fft.fftfreq", (n, d))
        check("fft.rfftfreq", (n, d))


def test_complex_arrays_carry():
    c = tmx.np.array(C1)
    assert c.dtype == onp.complex64
    onp.testing.assert_array_equal(c.asnumpy(), C1)
    assert c.astype("complex64").dtype == onp.complex64
    assert tmx.np.array(C1.astype("c16")).dtype == onp.complex64
    back = tmx.np.fft.ifft(tmx.np.fft.fft(tmx.np.array(X1)))
    onp.testing.assert_allclose(back.asnumpy().real, X1, atol=1e-5)
