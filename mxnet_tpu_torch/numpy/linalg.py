"""mx.np.linalg — NumPy-semantics linear algebra.

The port of ``mxnet_tpu/numpy/linalg.py``: each function lowers to
``torch.linalg`` (or, where jnp has a formula of its own, that formula
in torch) through ``ops.apply_op``, on the arrays' device, differentiable
under ``autograd.record()``. Integer and bool inputs compute in float32,
as jnp promotes them. Factors of a decomposition (signs of singular
vectors, phases of eigenvectors) may differ from the reference's; their
products do not.

``eig`` and ``eigvals`` are the one exception: they run on the HOST
through NumPy's LAPACK ``geev``, as the reference itself routes them
(general eig has no accelerator lowering there).
"""
from __future__ import annotations

import builtins

import numpy as onp
import torch

from ..ops import apply_op

__all__ = ["norm", "svd", "cholesky", "qr", "inv", "pinv", "det", "slogdet",
           "solve", "lstsq", "tensorinv", "tensorsolve", "eig", "eigh",
           "eigvals", "eigvalsh", "matrix_rank", "matrix_power",
           "multi_dot", "cond"]


def _c(x):
    from . import _coerce
    return _coerce(x)


def _f(x):
    """x in its inexact type (float32 for integers and bool)."""
    from . import _inexact
    return x.to(_inexact(x.dtype))


def _u(fn, a, name, nout=1):
    return apply_op(lambda x: fn(_f(x)), _c(a), nout=nout, name=name)


def _pair(fn, a, b, name):
    def f(x, y):
        from . import _inexact
        dt = _inexact(torch.promote_types(x.dtype, y.dtype))
        return fn(x.to(dt), y.to(dt))
    return apply_op(f, _c(a), _c(b), name=name)


def norm(x, ord=None, axis=None, keepdims=False):
    def f(a):
        ax = tuple(axis) if isinstance(axis, list) else axis
        if ax is None and ord is None:
            return torch.linalg.vector_norm(a, 2, dim=None, keepdim=keepdims)
        if ax is None:
            ax = tuple(builtins.range(a.dim()))
        return torch.linalg.norm(a, ord=ord, dim=ax, keepdim=keepdims)
    return _u(f, x, "norm")


def svd(a):
    """Returns (U, S, Vh) with ``full_matrices=False``, as the reference."""
    return _u(lambda x: tuple(torch.linalg.svd(x, full_matrices=False)), a,
              "svd", nout=3)


def cholesky(a, upper=False):
    return _u(lambda x: torch.linalg.cholesky(x, upper=upper), a, "cholesky")


def qr(a, mode="reduced"):
    if mode == "r":
        return _u(lambda x: torch.linalg.qr(x, mode="r")[1], a, "qr")
    return _u(lambda x: tuple(torch.linalg.qr(x, mode=mode)), a, "qr",
              nout=2)


def inv(a):
    return _u(torch.linalg.inv, a, "inv")


def pinv(a, rcond=1e-15, hermitian=False):
    return _u(lambda x: torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian),
              a, "pinv")


def det(a):
    return _u(torch.linalg.det, a, "det")


def slogdet(a):
    return _u(lambda x: tuple(torch.linalg.slogdet(x)), a, "slogdet",
              nout=2)


def _solve(x, y):
    if y.dim() == 1:
        return torch.linalg.solve(x, y[:, None])[..., 0]
    return torch.linalg.solve(x, y)


def solve(a, b):
    return _pair(_solve, a, b, "solve")


def _lstsq(rcond):
    """jnp's ``_lstsq``: the SVD solution over the singular values at
    least ``rcond`` times the largest (default eps * max(m, n)); the
    residual is always the squared norm of ``b - a x``."""
    def f(a, b):
        vec = b.dim() == 1
        b = b[:, None] if vec else b
        m, n = a.shape
        eps = torch.finfo(a.dtype).eps
        rc = eps * builtins.max(m, n) if rcond is None else (
            eps if rcond < 0 else rcond)
        u, s, vt = torch.linalg.svd(a, full_matrices=False)
        mask = (s > 0) & (s >= rc * s[0])
        rank = mask.sum().to(torch.int32)
        safe = torch.where(mask, s, torch.ones_like(s))
        s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
        x = vt.conj().T @ (s_inv * (u.conj().T @ b))
        resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
        return (x.reshape(-1) if vec else x), resid, rank, s
    return f


def lstsq(a, b, rcond="warn"):
    rc = None if rcond in ("warn", None) else rcond
    fn = _lstsq(rc)

    def f(x, y):
        from . import _inexact
        dt = _inexact(torch.promote_types(x.dtype, y.dtype))
        return fn(x.to(dt), y.to(dt))
    return apply_op(f, _c(a), _c(b), nout=4, name="lstsq")


def tensorinv(a, ind=2):
    def f(x):
        out_shape = x.shape[ind:] + x.shape[:ind]
        k = int(onp.prod(x.shape[:ind]))
        return torch.linalg.inv(x.reshape(k, -1)).reshape(out_shape)
    return _u(f, a, "tensorinv")


def tensorsolve(a, b, axes=None):
    def f(x, y):
        if axes is not None:
            allaxes = list(builtins.range(x.dim()))
            for k in axes:
                allaxes.remove(k)
                allaxes.insert(x.dim(), k)
            x = x.permute(allaxes)
        out_shape = x.shape[-(x.dim() - y.dim()):]
        k = int(onp.prod(out_shape))
        sol = torch.linalg.solve(x.reshape(-1, k), y.reshape(-1)[:, None])
        return sol[:, 0].reshape(out_shape)
    return _pair(f, a, b, "tensorsolve")


def eig(a):
    """HOST route, as the reference: NumPy's LAPACK ``geev`` on a host
    copy; real eigenvalues come back real, complex ones complex64."""
    from . import array
    w, v = onp.linalg.eig(_c(a).asnumpy())
    return array(w.real if not onp.iscomplexobj(w) else w), \
        array(v.real if not onp.iscomplexobj(v) else v)


def eigh(a, UPLO="L"):
    return _u(lambda x: tuple(torch.linalg.eigh(x, UPLO=UPLO)), a, "eigh",
              nout=2)


def eigvals(a):
    """HOST route, as the reference (NumPy's LAPACK ``geev``)."""
    from . import array
    w = onp.linalg.eigvals(_c(a).asnumpy())
    return array(w.real if not onp.iscomplexobj(w) else w)


def eigvalsh(a, UPLO="L"):
    return _u(lambda x: torch.linalg.eigvalsh(x, UPLO=UPLO), a, "eigvalsh")


def matrix_rank(M, tol=None, hermitian=False):
    """jnp's rule: the singular values above ``tol`` (default the
    largest times max(m, n) times eps); a vector's rank is whether it
    has a nonzero entry."""
    def f(x):
        if x.dim() < 2:
            return (x != 0).any().to(torch.int32)
        s = torch.linalg.svdvals(x)
        t = tol
        if t is None:
            t = s.amax(-1) * builtins.max(x.shape[-2:]) \
                * torch.finfo(s.dtype).eps
        t = torch.as_tensor(t, dtype=s.dtype, device=s.device)
        return (s > t[..., None]).sum(-1).to(torch.int32)
    return _u(f, M, "matrix_rank")


def matrix_power(a, n):
    from . import matrix_power as _mp
    return _mp(a, n)


def multi_dot(arrays):
    from . import _matmul
    arrs = [_c(a) for a in arrays]

    def f(*xs):
        r = xs[0]
        for x in xs[1:]:
            r = _matmul(r, x)
        return r
    return apply_op(f, *arrs, name="multi_dot")


def cond(x, p=None):
    """jnp.linalg.cond: the ratio of the extreme singular values for
    p in (None, 2, -2), else norm(x) * norm(inv(x)); NaN from a
    singular matrix becomes inf."""
    def f(a):
        if p is None or p == 2:
            s = torch.linalg.svdvals(a)
            return s[..., 0] / s[..., -1]
        if p == -2:
            s = torch.linalg.svdvals(a)
            r = s[..., -1] / s[..., 0]
        else:
            r = torch.linalg.matrix_norm(a, ord=p) \
                * torch.linalg.matrix_norm(torch.linalg.inv(a), ord=p)
        return torch.where(torch.isnan(r) & ~torch.isnan(a).any((-2, -1)),
                           torch.inf, r)
    return _u(f, x, "cond")
