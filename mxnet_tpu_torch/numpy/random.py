"""mx.np.random — the imperative samplers, drawing from the port's
per-device generators (``random_state.py``) on the device of the
context (or of an NDArray parameter).

The formulas are the reference's (``mxnet_tpu/numpy/random.py``):
``low + u * (high - low)`` with ``u`` in [0, 1), ``loc + scale * z``;
``randint``'s ``high`` is exclusive and its int64 default narrows to
int32 with a bounds check; ``pareto`` is Lomax (``jax.random.pareto -
1``), ``power`` ``u ** (1 / a)``, ``weibull`` a Weibull of scale 1;
``binomial``, ``negative_binomial``, ``poisson``, ``geometric`` and the
float distributions give float32, ``multinomial`` int32 counts,
``choice`` and ``permutation`` of an int n int32. Torch's generators
(Philox on the card) and JAX's Threefry give different numbers for one
seed: the tests compare shapes, dtypes, ranges and distributions, and
the port's own seeded repeats.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import engine
from ..base import default_float, resolve_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..random_state import generator, seed as _seed

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "permutation", "shuffle", "beta", "gamma",
           "exponential", "laplace", "logistic", "gumbel", "lognormal",
           "pareto", "power", "rayleigh", "weibull", "chisquare", "f",
           "binomial", "negative_binomial", "poisson", "geometric",
           "multinomial", "multivariate_normal", "bernoulli"]


def seed(seed_value):
    _seed(int(seed_value))


def _ctx_of(ctx, *params):
    """``ctx``, else the context of the first NDArray parameter, else
    the current one."""
    if ctx is not None:
        return ctx
    for p in params:
        if isinstance(p, NDArray):
            return p.ctx
    return current_context()


def _val(x, dev):
    if isinstance(x, NDArray):
        t = x._data.detach().to(dev)
    else:
        t = torch.as_tensor(onp.asarray(x), device=dev)
    if not t.is_floating_point() or t.dtype == torch.float64:
        # a Python or NumPy number is a weak float32, as in the reference
        t = t.to(default_float())
    return t


def _size(size, *params):
    if size is None:
        return tuple(torch.broadcast_shapes(*(p.shape for p in params)))
    return (int(size),) if isinstance(size, (int, onp.integer)) \
        else tuple(int(s) for s in size)


def _finish(t, ctx, out=None):
    r = NDArray(engine.track(t), ctx=ctx)
    return r if out is None else out._inplace(r)


def _uniform01(shape, dev):
    return torch.rand(shape, generator=generator(dev), device=dev)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, out=None,
            device=None):
    ctx = _ctx_of(ctx or device, low, high)
    dev = ctx.torch_device
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    lo, hi = _val(low, dev), _val(high, dev)
    u = torch.rand(_size(size, lo, hi), generator=generator(dev),
                   dtype=dt, device=dev)
    return _finish((u * (hi - lo) + lo).to(dt), ctx, out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, out=None,
           device=None):
    ctx = _ctx_of(ctx or device, loc, scale)
    dev = ctx.torch_device
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    mu, sd = _val(loc, dev), _val(scale, dev)
    z = torch.randn(_size(size, mu, sd), generator=generator(dev),
                    dtype=dt, device=dev)
    return _finish((mu + sd * z).to(dt), ctx, out)


def randn(*size, dtype=None, ctx=None):
    return normal(0.0, 1.0, size=size or None, dtype=dtype, ctx=ctx)


def rand(*size, dtype=None, ctx=None):
    return uniform(0.0, 1.0, size=size or None, dtype=dtype, ctx=ctx)


def randint(low, high=None, size=None, dtype=None, ctx=None, out=None):
    if high is None:
        low, high = 0, low
    # high is EXCLUSIVE: bounds-check the largest value it can give
    dt = resolve_dtype(dtype if dtype is not None else onp.int64,
                       values=(low, high - 1))
    lo, hi = int(low), int(high)
    info = torch.iinfo(dt)
    if hi > info.max + 1 or lo < info.min:
        raise OverflowError(f"randint bounds [{lo}, {hi}) exceed the "
                            f"{dt} range")
    ctx = ctx or current_context()
    dev = ctx.torch_device
    shape = () if size is None else _size(size)
    t = torch.randint(lo, hi, shape, generator=generator(dev), dtype=dt,
                      device=dev)
    return _finish(t, ctx, out)


def choice(a, size=None, replace=True, p=None, ctx=None, out=None):
    """Draws from ``a`` (an int n: ``arange(n)``, int32) with or without
    replacement, uniformly or by ``p`` (``torch.multinomial``)."""
    ctx = _ctx_of(ctx, a, p)
    dev = ctx.torch_device
    if isinstance(a, (int, onp.integer)):
        arr = torch.arange(int(a), dtype=torch.int32, device=dev)
    elif isinstance(a, NDArray):
        arr = a._data.detach().to(dev)
    else:
        from . import array
        arr = array(a, ctx=ctx)._data
    shape = () if size is None else _size(size)
    k = int(onp.prod(shape))
    n = arr.shape[0]
    gen = generator(dev)
    if p is not None:
        w = _val(p, dev).reshape(-1)
        idx = torch.multinomial(w, k, replacement=replace, generator=gen)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        if k > n:
            raise ValueError("Cannot take a larger sample than population "
                             "when replace=False")
        idx = torch.randperm(n, generator=gen, device=dev)[:k]
    return _finish(arr[idx].reshape(shape + arr.shape[1:]), ctx, out)


def permutation(x, ctx=None):
    ctx = _ctx_of(ctx, x)
    dev = ctx.torch_device
    if isinstance(x, (int, onp.integer)):
        arr = torch.arange(int(x), dtype=torch.int32, device=dev)
    elif isinstance(x, NDArray):
        arr = x._data.detach().to(dev)
    else:
        from . import array
        arr = array(x, ctx=ctx)._data
    perm = torch.randperm(arr.shape[0], generator=generator(dev), device=dev)
    return _finish(arr[perm], ctx)


def shuffle(x):
    """In-place shuffle along the first axis (a new tensor installed in
    ``x``, as every write of the port)."""
    dev = x._data.device
    x._install(x._data[torch.randperm(x.shape[0], generator=generator(dev),
                                      device=dev)])


def _std_gamma(alpha, shape, dev):
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=generator(dev))


def _sampler(params, size, ctx, dtype, draw, out=None):
    """Broadcast the float parameters, draw ``draw(dev, shape, *params)``
    and cast to ``dtype`` (default float32)."""
    ctx = _ctx_of(ctx, *params)
    dev = ctx.torch_device
    ps = [_val(p, dev) for p in params]
    shape = _size(size, *ps)
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    return _finish(draw(dev, shape, *ps).to(dt), ctx, out)


def beta(a, b, size=None, dtype=None, ctx=None):
    def draw(dev, s, av, bv):
        x, y = _std_gamma(av, s, dev), _std_gamma(bv, s, dev)
        return x / (x + y)
    return _sampler((a, b), size, ctx, dtype, draw)


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    return _sampler((shape, scale), size, ctx, dtype,
                    lambda dev, s, k, sc: _std_gamma(k, s, dev) * sc, out)


def _exp1(dev, s):
    """Standard exponential draws: ``-log1p(-u)``."""
    return -torch.log1p(-_uniform01(s, dev))


def exponential(scale=1.0, size=None, dtype=None, ctx=None, out=None):
    return _sampler((scale,), size, ctx, dtype,
                    lambda dev, s, sc: _exp1(dev, s) * sc, out)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    def draw(dev, s, lo, sc):
        # u uniform in (-1, 1): -sign(u) log1p(-|u|)
        u = _uniform01(s, dev) * 2 - 1
        return lo + sc * (-torch.sign(u) * torch.log1p(-torch.abs(u)))
    return _sampler((loc, scale), size, ctx, dtype, draw, out)


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    def draw(dev, s, lo, sc):
        u = _uniform01(s, dev).clamp_min(torch.finfo(torch.float32).tiny)
        return lo + sc * (torch.log(u) - torch.log1p(-u))
    return _sampler((loc, scale), size, ctx, None, draw, out)


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    def draw(dev, s, lo, sc):
        u = _uniform01(s, dev).clamp_min(torch.finfo(torch.float32).tiny)
        return lo - sc * torch.log(-torch.log(u))
    return _sampler((loc, scale), size, ctx, None, draw, out)


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None):
    def draw(dev, s, m, sg):
        z = torch.randn(s, generator=generator(dev), device=dev)
        return torch.exp(m + sg * z)
    return _sampler((mean, sigma), size, ctx, None, draw)


def pareto(a, size=None, ctx=None):
    return _sampler((a,), size, ctx, None,
                    lambda dev, s, av: torch.expm1(_exp1(dev, s) / av))


def power(a, size=None, ctx=None):
    return _sampler((a,), size, ctx, None,
                    lambda dev, s, av: torch.pow(_uniform01(s, dev),
                                                 1.0 / av))


def rayleigh(scale=1.0, size=None, ctx=None):
    return _sampler((scale,), size, ctx, None,
                    lambda dev, s, sc: sc * torch.sqrt(2.0 * _exp1(dev, s)))


def weibull(a, size=None, ctx=None):
    return _sampler((a,), size, ctx, None,
                    lambda dev, s, av: torch.pow(_exp1(dev, s), 1.0 / av))


def chisquare(df, size=None, dtype=None, ctx=None):
    return _sampler((df,), size, ctx, dtype,
                    lambda dev, s, d: 2.0 * _std_gamma(d / 2.0, s, dev))


def f(dfnum, dfden, size=None, ctx=None):
    def draw(dev, s, n, d):
        num = 2.0 * _std_gamma(n / 2.0, s, dev) / n
        den = 2.0 * _std_gamma(d / 2.0, s, dev) / d
        return num / den
    return _sampler((dfnum, dfden), size, ctx, None, draw)


def binomial(n, p, size=None, ctx=None):
    def draw(dev, s, nv, pv):
        return torch.binomial(nv.expand(s).contiguous(),
                              pv.expand(s).contiguous(),
                              generator=generator(dev))
    return _sampler((n, p), size, ctx, None, draw)


def negative_binomial(n, p, size=None, ctx=None):
    def draw(dev, s, nv, pv):
        lam = _std_gamma(nv, s, dev) * (1 - pv) / pv
        return torch.poisson(lam, generator=generator(dev))
    return _sampler((n, p), size, ctx, None, draw)


def poisson(lam=1.0, size=None, ctx=None):
    return _sampler((lam,), size, ctx, None,
                    lambda dev, s, lv: torch.poisson(
                        lv.expand(s).contiguous(), generator=generator(dev)))


def geometric(p, size=None, ctx=None):
    def draw(dev, s, pv):
        # trials to the first success, from 1: ceil(log(u) / log1p(-p))
        u = _uniform01(s, dev).clamp_min(torch.finfo(torch.float32).tiny)
        return torch.ceil(torch.log(u) / torch.log1p(-pv)).clamp_min(1)
    return _sampler((p,), size, ctx, None, draw)


def multinomial(n, pvals, size=None):
    """Counts of ``n`` draws over ``len(pvals)`` categories, shape
    ``size + (k,)``, int32."""
    ctx = _ctx_of(None, pvals)
    dev = ctx.torch_device
    pv = _val(pvals, dev).reshape(-1)
    shape = () if size is None else _size(size)
    rows = int(onp.prod(shape))
    k = pv.shape[0]
    draws = torch.multinomial(pv.expand(rows, k), int(n), replacement=True,
                              generator=generator(dev))
    counts = torch.zeros(rows, k, dtype=torch.int32, device=dev).scatter_add(
        1, draws, torch.ones_like(draws, dtype=torch.int32))
    return _finish(counts.reshape(shape + (k,)), ctx)


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None):
    """``mean + z @ L.T`` with ``L`` the Cholesky factor of ``cov``, as
    jax.random.multivariate_normal's default method."""
    ctx = _ctx_of(None, mean, cov)
    dev = ctx.torch_device
    m, c = _val(mean, dev), _val(cov, dev)
    shape = () if size is None else _size(size)
    z = torch.randn(shape + m.shape, generator=generator(dev), device=dev)
    L = torch.linalg.cholesky(c.to(z.dtype))
    return _finish((m + z @ L.T).to(default_float()), ctx)


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None):
    src = prob if prob is not None else logit

    def draw(dev, s, pv):
        if prob is None:
            pv = torch.sigmoid(pv)
        return (_uniform01(s, dev) < pv).to(torch.float32)
    return _sampler((src,), size, ctx, dtype, draw)
