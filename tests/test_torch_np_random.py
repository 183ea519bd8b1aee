"""The port's mx.np.random against the JAX package's, on the CPU. Torch's
generators and JAX's Threefry give different numbers for one seed, so
each sampler is held to the reference by the dtype and shape of a draw,
and to its distribution by support, moments (6 standard errors on the
mean, a 10 % band on the variance, as ``tests/test_random_conformance``
holds the reference) and a scipy Kolmogorov-Smirnov test at fixed seeds
(p > 1e-3); the combinatoric samplers by their invariants; and the
port's own draws repeat after ``seed``."""
import numpy as onp
import pytest
from scipy import stats

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 40_000
_G = 0.5772156649015329


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        tmx.np.random.seed(7)
        yield


#: name -> (args, mean, var, scipy distribution for KS or None, support)
CASES = {
    "normal": ((1.5, 2.0), 1.5, 4.0, stats.norm(1.5, 2.0), None),
    "uniform": ((-1.0, 3.0), 1.0, 16 / 12, stats.uniform(-1.0, 4.0),
                lambda s: ((s >= -1) & (s < 3)).all()),
    "exponential": ((2.0,), 2.0, 4.0, stats.expon(scale=2.0),
                    lambda s: (s >= 0).all()),
    "gamma": ((3.0, 2.0), 6.0, 12.0, stats.gamma(3.0, scale=2.0),
              lambda s: (s > 0).all()),
    "beta": ((2.0, 5.0), 2 / 7, 10 / (49 * 8), stats.beta(2.0, 5.0),
             lambda s: ((s > 0) & (s < 1)).all()),
    "chisquare": ((4.0,), 4.0, 8.0, stats.chi2(4.0), lambda s: (s > 0).all()),
    "gumbel": ((0.5, 2.0), 0.5 + 2.0 * _G, onp.pi ** 2 / 6 * 4.0,
               stats.gumbel_r(0.5, 2.0), None),
    "laplace": ((1.0, 2.0), 1.0, 8.0, stats.laplace(1.0, 2.0), None),
    "logistic": ((1.0, 2.0), 1.0, onp.pi ** 2 / 3 * 4.0,
                 stats.logistic(1.0, 2.0), None),
    "lognormal": ((0.2, 0.5), onp.exp(0.2 + 0.125),
                  (onp.exp(0.25) - 1) * onp.exp(0.4 + 0.25),
                  stats.lognorm(0.5, scale=onp.exp(0.2)), None),
    "pareto": ((5.0,), 1 / 4, 5 / (16 * 3), stats.lomax(5.0),
               lambda s: (s >= 0).all()),
    "power": ((3.0,), 0.75, 3 / 80, stats.powerlaw(3.0),
              lambda s: ((s >= 0) & (s <= 1)).all()),
    "rayleigh": ((2.0,), 2.0 * onp.sqrt(onp.pi / 2),
                 (4 - onp.pi) / 2 * 4.0, stats.rayleigh(scale=2.0),
                 lambda s: (s >= 0).all()),
    "weibull": ((2.0,), onp.sqrt(onp.pi) / 2, 1 - onp.pi / 4,
                stats.weibull_min(2.0), lambda s: (s >= 0).all()),
    "f": ((5.0, 10.0), 10 / 8, 2 * 100 * 13 / (5 * 64 * 6),
          stats.f(5.0, 10.0), lambda s: (s > 0).all()),
    "binomial": ((10, 0.3), 3.0, 2.1, None,
                 lambda s: ((s >= 0) & (s <= 10) & (s == onp.round(s))).all()),
    "negative_binomial": ((5, 0.4), 7.5, 18.75, None,
                          lambda s: ((s >= 0) & (s == onp.round(s))).all()),
    "poisson": ((3.5,), 3.5, 3.5, None,
                lambda s: ((s >= 0) & (s == onp.round(s))).all()),
    "geometric": ((0.25,), 4.0, 12.0, None,
                  lambda s: ((s >= 1) & (s == onp.round(s))).all()),
    "bernoulli": ((0.25,), 0.25, 0.1875, None,
                  lambda s: onp.isin(s, [0.0, 1.0]).all()),
}


#: samplers drawn in the JAX package too, among them those whose JAX draw
#: is an integer or bool the reference casts; every other one's reference
#: casts its draw to float32 as well (``_make(..., _default_float_fn())``),
#: which the port's must equal (the gamma-based ones' JAX draws compile
#: for seconds)
REF_DRAWN = {"normal", "uniform", "poisson", "geometric", "bernoulli"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_distribution(name):
    args, mean, var, dist, support = CASES[name]
    got = getattr(tmx.np.random, name)(*args, size=(2, 3))
    want = ((onp.dtype("float32"), (2, 3)) if name not in REF_DRAWN else
            (lambda r: (r.dtype, r.shape))(
                getattr(jmx.np.random, name)(*args, size=(2, 3))))
    assert (got.dtype, got.shape) == want, (got.dtype, got.shape, want)
    s = getattr(tmx.np.random, name)(*args, size=(N,)).asnumpy() \
        .astype("f8")
    assert onp.isfinite(s).all()
    if support is not None:
        assert support(s), name
    se = onp.sqrt(var / N)
    assert abs(s.mean() - mean) < 6 * se, (name, s.mean(), mean)
    assert abs(s.var() - var) < 0.1 * var, (name, s.var(), var)
    if dist is not None:
        assert stats.kstest(s, dist.cdf).pvalue > 1e-3, name


def test_array_parameters_and_shapes():
    lo = onp.array([0.0, 10.0, 100.0], "f4")
    for pkg in (tmx, jmx):
        u = pkg.np.random.uniform(pkg.np.array(lo), pkg.np.array(lo + 1))
        assert u.shape == (3,) and u.dtype == onp.float32
        v = u.asnumpy()
        assert ((v >= lo) & (v < lo + 1)).all()
    g = tmx.np.random.gamma(tmx.np.array(onp.array([1.0, 50.0], "f4")),
                            size=(N, 2)).asnumpy()
    assert abs(g[:, 1].mean() - 50.0) < 6 * onp.sqrt(50.0 / N)


@pytest.mark.parametrize("call", [
    ("rand", (2, 3), {}), ("choice", (7,), {"size": (4,)}),
    ("choice", (onp.arange(6, dtype="f4"),), {"size": (2, 2),
                                              "p": [0.1, 0.2, 0.3, 0.2,
                                                    0.1, 0.1]}),
    ("permutation", (6,), {}),
    ("multinomial", (20, [0.2, 0.3, 0.5]), {"size": (4,)}),
    ("multivariate_normal", ([0.0, 1.0], [[1.0, 0.3], [0.3, 2.0]]),
     {"size": (5,)}),
], ids=lambda v: repr(v))
def test_dtype_and_shape(call):
    name, args, kw = call
    out = []
    for pkg in (tmx, jmx):
        a = [pkg.np.array(x) if isinstance(x, onp.ndarray) else x
             for x in args]
        out.append(getattr(pkg.np.random, name)(*a, **kw))
    assert out[0].dtype == out[1].dtype and out[0].shape == out[1].shape, \
        (name, out[0].dtype, out[1].dtype, out[0].shape, out[1].shape)


def test_combinatorics():
    r = tmx.np.random
    assert sorted(r.permutation(50).asnumpy().tolist()) == list(range(50))
    x = tmx.np.array(onp.arange(40, dtype="f4").reshape(20, 2))
    r.shuffle(x)
    v = x.asnumpy()
    assert sorted(v[:, 0].tolist()) == list(range(0, 40, 2))
    onp.testing.assert_array_equal(v[:, 1], v[:, 0] + 1)
    assert len(set(r.choice(30, size=(30,), replace=False).asnumpy()
                   .tolist())) == 30
    p = onp.array([0.1, 0.0, 0.6, 0.3])
    c = r.choice(4, size=(N,), p=p).asnumpy()
    assert (c != 1).all()
    onp.testing.assert_allclose(onp.bincount(c, minlength=4) / N, p,
                                atol=0.015)
    m = r.multinomial(30, [0.2, 0.3, 0.5], size=(N // 10,)).asnumpy()
    assert (m.sum(-1) == 30).all()
    onp.testing.assert_allclose(m.mean(0), [6.0, 9.0, 15.0], rtol=0.03)
    mv = r.multivariate_normal([0.0, 1.0], [[1.0, 0.6], [0.6, 2.0]],
                               size=(N,)).asnumpy()
    onp.testing.assert_allclose(onp.cov(mv.T), [[1.0, 0.6], [0.6, 2.0]],
                                atol=0.06)
    b = r.bernoulli(logit=0.0, size=(N,)).asnumpy()
    assert abs(b.mean() - 0.5) < 0.02


def test_seed_repeats():
    r = tmx.np.random
    draws = []
    for _ in range(2):
        r.seed(123)
        draws.append([r.gamma(2.0, size=(5,)), r.choice(9, size=(4,)),
                      r.permutation(7), r.binomial(8, 0.4, size=(3,)),
                      r.rand(3), r.multinomial(5, [0.5, 0.5])])
    for a, b in zip(*draws):
        onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    r.seed(124)
    assert not onp.array_equal(r.rand(8).asnumpy(),
                               draws[0][4].asnumpy().repeat(3)[:8])
