"""Test utilities (the port of ``mxnet_tpu/test_utils.py``): the
tolerance helpers and ``assert_almost_equal`` family, the
finite-difference ``check_numeric_gradient``, the random array, shape
and sparse-array factories, ``check_consistency`` (the CPU against the
card), the generator checks (``chi_square_check``,
``verify_generator``, ...), ``compare_optimizer`` and the small
helpers the reference's tests are written against.

The helpers that take ``ctx=None`` follow ``current_context()``, which
is the card unless the caller asks for the CPU. Those that need a
module the port does not have yet raise ``base.NotPortedError`` naming
its ROADMAP.md item: the symbolic checks (``check_symbolic_forward``,
``check_symbolic_backward``, ``same_symbol_structure``,
``numeric_grad``'s executor, ``check_speed`` of a symbol) need the
Symbol API (item 26), ``check_gluon_hybridize_consistency`` needs
``hybridize`` (item 15), and ``compare_optimizer`` takes the port's
optimizers (SGD, NAG, Adam, AdamW and Test); the others wait for item
16.
"""
from __future__ import annotations

import numpy as onp

from . import autograd
from . import numpy as mxnp
from .base import not_ported
from .context import Context, cpu, current_context, default_context  # noqa: F401
from .ndarray.ndarray import NDArray

_rng = onp.random.RandomState(1234)

default_dtype = onp.float32


def default_rtols():
    return {onp.dtype(onp.float16): 1e-2,
            onp.dtype(onp.float32): 1e-4,
            onp.dtype(onp.float64): 1e-6,
            onp.dtype(bool): 0,
            onp.dtype(onp.int32): 0,
            onp.dtype(onp.int64): 0}


def default_atols():
    return {onp.dtype(onp.float16): 1e-1,
            onp.dtype(onp.float32): 1e-3,
            onp.dtype(onp.float64): 1e-20,
            onp.dtype(bool): 0,
            onp.dtype(onp.int32): 0,
            onp.dtype(onp.int64): 0}


def _to_numpy(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return onp.asarray(a)


def find_max_violation(a, b, rtol, atol):
    diff = onp.abs(a - b)
    viol = diff - (atol + rtol * onp.abs(b))
    if not viol.size:
        return (), 0.0
    idx = onp.unravel_index(onp.argmax(viol), viol.shape)
    return idx, float(diff[idx])


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False, use_broadcast=True,
                        mismatches=(10, 10)):
    a_np, b_np = _to_numpy(a), _to_numpy(b)
    if rtol is None:
        rtol = default_rtols().get(onp.dtype(a_np.dtype), 1e-5)
    if atol is None:
        atol = default_atols().get(onp.dtype(a_np.dtype), 1e-8)
    try:
        onp.testing.assert_allclose(a_np, b_np, rtol=rtol, atol=atol,
                                    equal_nan=equal_nan)
    except AssertionError as exc:
        raise AssertionError(
            f"{names[0]} and {names[1]} differ beyond rtol={rtol} "
            f"atol={atol}:\n{exc}") from None


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


def same(a, b):
    return onp.array_equal(_to_numpy(a), _to_numpy(b))


def rand_ndarray(shape, dtype=onp.float32, ctx=None, low=-1.0, high=1.0):
    return mxnp.array(_rng.uniform(low, high, size=shape).astype(dtype),
                      ctx=ctx)


def random_arrays(*shapes):
    arrays = [_rng.standard_normal(size=s).astype(onp.float32)
              for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def rand_shape_2d(dim0=10, dim1=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1),
            _rng.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_rng.randint(1, dim + 1, size=num_dim))


def effective_dtype(x):
    return onp.dtype(x.dtype)


def check_numeric_gradient(f, inputs, grad_outputs=None, eps=1e-4,
                           rtol=1e-2, atol=1e-4, dtype=onp.float64):
    """Finite-difference check of the gradients of ``f(*inputs)`` (a
    function of NDArrays) against autograd's, by central differences."""
    inputs = [mxnp.array(_to_numpy(x), dtype=dtype) for x in inputs]
    for x in inputs:
        x.attach_grad()

    def weighted(o):
        if grad_outputs is None:
            return o.sum()
        return (o * mxnp.array(grad_outputs, dtype=dtype)).sum()

    with autograd.record():
        loss = weighted(f(*inputs))
    loss.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    def fval(arrs):
        return float(weighted(f(*[mxnp.array(a, dtype=dtype)
                                  for a in arrs])).item())

    raw = [x.asnumpy().astype(onp.float64) for x in inputs]
    for k, base in enumerate(raw):
        num = onp.zeros_like(base)
        flat, nflat = base.reshape(-1), num.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            fp = fval(raw)
            flat[i] = orig - eps
            fm = fval(raw)
            flat[i] = orig
            nflat[i] = (fp - fm) / (2 * eps)
        onp.testing.assert_allclose(analytic[k], num, rtol=rtol, atol=atol,
                                    err_msg=f"gradient mismatch for input "
                                            f"{k}")


def check_consistency(f, inputs, ctx_list=None, rtol=1e-3, atol=1e-4):
    """``f`` on each context (the CPU, then the card when there is one)
    and the outputs compared."""
    from .context import gpu, num_gpus
    if ctx_list is None:
        ctx_list = [cpu()] + ([gpu()] if num_gpus() > 0 else [])
    outs = []
    for ctx in ctx_list:
        ins = [x.as_in_context(ctx) for x in inputs]
        outs.append(_to_numpy(f(*ins)))
    for o in outs[1:]:
        onp.testing.assert_allclose(outs[0], o, rtol=rtol, atol=atol)
    return outs


def discard_stderr(func):
    return func


def set_default_device(ctx):
    Context._default_ctx.value = ctx


def environment(name, value):
    import os
    from contextlib import contextmanager

    @contextmanager
    def _scope():
        old = os.environ.get(name)
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        try:
            yield
        finally:
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old

    return _scope()


def check_symbolic_forward(sym, location, expected, *args, **kwargs):
    """Needs the Symbol API."""
    raise not_ported("test_utils.check_symbolic_forward (mx.sym)", 26)


def check_symbolic_backward(sym, location, out_grads, expected, *args,
                            **kwargs):
    """Needs the Symbol API."""
    raise not_ported("test_utils.check_symbolic_backward (mx.sym)", 26)


def list_gpus():
    """The CUDA devices' indices."""
    from .context import num_gpus
    return list(range(num_gpus()))


def download(url, fname=None, dirname=None, overwrite=False, retries=5):
    """Serve a ``file://`` URL or an existing local path (copied to
    ``fname`` in ``dirname``); anything else raises, as there is no
    network here (the reference downloads over HTTP)."""
    import os
    import shutil
    from urllib.parse import urlparse
    src = urlparse(url).path if url.startswith("file://") else url
    if not os.path.exists(src):
        raise IOError(
            f"download({url!r}): no network egress in this environment; "
            "place the file locally and pass its path")
    fname = fname or os.path.basename(src)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
        fname = os.path.join(dirname, fname)
    if os.path.abspath(src) != os.path.abspath(fname) and \
            (overwrite or not os.path.exists(fname)):
        shutil.copyfile(src, fname)
    return fname


assert_allclose = onp.testing.assert_allclose


def default_numeric_eps(dtype=onp.float32):
    return {onp.float16: 1e-2, onp.float32: 1e-4,
            onp.float64: 1e-6}.get(onp.dtype(dtype).type, 1e-4)


_DEFAULT_RTOL = {onp.float16: 1e-2, onp.float32: 1e-4, onp.float64: 1e-6}
_DEFAULT_ATOL = {onp.float16: 1e-3, onp.float32: 1e-5, onp.float64: 1e-7}


def get_rtol(x=None, y=None, rtol=None):
    if rtol is not None:
        return rtol
    if x is None and y is None:
        return 1e-4
    dt = effective_dtype(x if x is not None else y)
    return _DEFAULT_RTOL.get(onp.dtype(dt).type, 1e-4)


def get_atol(x=None, y=None, atol=None):
    if atol is not None:
        return atol
    if x is None and y is None:
        return 1e-5
    dt = effective_dtype(x if x is not None else y)
    return _DEFAULT_ATOL.get(onp.dtype(dt).type, 1e-5)


def get_etol(etol=None):
    return 0.0 if etol is None else etol


def get_tolerance(x, rtol, atol):
    return get_rtol(x, None, rtol), get_atol(x, None, atol)


def get_tols(x, y, rtol=None, atol=None):
    """The coarsest tolerances the operands' dtypes imply."""
    return (max(get_rtol(x, None, rtol), get_rtol(y, None, rtol)),
            max(get_atol(x, None, atol), get_atol(y, None, atol)))


def assert_almost_equal_ignore_nan(a, b, rtol=None, atol=None,
                                   names=("a", "b")):
    """Elementwise compare, skipping positions that are NaN in both."""
    a_np, b_np = _to_numpy(a).copy(), _to_numpy(b).copy()
    nan_mask = onp.logical_and(onp.isnan(a_np), onp.isnan(b_np))
    a_np[nan_mask] = 0
    b_np[nan_mask] = 0
    assert_almost_equal(a_np, b_np, rtol=rtol, atol=atol, names=names)


def assert_almost_equal_with_err(a, b, rtol=None, atol=None, etol=None,
                                 names=("a", "b")):
    """``assert_almost_equal`` tolerating a fraction ``etol`` of
    mismatched elements."""
    etol = get_etol(etol)
    a_np, b_np = _to_numpy(a), _to_numpy(b)
    rt, at = get_tols(a_np, b_np, rtol, atol)
    bad = onp.abs(a_np - b_np) > at + rt * onp.abs(b_np)
    if bad.sum() / max(bad.size, 1) > etol:
        assert_almost_equal(a_np, b_np, rtol=rt, atol=at, names=names)


def assert_exception(f, exception_type, *args, **kwargs):
    """``f(*args)`` must raise ``exception_type``."""
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("Did not raise %s" % exception_type.__name__)


def same_array(array1, array2):
    """True when two NDArrays share storage: writing one shows through
    the other."""
    if array1 is array2:
        return True
    a, b = getattr(array1, "_data", None), getattr(array2, "_data", None)
    if a is None or b is None:
        return False
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """A numpy reduction with MXNet's axis/keepdims semantics."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def assign_each(input_, function):
    return onp.vectorize(function)(_to_numpy(input_))


def assign_each2(input1, input2, function):
    return onp.vectorize(function)(_to_numpy(input1), _to_numpy(input2))


def collapse_sum_like(a, shape):
    """Sum ``a`` down to ``shape`` (the gradient of a broadcast)."""
    a = _to_numpy(a)
    extra = a.ndim - len(shape)
    if extra:
        a = a.sum(axis=tuple(range(extra)))
    axes = tuple(i for i, (da, ds) in enumerate(zip(a.shape, shape))
                 if ds == 1 and da != 1)
    if axes:
        a = a.sum(axis=axes, keepdims=True)
    return a.reshape(shape)


def create_vector(size, dtype=onp.int64):
    """0 .. size-1 (a large-tensor test helper)."""
    return mxnp.arange(size, dtype=dtype)


def create_2d_tensor(rows, columns, dtype=onp.int64):
    return mxnp.arange(rows * columns, dtype=dtype).reshape(rows, columns)


create_2d_np_tensor = create_2d_tensor


def rand_coord_2d(x_low, x_high, y_low, y_high):
    return onp.random.randint(x_low, x_high), \
        onp.random.randint(y_low, y_high)


def random_sample(population, k):
    """k of ``population`` without replacement."""
    population_copy = list(population)
    onp.random.shuffle(population_copy)
    return population_copy[0:k]


def random_uniform_arrays(*shapes, **kwargs):
    low = kwargs.pop("low", 0.0)
    high = kwargs.pop("high", 1.0)
    dtype = kwargs.pop("dtype", onp.float32)
    return [onp.random.uniform(low, high, size=s).astype(dtype)
            for s in shapes]


def rand_sparse_ndarray(shape, stype, density=None, dtype=None,
                        distribution="uniform"):
    """A random sparse NDArray and its dense numpy mirror (uniform
    values)."""
    from .ndarray import sparse as sp
    density = onp.random.rand() if density is None else density
    dtype = dtype or onp.float32
    dense = onp.random.uniform(-1, 1, size=shape).astype(dtype)
    if stype == "row_sparse":
        keep = onp.random.uniform(size=shape[0]) < density
        dense[~keep] = 0
        arr = sp.row_sparse_array(mxnp.array(dense))
    elif stype == "csr":
        mask = onp.random.uniform(size=shape) < density
        dense = dense * mask
        arr = sp.csr_matrix(mxnp.array(dense))
    else:
        raise ValueError(f"unknown stype {stype}")
    return arr, dense


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=None, modifier_func=None, density=0.5,
                        shuffle_csr_indices=False):
    arr, _ = rand_sparse_ndarray(shape, stype, density=density, dtype=dtype)
    return arr


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=None, modifier_func=None,
                           shuffle_csr_indices=False):
    return create_sparse_array(shape, stype, density=density, dtype=dtype)


def shuffle_csr_column_indices(csr):
    """The CSR arrays keep their indices sorted by construction (their
    row search needs it): returned as they are."""
    return csr


def compare_ndarray_tuple(t1, t2, rtol=None, atol=None):
    if t1 is None or t2 is None:
        return
    if isinstance(t1, tuple):
        for s1, s2 in zip(t1, t2):
            compare_ndarray_tuple(s1, s2, rtol, atol)
    else:
        assert_almost_equal(t1, t2, rtol=rtol, atol=atol)


def _flat_states(state):
    """The tensors of an optimizer state (nested tuples) in order."""
    import torch
    if torch.is_tensor(state):
        return (state.detach().cpu().numpy(),)
    out = ()
    for s in state or ():
        out += _flat_states(s)
    return out


def compare_optimizer(opt1, opt2, shapes, dtype, w_stype="default",
                      g_stype="default", rtol=1e-4, atol=1e-5,
                      compare_states=True):
    """One update by each optimizer from the same weights and gradients;
    the new weights (and states) must agree."""
    from . import optimizer as _opt
    for o in (opt1, opt2):
        if not isinstance(o, _opt.Optimizer):
            raise not_ported(f"test_utils.compare_optimizer of "
                             f"{type(o).__name__}", 16)
    if not isinstance(shapes, list):
        shapes = [shapes]
    w1, w2, g1, g2 = [], [], [], []
    for s in shapes:
        w = onp.random.uniform(-1, 1, size=s).astype(dtype)
        g = onp.random.uniform(-1, 1, size=s).astype(dtype)
        w1.append(mxnp.array(w))
        w2.append(mxnp.array(w.copy()))
        g1.append(mxnp.array(g))
        g2.append(mxnp.array(g.copy()))
    states = []
    for opt, ws, gs in ((opt1, w1, g1), (opt2, w2, g2)):
        st = {}
        for i, (w, g) in enumerate(zip(ws, gs)):
            st[i] = opt.create_state_multi_precision(i, w._data)
            opt.update_multi_precision([i], [w._data], [g._data], [st[i]])
        states.append(st)
    for a, b in zip(w1, w2):
        assert_almost_equal(a, b, rtol=rtol, atol=atol)
    if compare_states:
        for i in range(len(shapes)):
            compare_ndarray_tuple(_flat_states(states[0][i]) or None,
                                  _flat_states(states[1][i]) or None, rtol,
                                  atol)


def compare_optimizer_noise_seeded(opt1, opt2, shapes, dtype, seed,
                                   **kwargs):
    onp.random.seed(seed)
    mxnp.random.seed(seed)
    compare_optimizer(opt1, opt2, shapes, dtype, **kwargs)


def check_gluon_hybridize_consistency(net_builder, data_l, numpy_func=None,
                                      test_grad=True, rtol=1e-4, atol=1e-4):
    """Needs ``hybridize``."""
    raise not_ported("test_utils.check_gluon_hybridize_consistency "
                     "(hybridize)", 15)


def same_symbol_structure(sym1, sym2):
    """Needs the Symbol API."""
    raise not_ported("test_utils.same_symbol_structure (mx.sym)", 26)


class DummyIter:
    """An endless iterator repeating one batch of another iterator (for
    timing without I/O)."""

    def __init__(self, real_iter):
        self.real_iter = real_iter
        self.provide_data = real_iter.provide_data
        self.provide_label = real_iter.provide_label
        self.batch_size = real_iter.batch_size
        self.the_batch = next(real_iter)

    def __iter__(self):
        return self

    def next(self):
        return self.the_batch

    __next__ = next


def check_speed(sym=None, location=None, func=None, N=20, **kwargs):
    """Seconds per call of ``func`` (after one warm-up call); a bound
    symbol needs the Symbol API."""
    import time as _time
    if func is None:
        raise not_ported("test_utils.check_speed of a symbol (mx.sym)", 26)
    func()
    tic = _time.time()
    for _ in range(N):
        func()
    from . import engine
    engine.waitall()
    return (_time.time() - tic) / N


def set_default_context(ctx):
    set_default_device(ctx)


def locationError(a, b, index, names):
    return (f"Location of maximum error: {index}, "
            f"{names[0]}={a[index]:.8f}, {names[1]}={b[index]:.8f}")


def gen_buckets_probs_with_ppf(ppf, nbuckets):
    """Equal-probability buckets from a percent-point function."""
    probs = [1.0 / nbuckets] * nbuckets
    buckets = [(ppf(i / nbuckets), ppf((i + 1) / nbuckets))
               for i in range(nbuckets)]
    return buckets, probs


def chi_square_check(generator, buckets, probs, nsamples=1000000):
    """Pearson's chi-square fit of ``generator``'s samples to the bucket
    probabilities; buckets are (lo, hi) ranges or exact values. Samples
    outside every bucket count against the fit."""
    from scipy import stats as sps_stats
    samples = onp.asarray(_to_numpy(generator(nsamples))).ravel()
    counts = onp.zeros(len(buckets))
    if isinstance(buckets[0], (tuple, list)):
        for i, (lo, hi) in enumerate(buckets):
            counts[i] = ((samples >= lo) & (samples < hi)).sum()
    else:
        for i, v in enumerate(buckets):
            counts[i] = (samples == v).sum()
    probs = onp.asarray(probs, dtype=onp.float64)
    expected = probs / probs.sum() * counts.sum()
    if counts.sum() == 0:
        return onp.inf, 0.0, counts
    chi2, pvalue = sps_stats.chisquare(counts, expected)
    return chi2, pvalue, counts


def mean_check(generator, mu, sigma, nsamples=1000000):
    samples = onp.asarray(_to_numpy(generator(nsamples))).ravel()
    return abs(samples.mean() - mu) < 5 * sigma / onp.sqrt(len(samples))


def var_check(generator, sigma, nsamples=1000000):
    samples = onp.asarray(_to_numpy(generator(nsamples))).ravel()
    return abs(samples.var() - sigma ** 2) < 0.2 * sigma ** 2


def verify_generator(generator, buckets, probs, nsamples=1000000,
                     nrepeat=5, success_rate=0.2, alpha=0.05):
    """The chi-square fit repeated; its p-value must pass ``alpha`` in at
    least ``success_rate`` of the repeats. Returns the passes."""
    pvalues = [chi_square_check(generator, buckets, probs,
                                nsamples=nsamples)[1]
               for _ in range(nrepeat)]
    success_num = (onp.asarray(pvalues) > alpha).sum()
    if success_num < nrepeat * success_rate:
        raise AssertionError(
            f"Generator test fails, Chi-square p={pvalues}, "
            f"successes {success_num}/{nrepeat}")
    return success_num


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True, dtype=onp.float32):
    """Needs an executor of the Symbol API."""
    raise not_ported("test_utils.numeric_grad (mx.sym executors)", 26)
