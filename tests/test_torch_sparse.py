"""The port's sparse arrays (``mx.nd.sparse``: ``RowSparseNDArray``,
``CSRNDArray`` and their ops) against the JAX package's, on the CPU:
the cases of ``tests/test_sparse.py`` and
``tests/test_sparse_operator_conformance.py`` run through both packages
on the same seeded data, crossed over the dtypes the reference accepts
(float32, int32 and uint16, which the card moves on its signed type; a
case the reference refuses for a dtype must raise in the port too).

Tolerances: stored values, indices and integer results exactly; float
products within 1e-5 (``RED``), a float16 one within one float16 step.
``nd.save``/``nd.load`` of sparse arrays are ``test_torch_save_load.py``'s."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as tsp

from test_torch_np_common import RED, same
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

#: the dtypes of the sparse crosses
SP_DTYPES = ("float32", "int32", "uint16")
SPARSE = {tmx: tsp, jmx: jsp}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _dense(shape, density, seed, dtype="float32", rows=False):
    rs = onp.random.RandomState(seed)
    d = rs.uniform(-3, 3, shape)
    if onp.dtype(dtype).kind in "iu":
        d = rs.randint(0 if dtype.startswith("u") else -4, 5, shape)
    if rows:
        d[rs.uniform(size=shape[0]) >= density] = 0
    else:
        d[rs.uniform(size=shape) >= density] = 0
    return d.astype(dtype)


def both(fn):
    """``fn(pkg, sparse_module)`` in both packages: the port's result
    against the reference's (the same dtypes, shapes and values; a
    sparse result's stored values and indices too). If the reference
    raises, the port must raise."""
    try:
        j = fn(jmx, jsp)
    except Exception:                    # noqa: BLE001 (compared below)
        with pytest.raises(Exception):
            fn(tmx, tsp)
        return None
    t = fn(tmx, tsp)
    _same(t, j)
    return t, j


def _same(t, j):
    if isinstance(j, (list, tuple)):
        for a, b in zip(t, j):
            _same(a, b)
        return
    stype = getattr(j, "stype", "default")
    assert getattr(t, "stype", "default") == stype
    if stype != "default":
        same(t.data, j.data, RED)
        same(t.indices, j.indices)
        if stype == "csr":
            same(t.indptr, j.indptr)
    assert t.shape == j.shape
    same(t.todense() if stype != "default" else t,
         j.todense() if stype != "default" else j, RED)


def _arr(pkg, d):
    return pkg.np.array(d, dtype=d.dtype)


@pytest.mark.parametrize("dtype", SP_DTYPES)
def test_roundtrips(dtype):
    """test_csr_roundtrip, test_row_sparse_roundtrip,
    test_tostype_round_trips."""
    d = _dense((6, 5), 0.3, 0, dtype)
    both(lambda p, sp: _arr(p, d).tostype("csr"))
    r = _dense((8, 4), 0.6, 1, dtype, rows=True)
    both(lambda p, sp: _arr(p, r).tostype("row_sparse"))
    both(lambda p, sp: _arr(p, r).tostype("row_sparse").tostype("csr"))


def test_construct_from_triplets_and_pairs():
    """test_csr_construct_from_triplet; (data, indices) pairs stored
    sorted by row."""
    both(lambda p, sp: sp.csr_matrix(([1.0, 2.0, 3.0], [1, 0, 2],
                                      [0, 1, 3, 3]), shape=(3, 4)))
    rows = onp.array([5, 1, 3], "i8")
    vals = onp.arange(6, dtype="f4").reshape(3, 2)
    both(lambda p, sp: sp.row_sparse_array((vals, rows), shape=(8, 2)))
    with pytest.raises(ValueError, match="shape"):
        tsp.row_sparse_array((vals, rows))


@pytest.mark.parametrize("dtype", SP_DTYPES)
def test_dot(dtype):
    """test_csr_dot, test_csr_dot_transpose, test_rsp_dot,
    test_dot_csr_dense, test_dot_dense_rsp, test_dot_csr_vector."""
    d = _dense((7, 5), 0.4, 2, dtype)
    rhs = _dense((5, 3), 1.0, 3, dtype)
    rhs_t = _dense((7, 3), 1.0, 4, dtype)
    both(lambda p, sp: sp.dot(_arr(p, d).tostype("csr"), _arr(p, rhs)))
    both(lambda p, sp: p.nd.dot(_arr(p, d).tostype("csr"), _arr(p, rhs_t),
                                transpose_a=True))
    both(lambda p, sp: p.nd.dot(_arr(p, d).tostype("csr"),
                                _arr(p, rhs.T.copy()), transpose_b=True))
    r = _dense((6, 4), 0.5, 5, dtype, rows=True)
    both(lambda p, sp: sp.dot(_arr(p, r).tostype("row_sparse"),
                              _arr(p, rhs[:4])))
    both(lambda p, sp: sp.dot(_arr(p, r).tostype("row_sparse"),
                              _arr(p, _dense((6, 2), 1.0, 6, dtype)),
                              transpose_a=True))
    x = _dense((3, 6), 1.0, 7, dtype)
    both(lambda p, sp: p.nd.dot(_arr(p, x), _arr(p, r).tostype("row_sparse")))
    v = _dense((5,), 1.0, 8, dtype)
    both(lambda p, sp: p.nd.dot(_arr(p, d).tostype("csr"), _arr(p, v)))
    both(lambda p, sp: p.nd.dot(_arr(p, d).tostype("csr"),
                                _arr(p, _dense((7,), 1.0, 9, dtype)),
                                transpose_a=True))


def test_dot_gradients():
    """The products are differentiable in the dense operand; a sparse
    array made from values on the tape takes them off it (a leaf, as in
    the reference: their gradient stays 0)."""
    d = _dense((7, 5), 0.4, 10)
    rhs = _dense((5, 3), 1.0, 11)
    w = onp.random.RandomState(12).uniform(-1, 1, (7, 3)).astype("f4")
    out = []
    for pkg in (tmx, jmx):
        csr = _arr(pkg, d).tostype("csr")
        vals, r = csr.data, _arr(pkg, rhs)
        vals.attach_grad()
        r.attach_grad()
        with pkg.autograd.record():
            y = SPARSE[pkg].dot(SPARSE[pkg].csr_matrix(
                (vals, csr.indices, csr.indptr), shape=(7, 5)), r)
            s = (y * pkg.np.array(w)).sum()
        s.backward()
        out.append((y, vals.grad, r.grad))
    same(out[0], out[1], RED)


@pytest.mark.parametrize("dtype", SP_DTYPES)
def test_add_retain_scalar_ops(dtype):
    """test_rsp_add, test_rsp_elemwise_add_rsp, test_csr_dense_add,
    test_scalar_ops_keep_sparsity, test_csr_scalar_mul_keeps_stype,
    test_retain, test_rsp_retain_is_row_filter."""
    a = _dense((6, 3), 0.5, 13, dtype, rows=True)
    b = _dense((6, 3), 0.5, 14, dtype, rows=True)
    both(lambda p, sp: _arr(p, a).tostype("row_sparse")
         + _arr(p, b).tostype("row_sparse"))
    both(lambda p, sp: _arr(p, a).tostype("csr") + _arr(p, b))
    both(lambda p, sp: _arr(p, a).tostype("csr") + _arr(p, b).tostype("csr"))
    both(lambda p, sp: _arr(p, a).tostype("csr") * 2.5)
    both(lambda p, sp: -_arr(p, a).tostype("row_sparse"))
    ids = onp.array([1, 4, 5], "i4")
    both(lambda p, sp: _arr(p, a).tostype("row_sparse").retain(
        p.np.array(ids)))


@pytest.mark.parametrize("dtype", SP_DTYPES)
def test_reductions_norm_and_slices(dtype):
    """test_csr_sum, test_csr_mean, test_csr_row_slice(_matches_dense),
    the embedding-style row gather, and norm."""
    a = _dense((5, 9), 0.3, 15, dtype)
    for axis in (None, 1):
        both(lambda p, sp: _arr(p, a).tostype("csr").sum(axis=axis))
    both(lambda p, sp: _arr(p, a).tostype("csr").mean())
    both(lambda p, sp: _arr(p, a).tostype("csr")[2])
    w = _dense((12, 5), 0.8, 16, dtype, rows=True)
    idx = onp.array([3, 3, 0, 7], "i4")
    both(lambda p, sp: p.np.take(_arr(p, w).tostype("row_sparse").todense(),
                                 p.np.array(idx), axis=0))
    both(lambda p, sp: sp.norm(_arr(p, a).tostype("csr")))


def test_zeros_empty_and_errors():
    """test_sparse_zeros, test_sparse_zeros_and_empty_shapes,
    test_cast_storage_errors."""
    for st in ("csr", "row_sparse"):
        both(lambda p, sp: sp.zeros(st, (4, 6)))
        both(lambda p, sp: sp.empty(st, (3, 4), dtype="int32"))
    both(lambda p, sp: sp.zeros("default", (2, 3)))
    with pytest.raises(ValueError):
        tmx.np.array(onp.zeros((2, 2, 2), "f4")).tostype("csr")
    with pytest.raises(ValueError):
        tsp.zeros("bogus", (2, 2))
    with pytest.raises(TypeError):
        tsp.retain(tsp.zeros("csr", (2, 2)), [0])


def test_index_dtype_policy():
    """test_index_dtype_policy: int32 indices by design, an OverflowError
    past the int32 range; under set_np(dtype=True) int64, as the
    reference's x64."""
    assert tsp.index_dtype() == jsp.index_dtype() == onp.int32
    rsp = tsp.row_sparse_array((onp.ones((2, 3), "f4"),
                                onp.array([1, 4], "i8")), shape=(8, 3))
    assert rsp.indices.dtype == onp.int32
    with pytest.raises(OverflowError):
        tsp.row_sparse_array((onp.ones((1, 3), "f4"),
                              onp.array([2 ** 40], "i8")), shape=(8, 3))
    tmx.npx.set_np(dtype=True)
    try:
        assert tsp.index_dtype() == onp.int64
        assert tsp.zeros("csr", (2, 2)).indptr.dtype == onp.int64
    finally:
        tmx.npx.reset_np()


def test_grad_through_dense_bridge():
    """test_sparse_grad_through_dense_bridge."""
    a = _dense((4, 3), 0.5, 17)
    out = []
    for pkg in (tmx, jmx):
        w = pkg.np.ones((4, 3))
        w.attach_grad()
        with pkg.autograd.record():
            loss = (_arr(pkg, a).tostype("csr").todense() * w).sum()
        loss.backward()
        out.append(w.grad)
    same(out[0], out[1], RED)


def test_scipy_array():
    sps = pytest.importorskip("scipy.sparse")
    m = sps.random(5, 6, density=0.3, format="csr", random_state=18,
                   dtype="f4")
    both(lambda p, sp: sp.array(m))
    with pytest.raises(ValueError):
        tsp.array(onp.ones((2, 2)))
