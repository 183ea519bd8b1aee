"""Sparse NDArrays: row_sparse and CSR (the port of
``mxnet_tpu/ndarray/sparse.py``).

The reference's layout is kept: a sparse array is device tensors of
(values, indices[, indptr]), not a ``torch.sparse`` layout. Its kernels
are a gather and a sum by segment (``index_add``) or a scatter, as in
the reference; on the card a float ``index_add`` sums with atomics, in
no fixed order, while an integer one sums exactly (uint16/uint32 in
int64). Storage casts go through the host, as the reference's do. An
op with no sparse form computes on the dense array (the reference's
storage fallback).

Index arrays are int32 unless ``set_np(dtype=True)`` keeps 64-bit
arrays (the reference's x64 switch), with the bounds check of
``base.narrow_dtype`` on host values.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .. import engine
from ..base import (WIDE_UNSIGNED, float_input, narrow_dtype, resolve_dtype,
                    to_numpy_dtype)
from ..context import current_context
from .ndarray import _SIGNED_VIEW, NDArray

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "index_dtype", "row_sparse_array", "csr_matrix", "zeros",
           "empty", "cast_storage", "dot", "add", "elemwise_add", "retain",
           "norm", "array"]


def index_dtype():
    """The dtype of sparse index and indptr arrays: int32, int64 under
    ``set_np(dtype=True)``."""
    return onp.dtype(to_numpy_dtype(narrow_dtype(None, torch.int64)))


def _as_index_array(vals, device):
    """Index values (host values, a tensor or an NDArray) as a tensor of
    the index dtype on ``device``; host values are bounds-checked, a
    device tensor is cast (it is already within the policy)."""
    raw = getattr(vals, "_data", vals)
    if isinstance(raw, torch.Tensor):
        return raw.to(device=device, dtype=narrow_dtype(None, torch.int64))
    host = onp.asarray(raw)
    dt = narrow_dtype(host, torch.int64)
    return torch.as_tensor(host.astype(to_numpy_dtype(dt)),
                           device=device)


def _values(data, dtype, ctx):
    """Values (host data, a tensor or an NDArray) as a tensor on ``ctx``'s
    device, in ``dtype`` if given, as ``mx.np.array`` makes them. A
    sparse array is a leaf of the computation, as in the reference: its
    values are taken off the tape."""
    if isinstance(data, NDArray):
        data = data._data
    if isinstance(data, torch.Tensor):
        t = data.detach().to(ctx.torch_device)
        return t if dtype is None else t.to(resolve_dtype(dtype))
    from .. import numpy as _np
    return _np.array(data, dtype=dtype, ctx=ctx)._data


def _put(dense, index, values, accumulate=False):
    """``dense.index_put(index, values)`` (summing repeats with
    ``accumulate``), uint16/uint32 data moved on its signed type, or
    summed in int64 (the card refuses both)."""
    sv = _SIGNED_VIEW.get(dense.dtype)
    if sv is None:
        return dense.index_put(index, values, accumulate=accumulate)
    if accumulate:
        return dense.to(torch.int64).index_put(
            index, values.to(torch.int64), accumulate=True).to(dense.dtype)
    return dense.view(sv).index_put(index, values.view(sv)) \
        .view(dense.dtype)


def _rows(t, idx):
    """``t[idx]`` along the first axis, uint16/uint32 on its signed
    type."""
    sv = _SIGNED_VIEW.get(t.dtype)
    if sv is None:
        return t[idx]
    return t.view(sv)[idx].view(t.dtype)


def _segment_sum(values, segments, n):
    """Rows of ``values`` summed into ``n`` rows by ``segments``
    (``index_add``); integers exactly, uint16/uint32 in int64."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    if values.dtype in WIDE_UNSIGNED:
        return out.to(torch.int64).index_add(
            0, segments, values.to(torch.int64)).to(values.dtype)
    return out.index_add(0, segments, values)


class BaseSparseNDArray(NDArray):
    """A sparse array: its values in ``_data``, its index arrays in
    ``_aux``, its dense shape in ``_shape``."""

    __slots__ = ("_aux", "_shape")

    def asnumpy(self):
        return self.todense().asnumpy()

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return math.prod(self._shape)

    def todense(self) -> NDArray:
        raise NotImplementedError

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self.todense(), stype)

    def astype(self, dtype, copy=True):
        return self._replace_data(self._data.to(resolve_dtype(dtype)))

    def copy(self):
        return self._replace_data(self._data.clone())

    def _replace_data(self, new_data):
        out = type(self).__new__(type(self))
        NDArray.__init__(out, new_data, ctx=self._ctx)
        out._aux = self._aux
        out._shape = self._shape
        return out

    def _values_op(self, fn, *args):
        """``fn`` of the values as an ``mx.np`` op (its dtype rules)."""
        return self._replace_data(fn(NDArray(self._data, ctx=self._ctx),
                                     *args)._data)

    def __repr__(self):
        return (f"<{type(self).__name__} {self.shape} "
                f"dtype={onp.dtype(self.dtype).name}>")

    # a scalar keeps the sparsity; an array computes on the dense array
    def __mul__(self, other):
        if onp.isscalar(other):
            return self._values_op(self._np().multiply, other)
        return self.todense() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        if onp.isscalar(other):
            return self._values_op(self._np().true_divide, other)
        return self.todense() / other

    def __neg__(self):
        return self._values_op(self._np().negative)

    def __add__(self, other):
        if isinstance(other, type(self)):
            return add(self, other)
        return self.todense() + other

    def __radd__(self, other):
        return self.todense() + other

    def __sub__(self, other):
        if isinstance(other, type(self)):
            return add(self, -other)
        return self.todense() - other

    def sum(self, *a, **k):
        return self.todense().sum(*a, **k)

    def mean(self, *a, **k):
        return self.todense().mean(*a, **k)


class RowSparseNDArray(BaseSparseNDArray):
    """The rows at ``indices`` hold ``data``; every other row is 0."""

    __slots__ = ()

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        return NDArray(self._data, ctx=self._ctx)

    @property
    def indices(self):
        return NDArray(self._aux[0], ctx=self._ctx)

    def todense(self) -> NDArray:
        dense = torch.zeros(self._shape, dtype=self._data.dtype,
                            device=self._data.device)
        dense = _put(dense, (self._aux[0].to(torch.int64),), self._data)
        return NDArray(engine.track(dense), ctx=self._ctx)

    def retain(self, row_ids):
        return retain(self, row_ids)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix."""

    __slots__ = ()

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return NDArray(self._data, ctx=self._ctx)

    @property
    def indices(self):
        return NDArray(self._aux[0], ctx=self._ctx)

    @property
    def indptr(self):
        return NDArray(self._aux[1], ctx=self._ctx)

    def _row_ids(self):
        """The row of each stored value (a search of indptr)."""
        nnz = self._data.shape[0]
        ptr = self._aux[1]
        pos = torch.arange(nnz, dtype=ptr.dtype, device=ptr.device)
        return torch.searchsorted(ptr, pos, right=True).to(torch.int64) - 1

    def todense(self) -> NDArray:
        if self._data.dtype == torch.bool:
            raise TypeError("a CSR array sums its values into the dense "
                            "array: bool values have no add (as in the "
                            "reference)")
        dense = torch.zeros(self._shape, dtype=self._data.dtype,
                            device=self._data.device)
        dense = _put(dense, (self._row_ids(), self._aux[0].to(torch.int64)),
                     self._data, accumulate=True)
        return NDArray(engine.track(dense), ctx=self._ctx)

    def __getitem__(self, key):
        if isinstance(key, int):
            key = slice(key, key + 1)
        if isinstance(key, slice):
            return cast_storage(self.todense()[key], "csr")
        raise TypeError("CSRNDArray supports row slicing only")


def _new(cls, data, aux, shape, ctx):
    out = cls.__new__(cls)
    NDArray.__init__(out, engine.track(data), ctx=ctx)
    out._aux = [engine.track(a) for a in aux]
    out._shape = tuple(shape)
    return out


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices) (stored sorted by row) or
    from a dense source."""
    ctx = ctx or current_context()
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise ValueError("shape required for (data, indices) input")
        data = _values(data, dtype, ctx)
        indices = _as_index_array(indices, ctx.torch_device)
        order = torch.argsort(indices, stable=True)
        return _new(RowSparseNDArray, _rows(data, order), [indices[order]],
                    shape, ctx)
    return cast_storage(_dense(arg1, dtype, ctx), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr) or from a dense
    source."""
    ctx = ctx or current_context()
    if isinstance(arg1, CSRNDArray):
        return arg1
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise ValueError("shape required for (data, indices, indptr)")
        dev = ctx.torch_device
        return _new(CSRNDArray, _values(data, dtype, ctx),
                    [_as_index_array(indices, dev),
                     _as_index_array(indptr, dev)], shape, ctx)
    return cast_storage(_dense(arg1, dtype, ctx), "csr")


def _dense(arg1, dtype, ctx):
    if isinstance(arg1, NDArray):
        return arg1
    from .. import numpy as _np
    return _np.array(arg1, dtype=dtype, ctx=ctx)


def zeros(stype, shape, ctx=None, dtype=None):
    dtype = resolve_dtype(dtype) if dtype else torch.float32
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    ctx = ctx or current_context()
    dev = ctx.torch_device
    idt = narrow_dtype(None, torch.int64)
    if stype == "row_sparse":
        return _new(RowSparseNDArray,
                    torch.zeros((0,) + shape[1:], dtype=dtype, device=dev),
                    [torch.zeros(0, dtype=idt, device=dev)], shape, ctx)
    if stype == "csr":
        return _new(CSRNDArray, torch.zeros(0, dtype=dtype, device=dev),
                    [torch.zeros(0, dtype=idt, device=dev),
                     torch.zeros(shape[0] + 1, dtype=idt, device=dev)],
                    shape, ctx)
    if stype == "default":
        from .. import numpy as _np
        return _np.zeros(shape, dtype=dtype, ctx=ctx)
    raise ValueError(f"unknown stype {stype!r}")


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


# ---------------------------------------------------------------------------
# storage casts (through the host, as in the reference)
# ---------------------------------------------------------------------------
def cast_storage(arr, stype):
    if isinstance(arr, BaseSparseNDArray):
        if stype == arr.stype:
            return arr
        arr = arr.todense()
    if stype == "default":
        return arr
    host = onp.asarray(arr.asnumpy())
    if stype == "row_sparse":
        nz = onp.nonzero(host.reshape(host.shape[0], -1).any(axis=1))[0]
        return row_sparse_array((host[nz], nz.astype(onp.int64)),
                                shape=host.shape, ctx=arr.ctx,
                                dtype=host.dtype)
    if stype == "csr":
        if host.ndim != 2:
            raise ValueError("csr requires a 2-D array")
        rows, cols = onp.nonzero(host)
        indptr = onp.zeros(host.shape[0] + 1, onp.int64)
        onp.add.at(indptr, rows + 1, 1)
        return csr_matrix((host[rows, cols], cols.astype(onp.int64),
                           onp.cumsum(indptr)), shape=host.shape,
                          ctx=arr.ctx, dtype=host.dtype)
    raise ValueError(f"unknown stype {stype!r}")


# ---------------------------------------------------------------------------
# sparse ops
# ---------------------------------------------------------------------------
def _promoted(a, b):
    from ..numpy import result_type
    return resolve_dtype(result_type(a, b))


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware matrix product. csr x dense is a gather and a sum by
    row (``index_add``); csr^T x dense a scatter-add; row_sparse x dense
    a product of the stored rows written into their rows. Anything else
    computes on the dense arrays."""
    from ..ops import apply_op
    from ..numpy_extension.contrib_ops import _product
    dense_rhs = isinstance(rhs, NDArray) and not isinstance(
        rhs, BaseSparseNDArray)
    if dense_rhs and rhs.ndim == 1 and isinstance(
            lhs, (CSRNDArray, RowSparseNDArray)):
        return dot(lhs, rhs.reshape(-1, 1), transpose_a=transpose_a,
                   transpose_b=False).reshape(-1)
    if isinstance(lhs, CSRNDArray) and dense_rhs:
        cols = lhs._aux[0].to(torch.int64)
        rows = lhs._row_ids()
        n_rows, n_cols = lhs.shape
        res = _promoted(lhs.data, rhs)

        def csr_dot(data, r):
            if transpose_b:
                r = r.T
            wide = not res.is_floating_point
            cd = torch.int64 if wide else res
            data, r = data.to(cd), r.to(cd)
            if not transpose_a:
                out = _segment_sum(data[:, None] * _rows(r, cols), rows,
                                   n_rows)
            else:
                out = _segment_sum(data[:, None] * _rows(r, rows), cols,
                                   n_cols)
            return out.to(res)

        return apply_op(csr_dot, lhs.data, rhs, name="sparse_dot_csr")
    if isinstance(lhs, RowSparseNDArray) and dense_rhs:
        idx = lhs._aux[0].to(torch.int64)
        n_rows = lhs.shape[0]

        def rsp_dot(data, r):
            if transpose_b:
                r = r.T
            if not transpose_a:
                p = _product(data, r)
                out = torch.zeros((n_rows, r.shape[1]), dtype=p.dtype,
                                  device=p.device)
                return _put(out, (idx,), p)
            return _product(data.T, _rows(r, idx))

        return apply_op(rsp_dot, lhs.data, rhs, name="sparse_dot_rsp")
    from .. import numpy as _np
    ld = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rd = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    if transpose_a:
        ld = ld.T
    if transpose_b:
        rd = rd.T
    return _np.dot(ld, rd)


def add(lhs, rhs):
    """Sparse + sparse of one storage type stays sparse; anything else
    adds the dense arrays."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                         RowSparseNDArray):
        assert lhs.shape == rhs.shape
        idx = torch.cat([lhs._aux[0], rhs._aux[0]])
        dat = torch.cat([lhs._data, rhs._data])
        uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
        summed = _segment_sum(dat, inv.to(torch.int64), uniq.shape[0])
        return row_sparse_array((summed, uniq), shape=lhs.shape,
                                ctx=lhs.ctx)
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        return cast_storage(lhs.todense() + rhs.todense(), "csr")
    return (lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs) \
        + (rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs)


elemwise_add = add


def retain(rsp, row_ids):
    """Only the rows ``row_ids`` of a RowSparseNDArray (zeros where it
    stores none)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    want = _as_index_array(row_ids, rsp._data.device)
    have = rsp._aux[0]
    if have.shape[0] == 0:
        data = torch.zeros((want.shape[0],) + tuple(rsp._data.shape[1:]),
                           dtype=rsp._data.dtype, device=rsp._data.device)
    else:
        pos = torch.searchsorted(have, want).clamp(0, have.shape[0] - 1)
        hit = have[pos] == want
        got = _rows(rsp._data, pos)
        hit = hit.reshape((-1,) + (1,) * (got.dim() - 1))
        if got.dtype.is_floating_point:
            data = got * hit.to(got.dtype)
        else:
            sv = _SIGNED_VIEW.get(got.dtype, got.dtype)
            data = torch.where(hit, got.view(sv), 0).view(got.dtype)
    return row_sparse_array((data, want), shape=rsp.shape, ctx=rsp.ctx)


def norm(arr, ord=2):
    """The vector norm of the stored values (the dense array's, as the
    zeros add nothing)."""
    r = torch.linalg.vector_norm(float_input(arr._data.reshape(-1)),
                                 ord=ord)
    return NDArray(engine.track(r), ctx=arr.ctx)


def array(source, ctx=None, dtype=None):
    """Sparse-aware array constructor: a scipy sparse matrix becomes a
    CSRNDArray."""
    if isinstance(source, BaseSparseNDArray):
        return source
    try:
        import scipy.sparse as sps
        if sps.issparse(source):
            csr = source.tocsr()
            return csr_matrix((csr.data, csr.indices.astype(onp.int64),
                               csr.indptr.astype(onp.int64)),
                              shape=csr.shape, ctx=ctx, dtype=dtype)
    except ImportError:
        pass
    raise ValueError("use mx.np.array for dense sources")
