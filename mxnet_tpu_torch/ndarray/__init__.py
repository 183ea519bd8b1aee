"""mx.nd — the NDArray type, ``waitall``, the sparse arrays
(``nd.sparse``) and the sparse-aware ``dot`` (``nd.save``/``nd.load``
come with ROADMAP.md queue-1 item 18)."""
from __future__ import annotations

from ..base import not_ported
from .ndarray import NDArray, waitall
from . import sparse
from .sparse import BaseSparseNDArray, RowSparseNDArray, CSRNDArray

__all__ = ["NDArray", "waitall", "save", "load", "sparse", "dot",
           "BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray"]


def dot(lhs, rhs, transpose_a=False, transpose_b=False, out=None):
    """``mx.nd.dot`` with the legacy transpose flags: a sparse operand
    goes to ``sparse.dot`` (csr x dense, csr^T x dense, row_sparse x
    dense); two dense ones to ``mx.np.dot``."""
    if isinstance(lhs, BaseSparseNDArray) or \
            isinstance(rhs, BaseSparseNDArray):
        r = sparse.dot(lhs, rhs, transpose_a=transpose_a,
                       transpose_b=transpose_b)
        return r if out is None else out._inplace(r)
    from .. import numpy as _np
    a = _np.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = _np.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return _np.dot(a, b, out=out)


def save(fname, data):
    raise not_ported("nd.save", 18)


def load(fname):
    raise not_ported("nd.load", 18)
