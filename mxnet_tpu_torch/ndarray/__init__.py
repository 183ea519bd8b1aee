"""mx.nd — the NDArray type, ``waitall``, the sparse arrays
(``nd.sparse``), the sparse-aware ``dot`` and ``nd.save``/``nd.load``
(``utils_io``'s)."""
from __future__ import annotations

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
    """``mx.save``: an array, a list or a dict of arrays to ``fname``."""
    from ..utils_io import save as _save
    return _save(fname, data)


def load(fname):
    """``mx.load``: the list or dict of arrays in ``fname``."""
    from ..utils_io import load as _load
    return _load(fname)
