"""Reader/writer for the reference's legacy binary NDArray format.

The reference serializes ``mx.nd.save`` files as a dmlc-stream list:

    uint64 magic (0x112), uint64 reserved,
    vector<NDArray>  (uint64 count, then each array),
    vector<string>   (uint64 count, then per-name uint64 len + bytes)

and each NDArray (``src/ndarray/ndarray.cc`` NDArray::Save/Load,
around lines 1729/1852) as:

    uint32 magic            V1 0xF993fac8 / V2 0xF993fac9 / V3 0xF993faca
                            (pre-V1 files put the shape's ndim here)
    [V2/V3] int32 stype     1 dense / 2 row_sparse / 3 csr... see below
    [sparse] storage_shape  TShape: int32 ndim + int64[ndim]
    shape                   TShape
    int32 dev_type, int32 dev_id        (Context; ignored on load)
    int32 type_flag                     (mshadow dtype enum)
    [sparse] per aux: int32 aux_type, TShape aux_shape
    raw data bytes          (storage_shape for sparse, shape otherwise)
    [sparse] raw aux bytes

Storage-type enum (include/mxnet/ndarray.h:61): -1 undefined,
0 default(dense), 1 row_sparse, 2 csr.  CSR aux order: indptr, indices
(csr::kIndPtr=0, kIdx=1); row_sparse aux: idx.

This module lets models/params saved by the reference ecosystem load
directly; ``utils_io.load`` auto-detects this format by magic. It is
the PyTorch port's own copy of ``mxnet_tpu/legacy_serialization.py``
(the format tables and byte layout are the same; the arrays it makes
are the port's, on the current context).
Everything is little-endian (dmlc streams are raw host-endian writes;
x86/arm LE in practice).
"""
from __future__ import annotations

import struct

import numpy as onp

LIST_MAGIC = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA

# mshadow type flags (3rdparty/mshadow/mshadow/base.h:353)
_TYPE_FLAG_TO_DTYPE = {
    0: onp.dtype(onp.float32),
    1: onp.dtype(onp.float64),
    2: onp.dtype(onp.float16),
    3: onp.dtype(onp.uint8),
    4: onp.dtype(onp.int32),
    5: onp.dtype(onp.int8),
    6: onp.dtype(onp.int64),
    7: onp.dtype(bool),
    8: onp.dtype(onp.int16),
    9: onp.dtype(onp.uint16),
    10: onp.dtype(onp.uint32),
    11: onp.dtype(onp.uint64),
}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}

_STYPE_DENSE, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2


class _Reader:
    def __init__(self, data: bytes):
        # writable, so the arrays read from it go to torch without a copy
        # warning
        self.b = bytearray(data)
        self.pos = 0

    def read(self, n):
        if self.pos + n > len(self.b):
            raise ValueError("truncated legacy NDArray file")
        out = self.b[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def shape(self):
        """TShape: int32 ndim then int64[ndim]."""
        ndim = self.i32()
        if ndim < 0:
            return None  # unknown shape (V3 "none" array)
        return tuple(struct.unpack(f"<{ndim}q", self.read(8 * ndim)))

    def shape_u32(self, ndim):
        """Pre-V1 TShape: uint32[ndim] (ndim came from the magic slot)."""
        return tuple(struct.unpack(f"<{ndim}I", self.read(4 * ndim)))


def _read_ndarray(r: _Reader):
    """Returns (numpy_array | sparse tuple). Sparse returns
    ('row_sparse'|'csr', data, aux_arrays, shape)."""
    magic = r.u32()
    if magic in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        stype = r.i32()
        nad = {_STYPE_DENSE: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}.get(
            stype)
        if nad is None:
            raise ValueError(f"unknown storage type {stype} in legacy file")
        sshape = r.shape() if nad else None
        shape = r.shape()
        if shape is None or (magic != NDARRAY_V3_MAGIC and shape == ()):
            return onp.zeros((0,), onp.float32)  # "none" array
        r.i32(), r.i32()  # context dev_type/dev_id — ignored
        type_flag = r.i32()
        aux = []
        for _ in range(nad):
            aux_type = r.i32()
            aux_shape = r.shape()
            aux.append((aux_type, aux_shape))
        dt = _TYPE_FLAG_TO_DTYPE[type_flag]
        data_shape = sshape if nad else shape
        n = int(onp.prod(data_shape)) if data_shape else 1
        data = onp.frombuffer(r.read(n * dt.itemsize), dtype=dt)
        data = data.reshape(data_shape)
        if not nad:
            return data
        aux_arrays = []
        for aux_type, aux_shape in aux:
            adt = _TYPE_FLAG_TO_DTYPE[aux_type]
            an = int(onp.prod(aux_shape)) if aux_shape else 1
            aux_arrays.append(onp.frombuffer(
                r.read(an * adt.itemsize), dtype=adt).reshape(aux_shape))
        kind = "row_sparse" if stype == _STYPE_ROW_SPARSE else "csr"
        return (kind, data, aux_arrays, shape)
    # V1 / pre-V1 dense-only path
    if magic == NDARRAY_V1_MAGIC:
        shape = r.shape()
    else:
        shape = r.shape_u32(magic)  # magic slot held ndim
    if shape == ():
        return onp.zeros((0,), onp.float32)
    r.i32(), r.i32()  # context
    type_flag = r.i32()
    dt = _TYPE_FLAG_TO_DTYPE[type_flag]
    n = int(onp.prod(shape))
    return onp.frombuffer(r.read(n * dt.itemsize), dtype=dt).reshape(shape)


def is_legacy_file(head: bytes) -> bool:
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == LIST_MAGIC


def load_legacy(fname):
    """Load a reference-format NDArray file → list or dict of NDArray.

    Mirrors NDArray::Load list semantics: empty name vector → list,
    else dict keyed by names (``arg:``/``aux:`` prefixes preserved —
    SymbolBlock.imports strips them).
    """
    from .numpy import array
    from .ndarray import sparse as sp

    with open(fname, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != LIST_MAGIC:
        raise ValueError(f"{fname!r} is not a legacy NDArray file "
                         "(bad magic)")
    r.u64()  # reserved
    n_arrays = r.u64()
    arrays = []
    for _ in range(n_arrays):
        raw = _read_ndarray(r)
        if isinstance(raw, tuple):
            kind, data, aux, shape = raw
            if kind == "row_sparse":
                arrays.append(sp.row_sparse_array((data, aux[0]),
                                                  shape=shape))
            else:  # csr: aux order (indptr, indices)
                arrays.append(sp.csr_matrix((data, aux[1], aux[0]),
                                            shape=shape))
        else:
            arrays.append(array(raw))
    n_names = r.u64()
    names = []
    for _ in range(n_names):
        ln = r.u64()
        names.append(r.read(ln).decode("utf-8"))
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise ValueError("invalid legacy NDArray file: "
                         f"{len(names)} names vs {len(arrays)} arrays")
    return dict(zip(names, arrays))


def _write_shape(out, shape):
    out.append(struct.pack("<i", len(shape)))
    out.append(struct.pack(f"<{len(shape)}q", *shape))


def _write_ndarray(out, arr):
    """Write one dense array in V2 format (what 1.x writes by default)."""
    from .utils_io import _host
    a = onp.ascontiguousarray(_host(arr))
    flag = _DTYPE_TO_TYPE_FLAG.get(a.dtype)
    if flag is None:
        raise TypeError(f"dtype {a.dtype} has no legacy type flag")
    out.append(struct.pack("<I", NDARRAY_V2_MAGIC))
    out.append(struct.pack("<i", _STYPE_DENSE))
    _write_shape(out, a.shape)
    out.append(struct.pack("<ii", 1, 0))  # Context: cpu(0)
    out.append(struct.pack("<i", flag))
    out.append(a.tobytes())


def save_legacy(fname, data):
    """Write a reference-format NDArray file (dense V2 entries).

    Exists for round-trip tests and for exporting params back to
    reference-ecosystem tools."""
    import torch
    if hasattr(data, "asnumpy") or isinstance(data, onp.ndarray) \
            or torch.is_tensor(data):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names, arrays = [], list(data)
    out = [struct.pack("<QQ", LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_ndarray(out, a)
    out.append(struct.pack("<Q", len(names)))
    for nm in names:
        raw = nm.encode("utf-8")
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    with open(fname, "wb") as f:
        f.write(b"".join(out))
