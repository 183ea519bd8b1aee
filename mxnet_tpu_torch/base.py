"""Shared helpers of the port: the error types, the dtype names and the
64-bit narrowing policy of ``mxnet_tpu/base.py``.

Dtypes resolve to ``torch.dtype`` (what the port computes with);
``NDArray.dtype`` reports them back as numpy dtypes, as the reference
does, so the two packages' dtypes compare equal.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["MXNetError", "NotPortedError", "not_ported", "resolve_dtype",
           "narrow_dtype", "default_float", "to_torch_dtype",
           "to_numpy_dtype", "NARROW64"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


class NotPortedError(NotImplementedError, AttributeError):
    """A reference feature that a later slice of the port brings. It is
    an ``AttributeError`` too, so ``hasattr`` on a module that raises it
    for a missing name answers False."""


def not_ported(what, item) -> NotPortedError:
    """The error for a reference feature a later slice of the port
    brings; ``item`` names its ROADMAP.md queue-1 entry."""
    return NotPortedError(
        f"{what} is not ported to mxnet_tpu_torch yet (ROADMAP.md queue 1, "
        f"item {item})")


# dtype aliases accepted everywhere a dtype can be passed
_DTYPE_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bool_": "bool",
}

_NP2TORCH = {
    onp.dtype("float16"): torch.float16,
    onp.dtype("float32"): torch.float32,
    onp.dtype("float64"): torch.float64,
    onp.dtype("int8"): torch.int8,
    onp.dtype("int16"): torch.int16,
    onp.dtype("int32"): torch.int32,
    onp.dtype("int64"): torch.int64,
    onp.dtype("uint8"): torch.uint8,
    onp.dtype("uint16"): torch.uint16,
    onp.dtype("uint32"): torch.uint32,
    onp.dtype("uint64"): torch.uint64,
    onp.dtype("bool"): torch.bool,
    onp.dtype("complex64"): torch.complex64,
    onp.dtype("complex128"): torch.complex128,
}
_TORCH2NP = {t: n for n, t in _NP2TORCH.items()}

# 64-bit dtype policy (the reference's x64-off default, base.py:68-100):
# 64-bit arrays narrow to 32-bit BY DESIGN, integers with an overflow
# check, floats silently. The port has no x64 switch, so the policy
# always holds; it also narrows the 64-bit results torch gives where
# XLA gives 32-bit ones (integer sums, argmax indices).
NARROW64 = {torch.int64: torch.int32, torch.uint64: torch.uint32,
            torch.float64: torch.float32,
            torch.complex128: torch.complex64}


def to_torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype (or anything ``onp.dtype`` takes), or a torch
    dtype, as a ``torch.dtype``; no narrowing."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        dtype = _DTYPE_ALIASES.get(dtype, dtype)
        if dtype == "bfloat16":
            return torch.bfloat16
    try:
        return _NP2TORCH[onp.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise TypeError(f"unsupported dtype {dtype!r}") from e


def to_numpy_dtype(dtype):
    """A torch dtype as the numpy dtype the reference reports;
    ``torch.bfloat16`` (numpy has none) stays as it is."""
    return _TORCH2NP.get(dtype, dtype)


def resolve_dtype(dtype, values=None):
    """Normalize a user-provided dtype to the ``torch.dtype`` used on
    the device, under the 64-bit narrowing policy. Pass ``values`` when
    host data is at hand to get the integer bounds check."""
    if dtype is None:
        return None
    return narrow_dtype(values, to_torch_dtype(dtype))


def narrow_dtype(values, dtype):
    """Apply the 64-bit narrowing policy to (host values, dtype).

    Returns the torch dtype actually used on the device. Raises
    OverflowError when integer values do not fit in 32 bits.
    """
    if dtype is None:
        return dtype
    dtype = to_torch_dtype(dtype)
    target = NARROW64.get(dtype)
    if target is None:
        return dtype
    if not dtype.is_floating_point and not dtype.is_complex \
            and values is not None:
        arr = onp.asarray(values)
        # float host data feeding an integer dtype must bounds-check
        # too (e.g. array([1e12], dtype='int64'))
        if arr.size and arr.dtype.kind in "iuf":
            info = onp.iinfo(to_numpy_dtype(target))
            bad_nan = arr.dtype.kind == "f" and bool(onp.isnan(arr).any())
            if bad_nan or arr.max(initial=0) > info.max or \
                    arr.min(initial=0) < info.min:
                raise OverflowError(
                    f"{to_numpy_dtype(dtype).name} value out of "
                    f"{to_numpy_dtype(target).name} range under the "
                    "port's 32-bit index policy")
    return target


def default_float() -> torch.dtype:
    """The default float dtype of creation and random ops (the
    reference's deep-numpy float32; ``set_np(dtype=True)`` is not
    ported)."""
    return torch.float32
