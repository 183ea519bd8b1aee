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
           "to_numpy_dtype", "NARROW64", "set_np", "reset_np",
           "is_np_array", "is_np_shape", "is_np_default_dtype"]


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
# check, floats silently. It also narrows the 64-bit results torch gives
# where XLA gives 32-bit ones (integer sums, argmax indices). The policy
# holds unless ``set_np(dtype=True)`` is on, which turns JAX's x64 on in
# the reference: 64-bit arrays then stay 64-bit (``narrowing()``).
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
    target = narrowing().get(dtype)
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


# --- np mode (the reference's base.py:103-160). NumPy shape and array
# semantics are always on; ``set_np(dtype=True)`` makes creation and
# random ops default to float64, classic NumPy style, and keeps 64-bit
# arrays 64-bit, as the reference's x64 switch does.
_np_default_dtype = [False]


def is_np_shape():
    """NumPy-shape semantics are always on (the reference's toggle exists
    for its legacy ``mx.nd`` API, where 0 meant an unknown dim)."""
    return True


def is_np_array():
    return True


def is_np_default_dtype():
    return _np_default_dtype[0]


def set_np(shape=True, array=True, dtype=False):  # noqa: ARG001
    """NumPy shape and array semantics are always on; ``dtype=True``
    switches the default float dtype to float64 (and 64-bit arrays stay
    64-bit) until ``reset_np()``."""
    _np_default_dtype[0] = bool(dtype)


def reset_np():
    _np_default_dtype[0] = False


def narrowing() -> dict:
    """The 64-bit narrowing table in force: ``NARROW64``, or none under
    ``set_np(dtype=True)``."""
    return {} if _np_default_dtype[0] else NARROW64


def default_float() -> torch.dtype:
    """The default float dtype of creation and random ops: the
    reference's deep-numpy float32, float64 under
    ``set_np(dtype=True)``."""
    return torch.float64 if _np_default_dtype[0] else torch.float32


# --- dtype routes shared by ``numpy`` and ``ops.nn``: torch's kernels
# refuse some dtypes that jnp takes.
#: unsigned dtypes torch neither promotes nor computes on
WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
#: sum and prod of these give uint32, as in the reference
UNSIGNED = (torch.uint8, *WIDE_UNSIGNED)


def float_input(x):
    """An integer or bool tensor in the default float dtype (a float
    function's input, as jnp promotes it); any other as it is."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x
    return x.to(default_float())


def int64_route(tfn, res=None):
    """``tfn`` of one tensor (further arguments passed on): a uint16/32/64
    tensor, which torch's kernels mostly refuse on the CPU and the card
    alike, is computed on as int64 and an int64 result cast back to its
    dtype, so ``negative`` wraps as the narrower type would. ``res``
    names the result dtype of an op with a rule of its own (sum and
    prod give uint32, uint8 included; argmax keeps its index)."""
    routed = UNSIGNED if res is not None else WIDE_UNSIGNED

    def f(x, *args):
        if x.dtype not in routed:
            return tfn(x, *args)
        r = tfn(x.to(torch.int64), *args)
        return r.to(res or x.dtype) if r.dtype == torch.int64 else r
    return f


def bool_route(tfn, res=None):
    """``tfn`` of one tensor (further arguments passed on) where torch
    refuses a bool input (``relu``, ``abs``, ``argmax``/``argmin``,
    ``topk``): a bool tensor is computed on as int32, and the result is
    cast to ``res`` when given (``abs`` gives the bool input back, as
    the reference does) or else keeps the dtype ``tfn`` gives it
    (``relu`` int32, an index its own)."""
    def f(x, *args):
        if x.dtype != torch.bool:
            return tfn(x, *args)
        r = tfn(x.to(torch.int32), *args)
        return r if res is None else r.to(res)
    return f
