"""mx.np — the NumPy-semantics array API.

The port of ``mxnet_tpu/numpy/__init__.py``: every function lowers to a
PyTorch expression through ``ops.apply_op`` (async on the card,
context inference, autograd). Conventions, as in the reference:

- NDArray positional args are differentiable; static attributes (axis,
  shape, ...) are closed over.
- Default dtypes follow the reference (float32 for creation ops unless
  the input carries a dtype), not NumPy's float64; 64-bit results
  narrow to 32 bits (``base.NARROW64``): index results are int32.
- A Python scalar operand takes part as a 0-d tensor, so it promotes
  like a JAX weak-typed scalar (``int32 + 2`` stays int32,
  ``int32 * 2.5`` is float32).
- Integer and bool inputs of a float function compute in float32
  (``_float_in``); uint16/uint32 operands, which torch's kernels mostly
  refuse, compute as int64 (``_int64_route``) or move as the signed
  type of their width (``_signed_view``).
- ``out=`` is honored by installing the result into the target array.

Everything runs on the arrays' device. Data-dependent shapes
(``nonzero``, ``unique``, ``compress``, ``trim_zeros``, ...) sync with
the host once a call, as the reference's eager calls do. Two routes
run on the host, as in the reference: ``linalg.eig``/``eigvals``
(LAPACK ``geev``) and the NumPy fallback (``__getattr__`` below) for a
NumPy name this module does not define; the fallback counts its calls
in ``FALLBACK_CALLS``. ``save``/``savez``/``load``, ``genfromtxt`` and
``fromiter`` read or write host files and iterables by nature.
"""
from __future__ import annotations

import builtins
import collections
import functools
import itertools
import math

import numpy as onp
import torch

from .. import engine
from ..base import (NARROW64, default_float, float_input, narrow_dtype,
                    resolve_dtype, to_numpy_dtype, to_torch_dtype)
from ..base import UNSIGNED as _UNSIGNED
from ..base import WIDE_UNSIGNED as _WIDE_UNSIGNED
from ..base import bool_route as _bool_route
from ..base import int64_route as _int64_route
from ..context import Context, current_context  # noqa: F401
from ..ndarray.ndarray import _SIGNED_VIEW, NDArray, _signed_view
from ..ops import apply_op

# re-exported names
ndarray = NDArray
pi = onp.pi
e = onp.e
euler_gamma = onp.euler_gamma
inf = onp.inf
nan = onp.nan
newaxis = None
PZERO = 0.0
NZERO = -0.0

float16 = onp.float16
float32 = onp.float32
float64 = onp.float64
bfloat16 = torch.bfloat16
int8 = onp.int8
int16 = onp.int16
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
uint16 = onp.uint16
uint32 = onp.uint32
uint64 = onp.uint64
bool_ = onp.bool_
dtype = onp.dtype


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _is_scalar(x) -> bool:
    return isinstance(x, (bool, int, float, complex)) or onp.isscalar(x)


def _coerce(x):
    """Lift array-likes to NDArray; leave NDArray and scalars alone."""
    if isinstance(x, NDArray) or x is None or _is_scalar(x):
        return x
    return array(x)


def _lift(x):
    """An operand as an NDArray: a Python scalar lifts as ``jnp`` lifts a
    weak-typed one (an int to int32, a bool to bool, a float to the
    default float), a NumPy scalar or an array-like as ``array`` lifts
    it."""
    x = _coerce(x)
    if isinstance(x, NDArray):
        return x
    if isinstance(x, bool):
        return array(x, dtype=onp.bool_)
    if isinstance(x, int):
        return array(x, dtype=onp.int32)
    return array(x)


def _scalar(x):
    """A Python or numpy scalar as a 0-d CPU tensor: torch then
    promotes it like a JAX weak-typed scalar, and lets it meet a tensor
    on the card."""
    return torch.as_tensor(x)


def _set_out(out, r):
    if out is None:
        return r
    return out._inplace(r)


def _is_int(dt) -> bool:
    return not (dt.is_floating_point or dt.is_complex)


def _unsigned_result(a, b):
    """The reference's result dtype when one operand is uint16/32/64
    and the other an integer or bool, else None. Arrays and NumPy
    scalars take NumPy's promotion table narrowed to 32 bits (JAX's
    with x64 off: uint32 + int32 -> int32, uint16 + uint8 -> uint16); a
    Python int or bool is weak and takes the array's dtype."""
    def dt(x):
        if isinstance(x, NDArray):
            return x._data.dtype
        if isinstance(x, (bool, int)):
            return None                       # weak
        if isinstance(x, (onp.integer, onp.bool_)):
            return resolve_dtype(onp.asarray(x).dtype)
        return False                          # a float or complex scalar
    da, db = dt(a), dt(b)
    if da is False or db is False \
            or not builtins.any(d in _WIDE_UNSIGNED for d in (da, db)) \
            or not builtins.all(d is None or _is_int(d) for d in (da, db)):
        return None
    if da is None or db is None:
        return da or db
    return resolve_dtype(onp.promote_types(to_numpy_dtype(da),
                                           to_numpy_dtype(db)))


def _promoted(operands):
    """The reference's result dtype of moving ``operands`` (NDArrays and
    scalars) into one array when one of them is uint16/32/64, which
    torch does not promote; else None. A float operand decides (floats
    promote among themselves, integers take their type; a Python float
    beside integer arrays gives the default float), otherwise the
    integers promote as ``_unsigned_result`` does, pairwise. Python
    ints and bools are weak and take the arrays' type."""
    dts = [x._data.dtype for x in operands if isinstance(x, NDArray)]
    if not builtins.any(d in _WIDE_UNSIGNED for d in dts):
        return None
    floats = [d for d in dts if d.is_floating_point]
    if floats:
        return functools.reduce(torch.promote_types, floats)
    if builtins.any(isinstance(x, float) for x in operands):
        return default_float()
    ints = dts + [resolve_dtype(onp.asarray(x).dtype) for x in operands
                  if isinstance(x, (onp.integer, onp.bool_))]
    return functools.reduce(
        lambda a, b: resolve_dtype(onp.promote_types(to_numpy_dtype(a),
                                                     to_numpy_dtype(b))),
        ints)


def _via_int64(tfn, res):
    """``tfn`` computed on int64 operands, an integer result cast to
    ``res`` (two's complement wraps as the narrower type would)."""
    def f(x, y):
        r = tfn(x.to(torch.int64), y.to(torch.int64))
        return r.to(res) if r.dtype == torch.int64 else r
    return f


def _bool_operands(tfn, pair=None):
    """``tfn`` of two tensors where torch refuses bool operands. A bool
    operand beside a non-bool one computes in their result type
    (``subtract``: ``bool - x`` takes x's type, a Python int gives
    int32 after narrowing, as in the reference). Two bool operands
    compute on ``pair`` copies where given (int32 for ``floor_divide``,
    ``mod``, ``power`` and the shifts, the reference's result type);
    without ``pair`` torch's refusal stands (``bool - bool`` raises in
    the reference too)."""
    def f(x, y):
        bx, by = x.dtype == torch.bool, y.dtype == torch.bool
        if bx and by:
            if pair is not None:
                x, y = x.to(pair), y.to(pair)
        elif bx or by:
            dt = torch.result_type(x, y)
            x, y = x.to(dt), y.to(dt)
        return tfn(x, y)
    return f


def _binary(tfn, a, b, out=None, name=None):
    a, b = _coerce(a), _coerce(b)
    res = _unsigned_result(a, b)
    if res is not None:
        tfn = _via_int64(tfn, res)
    if isinstance(a, NDArray) and isinstance(b, NDArray):
        r = apply_op(tfn, a, b, name=name)
    elif isinstance(a, NDArray):
        sb = _scalar(b)
        r = apply_op(lambda x: tfn(x, sb), a, name=name)
    elif isinstance(b, NDArray):
        sa = _scalar(a)
        r = apply_op(lambda y: tfn(sa, y), b, name=name)
    else:
        ctx = current_context()
        r = apply_op(lambda: tfn(_scalar(a), _scalar(b)).to(
            ctx.torch_device), ctx=ctx, name=name)
    return _set_out(out, r)


def _unary(tfn, a, out=None, name=None):
    return _set_out(out, apply_op(tfn, _lift(a), name=name))


def _npx():
    from .. import numpy_extension
    return numpy_extension


def _mkbin(tfn, name):
    def f(x1, x2, out=None, **kwargs):
        return _binary(tfn, x1, x2, out=out, name=name)
    f.__name__ = name
    return f


def _mkunary(tfn, name):
    tfn = _int64_route(tfn)

    def f(x, out=None, **kwargs):
        return _unary(tfn, x, out=out, name=name)
    f.__name__ = name
    return f


def _ctx(ctx, device):
    return ctx or device or current_context()


def _shape(shape):
    if isinstance(shape, (int, onp.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _new(t, ctx):
    return NDArray(engine.track(t), ctx=ctx)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def array(object, dtype=None, ctx=None, device=None):
    """Create an array. Default dtype is float32 for untyped input
    (reference semantics), preserved dtype for typed ndarray input;
    64-bit dtypes narrow to 32 bits (integers with a bounds check)."""
    ctx = _ctx(ctx, device)
    dev = ctx.torch_device
    if isinstance(object, NDArray):
        t = object._data.detach()
        dt = resolve_dtype(dtype) if dtype is not None \
            else narrow_dtype(None, t.dtype)
        return _new(t.to(device=dev, dtype=dt), ctx)
    if dtype is None:
        probe = onp.asarray(object)
        if isinstance(object, (onp.ndarray, onp.generic)):
            dt = probe.dtype          # typed input keeps its dtype
        else:
            # Python scalars and lists default to float32 (reference
            # semantics: mx.np.array([1, 2]) is float32)
            dt = to_numpy_dtype(default_float())
        npdata = probe.astype(dt) if probe.dtype != dt else probe
        tdt = narrow_dtype(npdata, dt)
    else:
        npdata = onp.asarray(object)
        tdt = resolve_dtype(dtype, values=npdata)
    host = onp.float32 if tdt == torch.bfloat16 else to_numpy_dtype(tdt)
    t = torch.from_numpy(onp.asarray(npdata, dtype=host, order="C"))
    # from_numpy shares the host buffer: copy on the host, move otherwise
    t = t.to(device=dev, dtype=tdt, copy=dev.type == "cpu")
    return _new(t, ctx)


def asarray(a, dtype=None, ctx=None):
    if isinstance(a, NDArray) and dtype is None:
        return a
    return array(a, dtype=dtype, ctx=ctx)


def _creation(maker, shape, dtype, ctx):
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    return _new(maker(_shape(shape), dt, ctx.torch_device), ctx)


def zeros(shape, dtype=None, order="C", ctx=None, device=None):
    return _creation(lambda s, d, dev: torch.zeros(s, dtype=d, device=dev),
                     shape, dtype, _ctx(ctx, device))


def ones(shape, dtype=None, order="C", ctx=None, device=None):
    return _creation(lambda s, d, dev: torch.ones(s, dtype=d, device=dev),
                     shape, dtype, _ctx(ctx, device))


def empty(shape, dtype=None, order="C", ctx=None, device=None):
    return zeros(shape, dtype=dtype, ctx=ctx, device=device)


def full(shape, fill_value, dtype=None, order="C", ctx=None, out=None,
         device=None):
    if dtype is None:
        # reference semantics: full is a default-dtype op even for an
        # int fill; a bool fill gives bool
        dtype = onp.bool_ if isinstance(fill_value, bool) \
            else default_float()
    r = _creation(lambda s, d, dev: torch.full(s, fill_value, dtype=d,
                                               device=dev),
                  shape, dtype, _ctx(ctx, device))
    return _set_out(out, r)


def zeros_like(a, dtype=None, order="C", ctx=None, out=None):
    dt = resolve_dtype(dtype)
    return _unary(lambda x: torch.zeros_like(x, dtype=dt), a, out=out,
                  name="zeros_like")


def ones_like(a, dtype=None, order="C", ctx=None, out=None):
    dt = resolve_dtype(dtype)
    return _unary(lambda x: torch.ones_like(x, dtype=dt), a, out=out,
                  name="ones_like")


def full_like(a, fill_value, dtype=None, order="C", ctx=None, out=None):
    dt = resolve_dtype(dtype)
    return _unary(lambda x: torch.full_like(x, fill_value, dtype=dt), a,
                  out=out, name="full_like")


def empty_like(prototype, dtype=None, order="C", subok=False):
    return zeros_like(prototype, dtype=dtype)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    """float32 regardless of the argument types (deep-numpy mode)."""
    ctx = _ctx(ctx, device)
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch.float64,
                     device=ctx.torch_device)
    return _new(t.to(dt), ctx)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    ctx = ctx or current_context()
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else float("nan")
    t = torch.linspace(start, stop if endpoint else start + step * num,
                       num + (0 if endpoint else 1), dtype=torch.float64,
                       device=ctx.torch_device)[:num]
    r = _new(t.to(dt), ctx)
    return (r, float(step)) if retstep else r


def eye(N, M=None, k=0, dtype=None, ctx=None):
    ctx = ctx or current_context()
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    M = N if M is None else M
    t = torch.ones(N, M, dtype=_SIGNED_VIEW.get(dt, dt),
                   device=ctx.torch_device)
    return _new(t.triu(k).tril(k).view(dt), ctx)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None):
    ctx = ctx or current_context()
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    lin = linspace(start, stop, num, endpoint=endpoint, ctx=ctx)._data
    return _new(torch.pow(torch.as_tensor(base, dtype=lin.dtype,
                                          device=lin.device), lin).to(dt),
                ctx)


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def meshgrid(*xi, indexing="xy", **kwargs):
    arrs = [_coerce(x) for x in xi]
    outs = apply_op(lambda *xs: tuple(torch.meshgrid(
        *[x.reshape(-1) for x in xs], indexing=indexing)),
        *arrs, nout=len(arrs), name="meshgrid")
    return list(outs) if isinstance(outs, tuple) else [outs]


def tril(m, k=0):
    return _unary(_signed_view(lambda x: torch.tril(x, k)), m, name="tril")


def triu(m, k=0):
    return _unary(_signed_view(lambda x: torch.triu(x, k)), m, name="triu")


def tri(N, M=None, k=0, dtype=None, ctx=None):
    ctx = ctx or current_context()
    dt = resolve_dtype(dtype) if dtype is not None else default_float()
    M = N if M is None else M
    t = torch.ones(N, M, dtype=torch.bool, device=ctx.torch_device)
    return _new(torch.tril(t, k).to(dt), ctx)


def diag(v, k=0):
    return _unary(_signed_view(lambda x: torch.diag(x, k)), v, name="diag")


def diagflat(v, k=0):
    return _unary(_signed_view(lambda x: torch.diagflat(x, k)), v,
                  name="diagflat")


def diagonal(a, offset=0, axis1=0, axis2=1):
    return _unary(lambda x: torch.diagonal(x, offset, axis1, axis2), a,
                  name="diagonal")


def _index_arrays(rows, ctx):
    return tuple(_new(r.to(torch.int32), ctx) for r in rows)


def diag_indices_from(arr):
    arr = _coerce(arr)
    i = torch.arange(arr.shape[0], device=arr._data.device)
    return _index_arrays([i] * arr.ndim, arr._ctx)


def tril_indices(n, k=0, m=None, ctx=None):
    ctx = ctx or current_context()
    m = n if m is None else m
    return _index_arrays(torch.tril_indices(n, m, k,
                                            device=ctx.torch_device), ctx)


def indices(dimensions, dtype=None, ctx=None):
    ctx = ctx or current_context()
    dt = resolve_dtype(dtype or onp.int64)
    dev = ctx.torch_device
    dims = tuple(int(d) for d in dimensions)
    if not dims:
        return _new(torch.zeros((0,), dtype=dt, device=dev), ctx)
    grids = torch.meshgrid(*[torch.arange(d, device=dev) for d in dims],
                           indexing="ij")
    return _new(torch.stack(grids).to(dt), ctx)


def copy(a):
    return _unary(lambda x: x.clone(), a, name="copy")


def ascontiguousarray(a, dtype=None):
    return asarray(a, dtype=dtype)


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------
add = _mkbin(torch.add, "add")
subtract = _mkbin(_bool_operands(torch.sub), "subtract")
multiply = _mkbin(torch.mul, "multiply")
divide = _mkbin(torch.true_divide, "divide")
true_divide = _mkbin(torch.true_divide, "true_divide")
floor_divide = _mkbin(_bool_operands(torch.floor_divide, torch.int32),
                      "floor_divide")
mod = _mkbin(_bool_operands(torch.remainder, torch.int32), "mod")
remainder = mod


def power(x1, x2, out=None, **kwargs):
    base = _coerce(x1)
    if isinstance(x2, (int, onp.integer)) \
            and not isinstance(x2, (bool, onp.bool_)) and x2 < 0 \
            and isinstance(base, NDArray) and _is_int(base._data.dtype):
        # the reference's integer_pow refuses a negative integer exponent
        raise TypeError(
            f"Integers cannot be raised to negative powers, got "
            f"integer_pow({base.dtype}{list(base.shape)}, {int(x2)})")
    return _binary(_bool_operands(torch.pow, torch.int32), base, x2,
                   out=out, name="power")


maximum = _mkbin(torch.maximum, "maximum")
minimum = _mkbin(torch.minimum, "minimum")
bitwise_and = _mkbin(torch.bitwise_and, "bitwise_and")
bitwise_or = _mkbin(torch.bitwise_or, "bitwise_or")
bitwise_xor = _mkbin(torch.bitwise_xor, "bitwise_xor")
left_shift = _mkbin(_bool_operands(torch.bitwise_left_shift, torch.int32),
                    "left_shift")
right_shift = _mkbin(_bool_operands(torch.bitwise_right_shift, torch.int32),
                     "right_shift")

equal = _mkbin(torch.eq, "equal")
not_equal = _mkbin(torch.ne, "not_equal")
less = _mkbin(torch.lt, "less")
less_equal = _mkbin(torch.le, "less_equal")
greater = _mkbin(torch.gt, "greater")
greater_equal = _mkbin(torch.ge, "greater_equal")
logical_and = _mkbin(torch.logical_and, "logical_and")
logical_or = _mkbin(torch.logical_or, "logical_or")
logical_xor = _mkbin(torch.logical_xor, "logical_xor")


def _inexact(dt):
    """``dt``, or float32 for an integer or bool type (jnp's
    ``promote_dtypes_inexact`` with x64 off)."""
    return dt if dt.is_floating_point or dt.is_complex else default_float()


def _float_pair(tfn):
    """``tfn`` of two tensors in their result type, float32 for
    integer and bool operands, as jnp promotes them."""
    def f(x, y):
        dt = _inexact(torch.result_type(x, y))
        return tfn(x.to(dt), y.to(dt))
    return f


def _ldexp(x, y):
    # 2 ** y in float32 (exact for every exponent of the type) times x
    dt = _inexact(x.dtype)
    return (x.to(dt) * torch.exp2(y.to(torch.int32).to(torch.float32))
            .to(dt)).to(dt)


def _heaviside(x, y):
    dt = _inexact(torch.result_type(x, y))
    x, y = x.to(dt), y.to(dt)
    return torch.where(x < 0, torch.zeros((), dtype=dt, device=x.device),
                       torch.where(x > 0, torch.ones((), dtype=dt,
                                                     device=x.device), y))


def _integer_pair(tfn):
    """``tfn`` of two integer tensors (gcd, lcm) in their result type,
    computed on int64 copies and wrapped back."""
    def f(x, y):
        dt = torch.result_type(x, y)
        if not _is_int(dt) or dt == torch.bool:
            raise ValueError(f"{getattr(tfn, '__name__', 'op')} takes "
                             f"integer operands, got {dt}")
        return tfn(x.to(torch.int64), y.to(torch.int64)).to(dt)
    return f


def _float_power(x, y):
    # the reference raises its base to float64, which narrows to float32
    return torch.pow(x.to(default_float()), y)


def _same_type_bool(tfn):
    """``tfn`` (fmax, fmin) of two tensors in their result type; two
    bool operands compute as uint8 and give bool back."""
    def f(x, y):
        dt = torch.result_type(x, y)
        if dt == torch.bool:
            return tfn(x.to(torch.uint8), y.to(torch.uint8)).to(torch.bool)
        return tfn(x.to(dt), y.to(dt))
    return f


fmod = _mkbin(_bool_operands(torch.fmod, torch.int32), "fmod")
float_power = _mkbin(_float_power, "float_power")
fmax = _mkbin(_same_type_bool(torch.fmax), "fmax")
fmin = _mkbin(_same_type_bool(torch.fmin), "fmin")
hypot = _mkbin(_float_pair(torch.hypot), "hypot")
arctan2 = _mkbin(_float_pair(torch.atan2), "arctan2")
logaddexp = _mkbin(_float_pair(torch.logaddexp), "logaddexp")
logaddexp2 = _mkbin(_float_pair(torch.logaddexp2), "logaddexp2")
copysign = _mkbin(_float_pair(torch.copysign), "copysign")
nextafter = _mkbin(_float_pair(torch.nextafter), "nextafter")
ldexp = _mkbin(_ldexp, "ldexp")
heaviside = _mkbin(_heaviside, "heaviside")
gcd = _mkbin(_integer_pair(torch.gcd), "gcd")
lcm = _mkbin(_integer_pair(torch.lcm), "lcm")


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
def _float_in(tfn):
    """Integer inputs compute in the default float, as jnp does for
    transcendental ops."""
    return lambda x: tfn(float_input(x))


negative = _mkunary(torch.neg, "negative")
positive = _mkunary(lambda x: x, "positive")


def _abs(x):
    # on the tape, the reference's subgradient: 1 at 0 (JAX passes the
    # gradient where x >= 0; torch.abs gives 0 there); + 0.0 makes -0.0
    # +0.0, as abs does
    if x.requires_grad and x.is_floating_point():
        return torch.where(x >= 0, x, -x) + 0.0
    return torch.abs(x)


abs = _mkunary(_bool_route(_abs, torch.bool), "abs")
absolute = abs
def _sign(x):
    # the reference refuses bool and keeps NaN (torch.sign gives 0)
    if x.dtype == torch.bool:
        raise TypeError("sign does not accept dtype bool")
    if x.is_floating_point():
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


sign = _mkunary(_sign, "sign")
square = _mkunary(torch.square, "square")
sqrt = _mkunary(_float_in(torch.sqrt), "sqrt")
exp = _mkunary(_float_in(torch.exp), "exp")
log = _mkunary(_float_in(torch.log), "log")
tanh = _mkunary(_float_in(torch.tanh), "tanh")
invert = _mkunary(torch.bitwise_not, "invert")
bitwise_not = invert


def _int_kept(tfn):
    """``tfn`` (floor, ceil, trunc) of a float tensor; integer and bool
    tensors come back as they are, as in the reference."""
    def f(x):
        return tfn(x) if x.is_floating_point() or x.is_complex() else x
    return f


def _cbrt(x):
    # torch has no cbrt: |x| ** (1/3) with x's sign
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _real(x):
    return torch.real(x) if x.is_complex() else x


def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


def _angle(x):
    # the card has no float16 angle: a 16-bit input is taken in float32
    if x.dtype in (torch.float16, torch.bfloat16):
        return torch.angle(x.float()).to(x.dtype)
    return torch.angle(x)


fabs = _mkunary(_float_in(torch.abs), "fabs")
rint = _mkunary(_float_in(torch.round), "rint")
ceil = _mkunary(_int_kept(torch.ceil), "ceil")
floor = _mkunary(_int_kept(torch.floor), "floor")
trunc = _mkunary(_int_kept(torch.trunc), "trunc")
fix = _mkunary(_int_kept(torch.trunc), "fix")
cbrt = _mkunary(_float_in(_cbrt), "cbrt")
reciprocal = _mkunary(_float_in(torch.reciprocal), "reciprocal")
exp2 = _mkunary(_float_in(torch.exp2), "exp2")
expm1 = _mkunary(_float_in(torch.expm1), "expm1")
log2 = _mkunary(_float_in(torch.log2), "log2")
log10 = _mkunary(_float_in(torch.log10), "log10")
log1p = _mkunary(_float_in(torch.log1p), "log1p")
sin = _mkunary(_float_in(torch.sin), "sin")
cos = _mkunary(_float_in(torch.cos), "cos")
tan = _mkunary(_float_in(torch.tan), "tan")
arcsin = _mkunary(_float_in(torch.asin), "arcsin")
arccos = _mkunary(_float_in(torch.acos), "arccos")
arctan = _mkunary(_float_in(torch.atan), "arctan")
sinh = _mkunary(_float_in(torch.sinh), "sinh")
cosh = _mkunary(_float_in(torch.cosh), "cosh")
arcsinh = _mkunary(_float_in(torch.asinh), "arcsinh")
arccosh = _mkunary(_float_in(torch.acosh), "arccosh")
arctanh = _mkunary(_float_in(torch.atanh), "arctanh")
degrees = _mkunary(_float_in(torch.rad2deg), "degrees")
radians = _mkunary(_float_in(torch.deg2rad), "radians")
deg2rad = _mkunary(_float_in(torch.deg2rad), "deg2rad")
rad2deg = _mkunary(_float_in(torch.rad2deg), "rad2deg")
logical_not = _mkunary(torch.logical_not, "logical_not")
isnan = _mkunary(torch.isnan, "isnan")
isinf = _mkunary(torch.isinf, "isinf")
isneginf = _mkunary(torch.isneginf, "isneginf")
isposinf = _mkunary(torch.isposinf, "isposinf")
isfinite = _mkunary(torch.isfinite, "isfinite")
signbit = _mkunary(torch.signbit, "signbit")
conjugate = _mkunary(_conj, "conjugate")
conj = conjugate
real = _mkunary(_real, "real")
imag = _mkunary(_imag, "imag")
angle = _mkunary(_float_in(_angle), "angle")


def _round(decimals):
    """jnp.round: half to even; ``decimals != 0`` scales by ``10 **
    decimals`` in x's type (float16 in float32), rounds and divides back;
    an integer input comes back as it is (``decimals >= 0``)."""
    def f(x):
        if x.dtype == torch.bool:
            raise ValueError("round is not defined for bool arrays")
        if not (x.is_floating_point() or x.is_complex()):
            if decimals < 0:
                raise NotImplementedError(
                    "integer np.round not implemented for decimals < 0")
            return x
        if decimals == 0:
            return torch.round(x)
        if decimals > math.log10(torch.finfo(x.dtype).max):
            return x
        dt = x.dtype
        w = x.float() if dt == torch.float16 else x
        factor = torch.as_tensor(10.0 ** decimals, dtype=w.dtype,
                                 device=w.device)
        return (torch.round(w * factor) / factor).to(dt)
    return f


def around(a, decimals=0, out=None):
    return _unary(_int64_route(_round(int(decimals))), a, out=out,
                  name="around")


round = around
round_ = around


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    def f(v):
        if not (v.is_floating_point() or v.is_complex()):
            return v
        return torch.nan_to_num(v, nan=nan, posinf=posinf, neginf=neginf)
    return _unary(f, x, name="nan_to_num")


def interp(x, xp, fp, left=None, right=None):
    """jnp.interp: the segment of ``xp`` each x falls in, by
    ``searchsorted(side='right')``, linear between its ends; ``left``/
    ``right`` (default fp's ends) outside ``xp``."""
    x, xp, fp = _coerce(x), _coerce(xp), _coerce(fp)

    def f(xv, xpv, fpv):
        dt = _inexact(torch.promote_types(xv.dtype, xpv.dtype))
        xv, xpv, fpv = xv.to(dt), xpv.to(dt), fpv.to(_inexact(fpv.dtype))
        n = xpv.shape[0]
        i = torch.searchsorted(xpv, xv.contiguous(), right=True) \
            .clamp(1, n - 1)
        df = fpv[i] - fpv[i - 1]
        dx = xpv[i] - xpv[i - 1]
        delta = xv - xpv[i - 1]
        eps = float(onp.spacing(onp.finfo(to_numpy_dtype(dt)).eps))
        dx0 = torch.abs(dx) <= eps
        one = torch.ones((), dtype=dx.dtype, device=dx.device)
        r = torch.where(dx0, fpv[i - 1],
                        fpv[i - 1] + delta / torch.where(dx0, one, dx) * df)
        lo = fpv[0] if left is None else torch.as_tensor(
            left, dtype=r.dtype, device=r.device)
        hi = fpv[-1] if right is None else torch.as_tensor(
            right, dtype=r.dtype, device=r.device)
        r = torch.where(xv < xpv[0], lo, r)
        return torch.where(xv > xpv[-1], hi, r)
    return apply_op(f, x, xp, fp, name="interp")


def clip(a, a_min=None, a_max=None, out=None):
    lo = None if a_min is None else (
        a_min._data if isinstance(a_min, NDArray) else a_min)
    hi = None if a_max is None else (
        a_max._data if isinstance(a_max, NDArray) else a_max)

    def f(x):
        if lo is None and hi is None:
            return x
        if not x.requires_grad:
            return torch.clamp(x, lo, hi)
        # on the tape, the reference's min(max(x, lo), hi): a tie with a
        # bound splits the gradient in halves (torch.clamp gives x all)
        if lo is not None:
            x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                                 device=x.device))
        if hi is not None:
            x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                                 device=x.device))
        return x
    return _unary(_int64_route(f), a, out=out, name="clip")


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    parts = [_coerce(condition), _coerce(x), _coerce(y)]
    nd = [p for p in parts if isinstance(p, NDArray)]
    res = _promoted(parts[1:])

    def f(*ds):
        it = iter(ds)
        c, a, b = [next(it) if isinstance(p, NDArray) else _scalar(p)
                   for p in parts]
        c = c if c.dtype == torch.bool else c != 0
        if res is None:
            return torch.where(c, a, b)
        sv = _SIGNED_VIEW.get(res, res)   # the card's where takes none
        return torch.where(c, a.to(res).view(sv), b.to(res).view(sv)) \
            .view(res)

    return apply_op(f, *nd, name="where")


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _reduce_each(tfn, x, dims, keepdims):
    """Reduce one axis at a time (torch's prod takes a single dim)."""
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = tfn(x, d, keepdim=keepdims)
    return x


def _sum(x, dims, keepdims):
    return torch.sum(x, dim=dims, keepdim=keepdims) if dims \
        else torch.sum(x)


def _mean(x, dims, keepdims):
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(default_float())
    return torch.mean(x, dim=dims, keepdim=keepdims) if dims \
        else torch.mean(x)


def _max(x, dims, keepdims):
    return torch.amax(x, dim=dims, keepdim=keepdims) if dims \
        else torch.amax(x)


def _min(x, dims, keepdims):
    return torch.amin(x, dim=dims, keepdim=keepdims) if dims \
        else torch.amin(x)


def _prod(x, dims, keepdims):
    return _reduce_each(torch.prod, x, dims, keepdims) if dims \
        else torch.prod(x)


def _in_ring(tfn):
    """A sum or product of int64 values under an integer ``dtype=``: the
    int64 result wraps to the type as the reduction in it would."""
    return lambda x, dims, keepdims, dt: tfn(x, dims, keepdims)


def _mean_int(x, dims, keepdims, dt):
    """The mean of int64 values as the reference takes it under an
    integer ``dtype=``: their sum, wrapped to ``dt``, divided by the
    count and truncated."""
    n = x.numel() if not dims else math.prod(x.shape[d] for d in dims)
    total = _sum(x, dims, keepdims).to(dt).to(torch.int64)
    return torch.div(total, builtins.max(n, 1), rounding_mode="trunc")


def _mkreduce(tfn, name, has_dtype=True, res=None, int_fn=None):
    """A reduction; ``int_fn`` takes int64 values where an integer or
    bool ``dtype=`` is given: the input is cast to it, reduced in int64
    and the result cast back, so it wraps as the reference's reduction
    in that type does (sum and prod in any integer ring; bool sums and
    products are any and all)."""
    wide = _int64_route(tfn, res)

    def run(x, axis, dt, keepdims):
        fn = wide
        if dt is not None:
            x = x.to(dt)
            if _is_int(dt):
                x, fn = x.to(torch.int64), functools.partial(int_fn, dt=dt)
        dims = _norm_axis(axis)
        if axis is None:
            r = fn(x, None, False)
            r = r.reshape((1,) * x.dim()) if keepdims else r
        elif dims == ():
            r = x
        else:
            r = fn(x, dims, keepdims)
        return r.to(dt) if dt is not None and _is_int(dt) else r

    if has_dtype:
        def f(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
            dt = resolve_dtype(dtype)
            return _unary(lambda x: run(x, axis, dt, keepdims), a, out=out,
                          name=name)
    else:
        def f(a, axis=None, out=None, keepdims=False, **kw):
            return _unary(lambda x: run(x, axis, None, keepdims), a,
                          out=out, name=name)
    f.__name__ = name
    return f


# an unsigned input sums in int64 to uint32 (torch gives int64, which
# would narrow to int32)
sum = _mkreduce(_sum, "sum", res=torch.uint32, int_fn=_in_ring(_sum))
prod = _mkreduce(_prod, "prod", res=torch.uint32, int_fn=_in_ring(_prod))
mean = _mkreduce(_mean, "mean", int_fn=_mean_int)
max = _mkreduce(_max, "max", has_dtype=False)
min = _mkreduce(_min, "min", has_dtype=False)
amax = max
amin = min


def argmax(a, axis=None, out=None):
    return _unary(_bool_route(_int64_route(
        lambda x: torch.argmax(x, dim=axis), torch.int64)), a, out=out,
        name="argmax")


def argmin(a, axis=None, out=None):
    return _unary(_bool_route(_int64_route(
        lambda x: torch.argmin(x, dim=axis), torch.int64)), a, out=out,
        name="argmin")


def _dims(x, axis):
    """``axis`` (None, an int or a sequence) as a tuple of x's dims."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(sorted(int(d) % builtins.max(x.dim(), 1)
                        for d in _norm_axis(axis)))


def _nan_filled(fill):
    def f(x):
        if not x.is_floating_point():
            return x
        return torch.where(torch.isnan(x), torch.as_tensor(
            fill, dtype=x.dtype, device=x.device), x)
    return f


def _nanmean(x, dims, keepdims):
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        x = x.to(default_float())
    return torch.nanmean(x, dim=dims, keepdim=keepdims)


def _nan_extreme(red, fill):
    """nanmax/nanmin: NaN ignored, NaN where a whole slice is NaN."""
    def f(x, dims, keepdims):
        if not x.is_floating_point():
            return red(x, dims, keepdims)
        nan = torch.isnan(x)
        r = red(torch.where(nan, fill, x), dims, keepdims)
        alln = nan.all() if not dims else nan.all(dim=dims,
                                                  keepdim=keepdims)
        return torch.where(alln, torch.nan, r)
    return f


def _logical(red):
    def f(x, dims, keepdims):
        x = x.to(torch.bool)
        return red(x) if not dims else red(x, dim=dims, keepdim=keepdims)
    return f


def _ptp(x, dims, keepdims):
    return _max(x, dims, keepdims) - _min(x, dims, keepdims)


nansum = _mkreduce(lambda x, d, k: _sum(_nan_filled(0)(x), d, k), "nansum",
                   res=torch.uint32, int_fn=_in_ring(_sum))
nanprod = _mkreduce(lambda x, d, k: _prod(_nan_filled(1)(x), d, k),
                    "nanprod", res=torch.uint32, int_fn=_in_ring(_prod))
nanmean = _mkreduce(_nanmean, "nanmean", int_fn=_mean_int)
nanmax = _mkreduce(_nan_extreme(_max, -math.inf), "nanmax", has_dtype=False)
nanmin = _mkreduce(_nan_extreme(_min, math.inf), "nanmin", has_dtype=False)
all = _mkreduce(_logical(torch.all), "all", has_dtype=False)
any = _mkreduce(_logical(torch.any), "any", has_dtype=False)
ptp = _mkreduce(_ptp, "ptp", has_dtype=False)


def _moments(a, axis, dtype, ddof, keepdims, root, name, out=None):
    """var/std as jnp computes them: in float32 for an integer, bool,
    float16 or bfloat16 input (the result in the input's float type, or
    ``dtype``), with ``ddof`` taken off the count."""
    dt = resolve_dtype(dtype)

    def f(x):
        res = dt or _inexact(x.dtype)
        comp = torch.float32 if res in (torch.float16, torch.bfloat16) \
            or not (res.is_floating_point or res.is_complex) else res
        r = torch.var(x.to(comp), dim=_dims(x, axis), correction=ddof,
                      keepdim=keepdims)
        return (torch.sqrt(r) if root else r).to(res)
    return _unary(_int64_route(f), a, out=out, name=name)


def std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    return _moments(a, axis, dtype, ddof, keepdims, True, "std", out)


def var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    return _moments(a, axis, dtype, ddof, keepdims, False, "var", out)


def _nanarg(tfn, fill, axis):
    """nanargmax/nanargmin as jnp: NaN counts as -inf (+inf), a slice of
    NaN only gives -1."""
    plain = _bool_route(_int64_route(lambda v: tfn(v, dim=axis),
                                     torch.int64))

    def f(x):
        if not x.is_floating_point():
            return plain(x)
        nan = torch.isnan(x)
        r = tfn(torch.where(nan, fill, x), dim=axis)
        alln = nan.all() if axis is None else nan.all(dim=axis)
        return torch.where(alln, -1, r)
    return f


def nanargmax(a, axis=None):
    return _unary(_nanarg(torch.argmax, -math.inf, axis), a,
                  name="nanargmax")


def nanargmin(a, axis=None):
    return _unary(_nanarg(torch.argmin, math.inf, axis), a,
                  name="nanargmin")


def _cumulative(tfn, name):
    """cumsum/cumprod: a bool input gives int32, any other its own type
    (uint8 included, unlike ``sum``); integers accumulate in int64 and
    wrap back to the result type, as the reference's do in it."""
    def f(a, axis=None, dtype=None, out=None):
        dt = resolve_dtype(dtype)

        def g(x):
            if axis is None:
                x, ax = x.reshape(-1), 0
            else:
                ax = axis
            res = dt or (torch.int32 if x.dtype == torch.bool else x.dtype)
            if _is_int(res):
                return tfn(x.to(res).to(torch.int64), ax).to(res)
            return tfn(x.to(res), ax)
        return _unary(g, a, out=out, name=name)
    f.__name__ = name
    return f


cumsum = _cumulative(torch.cumsum, "cumsum")
cumprod = _cumulative(torch.cumprod, "cumprod")


_QUANTILE_METHODS = ("linear", "lower", "higher", "midpoint", "nearest")


def _quantile(x, q, axis, method, keepdims, squash_nans):
    """jnp's ``_quantile``: sort along the reduced axes (moved last and
    flattened), gather the floor and ceil of ``q * (n - 1)`` and combine
    them by ``method``; a NaN in a slice gives NaN, or is dropped from
    the count under ``squash_nans``. Result shape ``q.shape`` + the
    reduced shape."""
    if method not in _QUANTILE_METHODS:
        raise ValueError("method can only be 'linear', 'lower', 'higher', "
                         "'midpoint', or 'nearest'")
    x = x.to(_inexact(x.dtype))
    if x.is_complex():
        raise ValueError("quantile does not support complex input")
    nd = x.dim()
    if axis is None:
        keep = [1] * nd
        x = x.reshape(-1)
    else:
        dims = _dims(x, axis)
        keep = [1 if d in dims else s for d, s in enumerate(x.shape)]
        rest = [d for d in range(nd) if d not in dims]
        x = x.permute(rest + list(dims))
        x = x.reshape(*x.shape[:len(rest)], -1)
    if q.dim() > 1:
        raise ValueError(f"q must be have rank <= 1, got shape "
                         f"{tuple(q.shape)}")
    xs = x.shape[:-1]
    qe = q.reshape(q.shape + (1,) * len(xs))
    if squash_nans:
        x = torch.sort(x, dim=-1).values
        counts = (~torch.isnan(x)).sum(-1).to(q.dtype)
        qq = qe * (counts - 1)
        low, high = torch.floor(qq), torch.ceil(qq)
        hw = qq - low
        low = torch.maximum(torch.zeros((), dtype=low.dtype,
                                        device=low.device),
                            torch.minimum(low, counts - 1))
        high = torch.maximum(torch.zeros((), dtype=high.dtype,
                                         device=high.device),
                             torch.minimum(high, counts - 1))
    else:
        x = torch.where(torch.isnan(x).any(-1, keepdim=True), torch.nan, x)
        x = torch.sort(x, dim=-1).values
        n = x.shape[-1]
        qq = qe * (n - 1)
        low, high = torch.floor(qq), torch.ceil(qq)
        hw = qq - low
        low, high = low.clamp(0, n - 1), high.clamp(0, n - 1)
        shape = q.shape + xs
        low, high, hw = (t.expand(shape) for t in (low, high, hw))
    lw = 1 - hw
    lead = q.dim()

    def gather(i):
        xb = x.expand(q.shape + x.shape) if lead else x
        return torch.gather(xb, -1, i.long().unsqueeze(-1)).squeeze(-1)
    lv, hv = gather(low), gather(high)
    if method == "linear":
        r = lv.to(q.dtype) * lw + hv.to(q.dtype) * hw
    elif method == "lower":
        r = lv
    elif method == "higher":
        r = hv
    elif method == "nearest":
        r = torch.where(hw <= 0.5, lv, hv)
    else:
        r = (lv + hv) * 0.5
    if keepdims:
        r = r.reshape(tuple(q.shape) + tuple(keep))
    return r.to(x.dtype)


def _quantile_op(a, q, axis, method, keepdims, name, out=None, scale=1.0,
                 squash=False):
    a, q = _lift(a), _coerce(q)

    def f(x, *qs):
        qt = qs[0] if qs else torch.as_tensor(q, device=x.device)
        if not qt.is_floating_point():
            qt = qt.to(default_float())
        if scale != 1.0:
            qt = qt / scale
        return _quantile(x, qt, axis, method, keepdims, squash)
    args = (a, q) if isinstance(q, NDArray) else (a,)
    return _set_out(out, apply_op(f, *args, name=name))


def median(a, axis=None, out=None, keepdims=False):
    return _quantile_op(a, 0.5, axis, "midpoint", keepdims, "median", out)


def nanmedian(a, axis=None, keepdims=False):
    return _quantile_op(a, 0.5, axis, "midpoint", keepdims, "nanmedian",
                        squash=True)


def quantile(a, q, axis=None, out=None, interpolation="linear",
             keepdims=False):
    return _quantile_op(a, q, axis, interpolation, keepdims, "quantile",
                        out)


def percentile(a, q, axis=None, out=None, interpolation="linear",
               keepdims=False):
    return _quantile_op(a, q, axis, interpolation, keepdims, "percentile",
                        out, scale=100.0)


def average(a, axis=None, weights=None, returned=False):
    a = _coerce(a)
    if weights is None:
        r = mean(a, axis=axis)
        if returned:
            cnt = a.size if axis is None else a.shape[axis]
            return r, full(r.shape, float(cnt), ctx=r.ctx)
        return r
    weights = _coerce(weights)

    def f(x, w):
        dt = _inexact(torch.promote_types(x.dtype, w.dtype))
        x, w = x.to(dt), w.to(dt)
        if axis is None:
            return (x * w).sum() / w.sum()
        ax = axis % x.dim()
        if w.dim() != x.dim():
            w = w.reshape((1,) * ax + (-1,) + (1,) * (x.dim() - ax - 1))
        return (x * w).sum(ax) / w.expand_as(x).sum(ax)
    r = apply_op(f, a, weights, name="average")
    if returned:
        s = sum(weights, axis=axis)
        return r, broadcast_to(s, r.shape) if s.shape != r.shape else s
    return r


def count_nonzero(a, axis=None):
    def f(x):
        x = x.to(torch.bool)
        return x.sum() if axis is None else x.sum(dim=_dims(x, axis))
    return _unary(f, a, name="count_nonzero")


def bincount(x, weights=None, minlength=0):
    """The length (the largest value + 1, at least ``minlength``) is read
    on the host, the one sync, as the reference does; the counts are a
    scatter-add on the device."""
    x = _coerce(x)
    n = int(x.max().item()) + 1 if x.size else 0
    length = builtins.max(n, minlength)

    def f(v, *w):
        idx = v.reshape(-1).to(torch.int64)
        src = w[0].reshape(-1) if w else torch.ones_like(idx)
        return torch.zeros(length, dtype=src.dtype, device=v.device) \
            .index_add(0, idx, src)
    if weights is None:
        return apply_op(f, x, name="bincount")
    return apply_op(f, x, _coerce(weights), name="bincount")


def _linspace(lo, hi, num):
    """numpy's ``linspace(lo, hi, num)`` in the type of the 0-d tensors
    ``lo`` and ``hi`` (``arange * step + start``, the last point set to
    ``hi``)."""
    div = num - 1
    step = (hi - lo) / div
    y = torch.arange(num, dtype=lo.dtype, device=lo.device) * step + lo
    y[-1] = hi
    return y


def histogram(a, bins=10, range=None, weights=None, density=None):
    """numpy's histogram on the device: uniform edges from ``range`` (or
    the data's min and max, widened by 0.5 when they agree) in float64,
    or the given edges; a value's bin by ``searchsorted`` of the edges
    (right), the last bin closed, as numpy bins. Counts are int32 (the
    reference's int64, narrowed), float32 under weights or density.
    The edges take numpy's type, as the reference keeps it: a float16
    input's edges are float16 (and bin as such), others float32; given
    edges keep their own type."""
    a = _lift(a)
    x = a._data.detach().reshape(-1).to(torch.float64)
    dev = x.device
    if isinstance(bins, (int, onp.integer)):
        if range is not None:
            lo = torch.as_tensor(float(range[0]), dtype=torch.float64,
                                 device=dev)
            hi = torch.as_tensor(float(range[1]), dtype=torch.float64,
                                 device=dev)
        elif x.numel():
            lo, hi = x.min(), x.max()
        else:
            lo = torch.zeros((), dtype=torch.float64, device=dev)
            hi = torch.ones((), dtype=torch.float64, device=dev)
        edt = torch.float16 if a._data.dtype == torch.float16 \
            else torch.float32
        if edt == torch.float16 and range is None:
            # numpy computes edges taken from float16 data in float16
            lo, hi = lo.to(edt), hi.to(edt)
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                              hi)
        edges = _linspace(lo, hi, int(bins) + 1)
        # a value bins by the edges of the type they are returned in
        edges = (edges.to(edt) if edt == torch.float16 else edges).to(
            torch.float64)
    else:
        b = bins._data if isinstance(bins, NDArray) else torch.as_tensor(
            onp.asarray(bins))
        edt = NARROW64.get(b.dtype, b.dtype)
        edges = b.to(device=dev, dtype=torch.float64)
    nb = edges.shape[0] - 1
    w = None
    if weights is not None:
        w = _coerce(weights)._data.detach().reshape(-1)
    keep = (x >= edges[0]) & (x <= edges[-1])
    idx = (torch.searchsorted(edges, x, right=True) - 1).clamp(0, nb - 1)
    src = (w if w is not None else torch.ones_like(idx)) * keep
    hist = torch.zeros(nb, dtype=src.dtype, device=dev).index_add(0, idx,
                                                                  src)
    if density:
        hist = hist.to(torch.float64) / (hist.sum() * torch.diff(edges))
    return _new(hist.to(NARROW64.get(hist.dtype, hist.dtype)), a._ctx), \
        _new(edges.to(edt), a._ctx)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
def reshape(a, newshape, order="C"):
    newshape = _shape(newshape)
    return _unary(lambda x: torch.reshape(x, newshape), a, name="reshape")


def transpose(a, axes=None):
    def f(x):
        ax = tuple(range(x.dim() - 1, -1, -1)) if axes is None \
            else tuple(axes)
        return x.permute(ax)
    return _unary(f, a, name="transpose")


def expand_dims(a, axis):
    def f(x):
        ax = (axis,) if isinstance(axis, int) else tuple(axis)
        n = x.dim() + len(ax)
        for d in sorted(d % n for d in ax):
            x = x.unsqueeze(d)
        return x
    return _unary(f, a, name="expand_dims")


def squeeze(a, axis=None):
    def f(x):
        if axis is None:
            return torch.squeeze(x)
        ax = tuple(d % x.dim() for d in _norm_axis(axis))
        if builtins.any(x.shape[d] != 1 for d in ax):
            raise ValueError("cannot select an axis to squeeze out which "
                             "has size not equal to one")
        return x.squeeze(ax)
    return _unary(f, a, name="squeeze")


def ravel(a, order="C"):
    return reshape(a, (-1,))


def broadcast_to(array_, shape):
    shape = _shape(shape)
    return _unary(lambda x: torch.broadcast_to(x, shape), array_,
                  name="broadcast_to")


def _joined(join, res):
    """``join`` (cat or stack) of tensors cast to ``res`` first, when
    one of them is a wide unsigned type (``_promoted``); a wide unsigned
    result is joined as the signed type of its width, bit for bit."""
    if res is None:
        return join
    sv = _SIGNED_VIEW.get(res, res)
    return lambda xs: join([x.to(res).view(sv) for x in xs]).view(res)


def concatenate(seq, axis=0, out=None):
    arrs = [_coerce(a) for a in seq]
    if axis is None:
        cat = _joined(lambda xs: torch.cat([x.reshape(-1) for x in xs]),
                      _promoted(arrs))
    else:
        cat = _joined(lambda xs: torch.cat(xs, dim=axis), _promoted(arrs))
    r = apply_op(lambda *xs: cat(xs), *arrs, name="concatenate")
    return _set_out(out, r)


concat = concatenate


def stack(arrays, axis=0, out=None):
    arrs = [_coerce(a) for a in arrays]
    join = _joined(lambda xs: torch.stack(xs, dim=axis), _promoted(arrs))
    r = apply_op(lambda *xs: join(xs), *arrs, name="stack")
    return _set_out(out, r)


def split(ary, indices_or_sections, axis=0):
    ary = _coerce(ary)
    ios = indices_or_sections
    if isinstance(ios, NDArray):
        ios = [int(i) for i in ios.asnumpy()]
    if isinstance(ios, (list, tuple)):
        ios = [int(i) for i in ios]
        nout = len(ios) + 1
    else:
        nout = int(ios)
        if ary.shape[axis] % nout:
            raise ValueError(
                "array split does not result in an equal division")
    outs = apply_op(lambda x: tuple(torch.tensor_split(x, ios, dim=axis)),
                    ary, nout=nout, name="split")
    return list(outs) if isinstance(outs, tuple) else [outs]


def tile(A, reps):
    reps = _shape(reps)
    return _unary(lambda x: torch.tile(x, reps), A, name="tile")


def flip(m, axis=None):
    def f(x):
        dims = tuple(range(x.dim())) if axis is None else _norm_axis(axis)
        return torch.flip(x, dims)
    return _unary(_signed_view(f), m, name="flip")


def permute_dims(a, axes=None):
    return transpose(a, axes)


def swapaxes(a, axis1, axis2):
    return _unary(lambda x: torch.swapaxes(x, axis1, axis2), a,
                  name="swapaxes")


def moveaxis(a, source, destination):
    return _unary(lambda x: torch.movedim(x, source, destination), a,
                  name="moveaxis")


def rollaxis(a, axis, start=0):
    def f(x):
        n = x.dim()
        ax, st = axis % n, start + n if start < 0 else start
        if ax < st:
            st -= 1
        return torch.movedim(x, ax, st) if ax != st else x
    return _unary(f, a, name="rollaxis")


def _atleast(x, nd):
    if x.dim() >= nd:
        return x
    if nd == 1 or x.dim() == 0:
        return x.reshape((1,) * nd)
    if nd == 2:
        return x[None]
    return x[None, :, None] if x.dim() == 1 else x[..., None]


def _mkatleast(nd, name):
    def f(*arys):
        res = [_unary(lambda x: _atleast(x, nd), a, name=name) for a in arys]
        return res[0] if len(res) == 1 else res
    f.__name__ = name
    return f


atleast_1d = _mkatleast(1, "atleast_1d")
atleast_2d = _mkatleast(2, "atleast_2d")
atleast_3d = _mkatleast(3, "atleast_3d")


def broadcast_arrays(*args):
    arrs = [_lift(a) for a in args]
    outs = apply_op(lambda *xs: tuple(torch.broadcast_tensors(*xs)), *arrs,
                    nout=len(arrs), name="broadcast_arrays")
    return list(outs) if isinstance(outs, tuple) else [outs]


def _mkstack(prep, axis_of, name):
    """vstack/hstack/dstack/column_stack: each array shaped by ``prep``,
    then concatenated along ``axis_of`` (of the first prepared one)."""
    def f(tup):
        arrs = [_coerce(a) for a in tup]
        arrs = [array(a) if not isinstance(a, NDArray) else a for a in arrs]
        cat = _joined(lambda xs: torch.cat(
            [prep(x) for x in xs], dim=axis_of(prep(xs[0]))),
            _promoted(arrs))
        return apply_op(lambda *xs: cat(xs), *arrs, name=name)
    f.__name__ = name
    return f


vstack = _mkstack(lambda x: _atleast(x, 2), lambda x: 0, "vstack")
row_stack = vstack
hstack = _mkstack(lambda x: _atleast(x, 1),
                  lambda x: 0 if x.dim() == 1 else 1, "hstack")
dstack = _mkstack(lambda x: _atleast(x, 3), lambda x: 2, "dstack")
column_stack = _mkstack(
    lambda x: x.reshape(-1, 1) if x.dim() < 2 else x, lambda x: 1,
    "column_stack")


def array_split(ary, indices_or_sections, axis=0):
    ary = _coerce(ary)
    ios = indices_or_sections
    if isinstance(ios, (int, onp.integer)):
        n, k = ary.shape[axis], int(ios)
        sizes = [n // k + (1 if i < n % k else 0) for i in builtins.range(k)]
        ios = list(itertools.accumulate(sizes[:-1]))
    return split(ary, ios, axis)


def hsplit(ary, indices_or_sections):
    ary = _coerce(ary)
    return split(ary, indices_or_sections, 0 if ary.ndim == 1 else 1)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 2)


def repeat(a, repeats, axis=None):
    if isinstance(repeats, NDArray):
        repeats = repeats.asnumpy()
    reps = onp.asarray(repeats).astype(onp.int64)

    def f(x):
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis
        r = int(reps.ravel()[0]) if reps.size == 1 \
            else torch.as_tensor(reps, device=x.device)
        return torch.repeat_interleave(x, r, dim=ax)
    return _unary(_signed_view(f), a, name="repeat")


def fliplr(m):
    return flip(m, 1)


def flipud(m):
    return flip(m, 0)


def rot90(m, k=1, axes=(0, 1)):
    return _unary(_signed_view(lambda x: torch.rot90(x, k, list(axes))), m,
                  name="rot90")


def roll(a, shift, axis=None):
    def f(x):
        if axis is None:
            return torch.roll(x.reshape(-1), shift).reshape(x.shape)
        return torch.roll(x, shift, axis)
    return _unary(_signed_view(f), a, name="roll")


def _pairs(x, nd):
    """numpy's ``_as_pairs``: a scalar, a (before, after) pair or one
    pair per axis, as ``nd`` (before, after) tuples of Python numbers."""
    arr = onp.asarray(x)
    if arr.size == 1:
        v = arr.ravel()[0].item()
        return ((v, v),) * nd
    if arr.size == 2 and arr.shape != (2, 1):
        v = arr.ravel()
        return ((v[0].item(), v[1].item()),) * nd
    return tuple((p[0].item(), p[1].item())
                 for p in onp.broadcast_to(arr, (nd, 2)))


def _cut(x, d, start, stop):
    return x.narrow(d, start, stop - start)


def _pad_reflect(x, d, before, after, mode, reflect_type):
    """jnp's ``_pad_symmetric_or_reflect`` along ``d``: chunks of at most
    the axis size (less one for reflect) mirrored from the current
    edge, repeated until the pad is filled; ``odd`` subtracts the mirror
    from twice the edge."""
    n = x.shape[d]
    if n == 0:
        return x
    offset = 1 if mode == "reflect" and n > 1 else 0
    for side, padding in ((True, before), (False, after)):
        edge = _cut(x, d, 0, 1) if side else _cut(x, d, x.shape[d] - 1,
                                                  x.shape[d])
        while padding > 0:
            cur = builtins.min(padding, n - offset)
            padding -= cur
            m = x.shape[d]
            if side:
                chunk = _cut(x, d, offset, offset + cur)
            else:
                stop = m if mode == "symmetric" or n == 1 else m - 1
                chunk = _cut(x, d, stop - cur, stop)
            chunk = chunk.flip(d)
            if reflect_type == "odd":
                chunk = 2 * edge - chunk
                if n > 1:
                    edge = _cut(chunk, d, 0, 1) if side else \
                        _cut(chunk, d, chunk.shape[d] - 1, chunk.shape[d])
            x = torch.cat([chunk, x] if side else [x, chunk], d)
    return x


def _pad_ramp(x, d, before, after, ends):
    """jnp's ``_pad_linear_ramp`` along ``d``: ``linspace(end, edge,
    num, endpoint=False)`` on each side as jnp computes it, ``end * (1 -
    t) + edge * t`` with ``t = i / num`` in x's inexact type (floored
    for an integer type)."""
    cd = _inexact(x.dtype)

    def ramp(end, edge, num):
        shape = [1] * x.dim()
        shape[d] = num
        t = (torch.arange(num, dtype=torch.float32, device=x.device)
             / num).to(cd).reshape(shape)
        start = torch.as_tensor(end, device=x.device).to(cd)
        r = start * (1 - t) + edge.to(cd) * t
        if _is_int(x.dtype):
            r = torch.floor(r)
        return r.to(x.dtype)
    n = x.shape[d]
    lo = ramp(ends[0], _cut(x, d, 0, 1), before)
    hi = ramp(ends[1], _cut(x, d, n - 1, n), after).flip(d)
    return torch.cat([lo, x, hi], d)


def _pad_stat(x, d, before, after, stat, length):
    n = x.shape[d]
    if length is None:
        sb = sa = stat(x, d)
    else:
        lb, la = builtins.min(length[0], n), builtins.min(length[1], n)
        if length[0] == 0 or length[1] == 0:
            raise ValueError("stat_length of 0 yields no value for padding")
        sb, sa = stat(_cut(x, d, 0, lb), d), stat(_cut(x, d, n - la, n), d)
    if _is_int(x.dtype):
        sb, sa = torch.round(sb), torch.round(sa)
    sb, sa = sb.to(x.dtype), sa.to(x.dtype)
    return torch.cat([sb.repeat_interleave(before, d), x,
                      sa.repeat_interleave(after, d)], d)


def _stat_median(x, d):
    return _quantile(x, torch.tensor(0.5, device=x.device), (d,),
                     "midpoint", True, False)


_PAD_STATS = {
    "maximum": lambda x, d: torch.amax(x, d, keepdim=True),
    "minimum": lambda x, d: torch.amin(x, d, keepdim=True),
    "mean": lambda x, d: torch.mean(x.to(_inexact(x.dtype)), d,
                                    keepdim=True),
    "median": _stat_median,
}


def pad(array_, pad_width, mode="constant", **kwargs):
    """numpy's pad in every mode jnp takes (constant, edge, wrap,
    reflect and symmetric with ``reflect_type``, linear_ramp, maximum,
    minimum, mean, median with ``stat_length``, empty), one axis after
    another as jnp does, so corners take the later axis's values."""
    cvals = kwargs.get("constant_values", 0)
    stat_length = kwargs.get("stat_length")
    end_values = kwargs.get("end_values", 0)
    reflect_type = kwargs.get("reflect_type", "even")

    def f(x):
        nd = x.dim()
        if nd == 0:
            return x
        widths = _pairs(pad_width, nd)
        if builtins.any(w < 0 for p in widths for w in p):
            raise ValueError("index can't contain negative values")
        consts = _pairs(cvals, nd) if mode == "constant" else None
        ends = _pairs(end_values, nd) if mode == "linear_ramp" else None
        lengths = (_pairs(stat_length, nd) if stat_length is not None
                   else (None,) * nd)
        for d, (b, a) in enumerate(widths):
            b, a = int(b), int(a)
            n = x.shape[d]
            if mode in ("constant", "empty"):
                cb, ca = consts[d] if consts else (0, 0)
                shp = list(x.shape)

                def block(v, w):
                    shp[d] = w
                    return torch.as_tensor(v, device=x.device).to(
                        x.dtype).expand(shp)
                x = torch.cat([block(cb, b), x, block(ca, a)], d)
            elif mode in ("edge", "wrap"):
                if (b or a) and n == 0:
                    raise ValueError(f"can't extend empty axis {d} using "
                                     f"modes other than 'constant' or "
                                     f"'empty'")
                i = torch.arange(-b, n + a, device=x.device)
                i = i.clamp(0, n - 1) if mode == "edge" else i.remainder(n)
                x = x.index_select(d, i)
            elif mode in ("reflect", "symmetric"):
                if b or a:
                    x = _pad_reflect(x, d, b, a, mode, reflect_type)
            elif mode == "linear_ramp":
                x = _pad_ramp(x, d, b, a, ends[d])
            elif mode in _PAD_STATS:
                x = _pad_stat(x, d, b, a, _PAD_STATS[mode], lengths[d])
            else:
                raise ValueError(f"mode {mode!r} is not supported")
        return x
    return _unary(_int64_route(f), array_, name="pad")


def append(arr, values, axis=None):
    def join(xs):
        if axis is None:
            return torch.cat([x.reshape(-1) for x in xs])
        return torch.cat(xs, dim=axis)
    arrs = [_coerce(arr), _coerce(values)]
    if _is_scalar(arrs[1]):
        # a Python scalar is weak: it takes the array's type
        weak = torch.result_type(arrs[0]._data, arrs[1])
        arrs[1] = array(arrs[1], dtype=weak, ctx=arrs[0].ctx)
    res = _promoted(arrs) or torch.promote_types(arrs[0]._data.dtype,
                                                 arrs[1]._data.dtype)
    j = _joined(join, res)
    return apply_op(lambda *xs: j(xs), *arrs, name="append")


def _index_list(obj, n):
    """``obj`` (an int, a slice, a sequence or an NDArray) as a list of
    Python ints (a slice over an axis of ``n``)."""
    if isinstance(obj, slice):
        return list(builtins.range(*obj.indices(n)))
    if isinstance(obj, NDArray):
        obj = obj.asnumpy()
    return onp.asarray(obj).astype(onp.int64).tolist()


def insert(arr, obj, values, axis=None):
    """jnp.insert: ``values`` (cast to the array's type) placed before the
    indices ``obj`` along ``axis`` (the flattened array when None); a
    scalar index inserts a block, a sequence one slice per index."""
    arr, values = _coerce(arr), _coerce(values)
    scalar_obj = isinstance(obj, (int, onp.integer))
    idx_host = obj if scalar_obj else None

    def f(x, *v):
        ax = axis
        if ax is None:
            x, ax = x.reshape(-1), 0
        ax %= x.dim()
        n = x.shape[ax]
        vals = v[0] if v else torch.as_tensor(values, device=x.device)
        vals = vals.to(x.dtype)
        while vals.dim() < x.dim():
            vals = vals[None]
        if scalar_obj:
            index = [int(idx_host)]
            vals = torch.movedim(vals, 0, ax)
        else:
            index = _index_list(obj, n)
        if len(index) == 1:
            index = index * vals.shape[ax]
        n_ins = len(index)
        ind = torch.as_tensor(index, dtype=torch.int64, device=x.device)
        ind = torch.where(ind < 0, ind + n, ind).clamp(0, n)
        order = torch.argsort(ind, stable=True)
        vind = ind.clone()
        vind[order] = ind[order] + torch.arange(n_ins, device=x.device)
        mask = torch.ones(n + n_ins, dtype=torch.bool, device=x.device)
        mask[vind] = False
        aind = torch.arange(n + n_ins, device=x.device)[mask]
        shape = list(x.shape)
        shape[ax] = n_ins
        vals = vals.expand(shape) if vals.shape[ax] in (1, n_ins) \
            else vals
        out_shape = list(x.shape)
        out_shape[ax] += n_ins
        out = torch.zeros(out_shape, dtype=x.dtype, device=x.device)
        pre = (slice(None),) * ax
        out[pre + (vind,)] = vals
        out[pre + (aind,)] = x
        return out
    fn = _int64_route(f)
    if isinstance(values, NDArray):
        return apply_op(fn, arr, values, name="insert")
    return _unary(fn, arr, name="insert")


def delete(arr, obj, axis=None):
    arr = _coerce(arr)

    def f(x):
        ax = axis
        if ax is None:
            x, ax = x.reshape(-1), 0
        n = x.shape[ax]
        o = obj.asnumpy() if isinstance(obj, NDArray) else obj
        if not isinstance(o, slice) and onp.asarray(o).dtype == onp.bool_:
            keep = torch.as_tensor(~onp.asarray(o))
        else:
            keep = torch.ones(n, dtype=torch.bool)
            keep[torch.as_tensor(_index_list(o, n), dtype=torch.int64)] = \
                False
        sel = torch.nonzero(keep).reshape(-1).to(x.device)
        return x.index_select(ax, sel)
    return _unary(_signed_view(f), arr, name="delete")


def trim_zeros(filt, trim="fb"):
    filt = _coerce(filt)
    x = filt._data
    nz = (x != 0) if x.dtype not in _WIDE_UNSIGNED \
        else (x.to(torch.int64) != 0)
    n = x.shape[0]
    pos = torch.arange(n, device=x.device)
    first = torch.where(nz, pos, n).amin() if n else torch.tensor(0)
    last = torch.where(nz, pos + 1, 0).amax() if n else torch.tensor(0)
    lo, hi = torch.stack([first, last]).tolist()     # the one sync
    trim = trim.lower()
    lo = lo if "f" in trim else 0
    hi = hi if "b" in trim else n
    return _unary(lambda v: v[lo:builtins.max(lo, hi)], filt,
                  name="trim_zeros")


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    """On the device: ``torch.unique`` (sorted; one sync for the result's
    size), the first index of each value as the least position that
    maps to it, an inverse and counts as numpy gives them (int32)."""
    ar = _coerce(ar)
    x = ar._data.detach()
    src = x.dtype
    if src in _WIDE_UNSIGNED:
        x = x.to(torch.int64)
    elif src == torch.bool:
        x = x.to(torch.uint8)
    if axis is None:
        flat = x.reshape(-1)
        vals, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                                      return_counts=True)
        n = flat.shape[0]
    else:
        ax = axis % x.dim()
        vals, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                      return_counts=True, dim=ax)
        n = x.shape[ax]
    ctx = ar._ctx
    outs = [_new(vals.to(src), ctx)]
    if return_index:
        first = torch.full((cnt.shape[0],), n, dtype=torch.int64,
                           device=x.device)
        first = first.scatter_reduce(0, inv.reshape(-1), torch.arange(
            n, device=x.device), reduce="amin")
        outs.append(_new(first.to(torch.int32), ctx))
    if return_inverse:
        # over the flattened array, the input's shape, as NumPy 2 gives it
        outs.append(_new((inv.reshape(x.shape) if axis is None else inv)
                         .to(torch.int32), ctx))
    if return_counts:
        outs.append(_new(cnt.to(torch.int32), ctx))
    return tuple(outs) if len(outs) > 1 else outs[0]


def resize(a, new_shape):
    shp = _shape(new_shape)

    def f(x):
        total = math.prod(shp)
        flat = x.reshape(-1)
        if flat.numel() == 0:
            return torch.zeros(shp, dtype=x.dtype, device=x.device)
        idx = torch.arange(total, device=x.device) % flat.numel()
        return flat[idx].reshape(shp)
    return _unary(_signed_view(f), a, name="resize")


# ---------------------------------------------------------------------------
# sorting / searching / indexing
# ---------------------------------------------------------------------------
def _ordered(x):
    """x as a type torch orders on the CPU and the card alike: uint16/32
    as int64, bool as uint8 (the order is the same)."""
    if x.dtype in _WIDE_UNSIGNED:
        return x.to(torch.int64)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _sorted(x, axis, descending=False):
    """Stable sort of x along ``axis`` (the flattened x when None), as
    jnp's sort is; returns (values in x's type, int64 indices)."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    v, i = torch.sort(_ordered(x), dim=axis, descending=descending,
                      stable=True)
    return v.to(x.dtype), i


def sort(a, axis=-1, kind=None, order=None):
    return _unary(lambda x: _sorted(x, axis)[0], a, name="sort")


def argsort(a, axis=-1, kind=None, order=None):
    return _unary(lambda x: _sorted(x, axis)[1], a, name="argsort")


def msort(a):
    """Sorted copy along the first axis (legacy alias for sort(a, axis=0))."""
    return sort(a, axis=0)


def lexsort(keys, axis=-1):
    """Indices sorting by the last key, then the one before, ...: one
    stable argsort per key, from the first key to the last."""
    arrs = [_coerce(k) for k in keys]

    def f(*ks):
        idx = None
        for k in ks:
            k = _ordered(k)
            if idx is not None:
                k = torch.take_along_dim(k, idx, dim=axis)
            i = torch.sort(k, dim=axis, stable=True).indices
            idx = i if idx is None else torch.take_along_dim(idx, i,
                                                             dim=axis)
        return idx
    return apply_op(f, *arrs, name="lexsort")


def _partition(x, kth, axis):
    """jnp.partition's layout: the kth + 1 smallest ascending, then the
    rest largest first."""
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    lo = _sorted(xm, -1)[0][..., :kth + 1]
    hi = _sorted(xm, -1, descending=True)[0][..., :n - kth - 1]
    return torch.movedim(torch.cat([lo, hi], -1), -1, axis)


def _argpartition(x, kth, axis):
    """jnp.argpartition: the indices of the kth + 1 smallest (ties by
    lower index), then the other indices in increasing order."""
    xm = _ordered(torch.movedim(x, axis, -1))
    n = xm.shape[-1]
    lo = torch.sort(xm, dim=-1, stable=True).indices[..., :kth + 1]
    rest = torch.ones(xm.shape, dtype=torch.uint8, device=xm.device) \
        .scatter(-1, lo, 0)
    hi = torch.sort(rest, dim=-1, descending=True,
                    stable=True).indices[..., :n - kth - 1]
    return torch.movedim(torch.cat([lo, hi], -1), -1, axis)


def partition(a, kth, axis=-1):
    return _unary(lambda x: _partition(x, int(kth), axis), a,
                  name="partition")


def argpartition(a, kth, axis=-1):
    return _unary(lambda x: _argpartition(x, int(kth), axis), a,
                  name="argpartition")


def _searchsorted(side):
    def f(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        xo, yo = _ordered(x.to(dt)), _ordered(y.to(dt))
        r = torch.searchsorted(xo.contiguous(), yo.reshape(-1).contiguous(),
                               right=side == "right")
        return r.reshape(y.shape)
    return f


def searchsorted(a, v, side="left", sorter=None):
    a, v = _coerce(a), _coerce(v)
    if sorter is not None:
        a = take(a, sorter)
    fn = _searchsorted(side)
    if isinstance(v, NDArray):
        return apply_op(fn, a, v, name="searchsorted")
    return apply_op(lambda x: fn(x, torch.as_tensor(v, device=x.device)), a,
                    name="searchsorted")


def _nonzero_rows(x):
    """The coordinates of x's nonzero elements, (n, x.dim()) int64: one
    sync with the host for n."""
    return torch.nonzero(_ordered(x) if x.dtype in _WIDE_UNSIGNED else x)


def nonzero(a):
    a = _coerce(a)
    rows = _nonzero_rows(a._data.detach())
    return tuple(_new(c.to(torch.int32), a._ctx) for c in rows.unbind(1))


def flatnonzero(a):
    a = _coerce(a)
    rows = _nonzero_rows(a._data.detach().reshape(-1))
    return _new(rows.reshape(-1).to(torch.int32), a._ctx)


def argwhere(a):
    a = _coerce(a)
    return _new(_nonzero_rows(a._data.detach()).to(torch.int32), a._ctx)


def _index_tensor(i, device):
    if not torch.is_tensor(i):
        i = torch.as_tensor(onp.asarray(i))
    if i.is_floating_point():
        i = i.to(torch.int64)
    return i.to(device=device, dtype=torch.int64)


def take(a, indices, axis=None, mode="clip", out=None):
    """jnp.take: ``clip`` clamps an index into [0, n - 1] (a negative one
    to 0), ``wrap`` takes it modulo n; ``raise`` is refused, as in the
    reference."""
    a = _coerce(a)
    if mode == "raise":
        raise NotImplementedError(
            "take with mode='raise' is not supported on accelerators; "
            "use mode='clip' or mode='wrap'")

    @_signed_view
    def f(x, *ii):
        i = _index_tensor(ii[0] if ii else indices, x.device)
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis % x.dim()
        n = x.shape[ax]
        i = i.remainder(n) if mode == "wrap" else i.clamp(0, n - 1)
        r = x.index_select(ax, i.reshape(-1))
        return r.reshape(x.shape[:ax] + i.shape + x.shape[ax + 1:])
    if isinstance(indices, NDArray):
        r = apply_op(f, a, indices, name="take")
    else:
        r = _unary(f, a, name="take")
    return _set_out(out, r)


def take_along_axis(arr, indices, axis):
    @_signed_view
    def f(x, i):
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis % x.dim()
        i = _index_tensor(i, x.device)
        i = torch.where(i < 0, i + x.shape[ax], i)
        return torch.take_along_dim(x, i, dim=ax)
    return apply_op(f, _coerce(arr), _coerce(indices),
                    name="take_along_axis")


def put_along_axis(arr, indices, values, axis):
    """Write ``values`` at ``indices`` along ``axis`` into ``arr`` (a new
    tensor installed in it, as every write of the port)."""
    def f(x, i, *v):
        ax = axis % x.dim()
        i = _index_tensor(i, x.device)
        i = torch.where(i < 0, i + x.shape[ax], i)
        shape = list(torch.broadcast_shapes(
            tuple(s for d, s in enumerate(x.shape) if d != ax),
            tuple(s for d, s in enumerate(i.shape) if d != ax)))
        shape.insert(ax, i.shape[ax])
        i = i.expand(shape)
        vals = (v[0] if v else torch.as_tensor(values, device=x.device)) \
            .to(x.dtype).expand(shape)
        sv = _SIGNED_VIEW.get(x.dtype)
        if sv is not None:
            return x.view(sv).scatter(ax, i, vals.view(sv)).view(x.dtype)
        return x.scatter(ax, i, vals)
    args = [arr, _coerce(indices)]
    if isinstance(values, NDArray):
        args.append(values)
    arr._inplace(apply_op(f, *args, name="put_along_axis"))
    return None


def compress(condition, a, axis=None):
    cond = _coerce(condition)

    def f(x, *c):
        cv = (c[0] if c else torch.as_tensor(onp.asarray(cond),
                                             device=x.device))
        cv = cv.reshape(-1).to(torch.bool)
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis
        sel = torch.nonzero(cv[:x.shape[ax]]).reshape(-1)
        return x.index_select(ax, sel)
    a = _coerce(a)
    if isinstance(cond, NDArray):
        return apply_op(_signed_view(f), a, cond, name="compress")
    return _unary(_signed_view(f), a, name="compress")


def extract(condition, arr):
    return compress(ravel(_coerce(condition)) != 0, ravel(arr))


def tril_indices_from(arr, k=0):
    return tril_indices(arr.shape[-2], k=k, m=arr.shape[-1], ctx=arr.ctx)


def may_share_memory(a, b, max_work=None):
    """False, as in the reference: the port's writes install new
    tensors, so no write to one array shows through another."""
    return False


def shares_memory(a, b, max_work=None):
    return False


def ndim(a):
    a = _coerce(a)
    return a.ndim if isinstance(a, NDArray) else onp.ndim(a)


def shape(a):
    a = _coerce(a)
    return a.shape if isinstance(a, NDArray) else onp.shape(a)


def size(a, axis=None):
    a = _coerce(a)
    if not isinstance(a, NDArray):
        return onp.size(a, axis)
    return a.size if axis is None else a.shape[axis]


# ---------------------------------------------------------------------------
# linear algebra (top-level)
# ---------------------------------------------------------------------------
#: int64 elements of one partial product in ``_exact_matmul``
_EXACT_CHUNK = 1 << 22


def _exact_matmul(x, y):
    """``torch.matmul`` of int64 operands (1-d ones promoted as matmul
    does) as a sum of int64 products over chunks of the contracted
    axis: exact, and on the card as on the CPU (the card has no integer
    matrix product)."""
    vx, vy = x.dim() == 1, y.dim() == 1
    x = x[None] if vx else x
    y = y[:, None] if vy else y
    k = x.shape[-1]
    if y.shape[-2] != k:
        raise ValueError(f"matmul: contracted axes differ, shapes "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    rows = builtins.max(1, x[..., 0].numel() * y.shape[-1])
    step = builtins.max(1, _EXACT_CHUNK // rows)
    r = None
    for k0 in range(0, builtins.max(k, 1), step):
        part = (x[..., :, k0:k0 + step, None]
                * y[..., None, k0:k0 + step, :]).sum(-2)
        r = part if r is None else r + part
    r = r.squeeze(-1) if vy else r
    return r.squeeze(-1 if vy else -2) if vx else r


def _matmul(a, b):
    """``a @ b`` in the operands' promoted type (JAX's table: int32 with
    float16 gives float16, uint8 with int8 int16, bool with x x's type).
    Integer and bool operands take the exact int64 route, cast back to
    the promoted type: an integer wraps as the reference's does, and a
    bool result is whether any product was true."""
    res = torch.promote_types(a.dtype, b.dtype)
    if res.is_floating_point or res.is_complex:
        return torch.matmul(a.to(res), b.to(res))
    return _exact_matmul(a.to(torch.int64), b.to(torch.int64)).to(res)


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or (a.dim() <= 2 and b.dim() <= 2):
        return _matmul(a, b)
    # the sum over a's last axis and b's second-to-last (tensordot), as a
    # matmul against b with that axis in front
    r = _matmul(a, b.movedim(-2, 0).reshape(b.shape[-2], -1))
    return r.reshape(*a.shape[:-1], *b.shape[:-2], b.shape[-1])


def dot(a, b, out=None):
    return _binary(_dot, a, b, out=out, name="dot")


def matmul(a, b, out=None):
    return _binary(_matmul, a, b, out=out, name="matmul")


def vdot(a, b):
    return _binary(lambda x, y: _matmul(_conj(x).reshape(-1), y.reshape(-1)),
                   a, b, name="vdot")


def _axes_list(ax, nd):
    ax = [ax] if isinstance(ax, (int, onp.integer)) else list(ax)
    return [int(d) % builtins.max(nd, 1) for d in ax]


def _tensordot(x, y, axes):
    """The sum over ``axes`` as one matrix product of the operands
    permuted and flattened (``_matmul``: the exact route for integers)."""
    if isinstance(axes, (int, onp.integer)):
        ax_a = list(builtins.range(x.dim() - int(axes), x.dim()))
        ax_b = list(builtins.range(int(axes)))
    else:
        ax_a, ax_b = _axes_list(axes[0], x.dim()), _axes_list(axes[1],
                                                              y.dim())
    free_a = [d for d in builtins.range(x.dim()) if d not in ax_a]
    free_b = [d for d in builtins.range(y.dim()) if d not in ax_b]
    k = math.prod(x.shape[d] for d in ax_a)
    xa = x.permute(free_a + ax_a).reshape(-1, k)
    yb = y.permute(ax_b + free_b).reshape(k, -1)
    return _matmul(xa, yb).reshape([x.shape[d] for d in free_a]
                                   + [y.shape[d] for d in free_b])


def inner(a, b):
    def f(x, y):
        if x.dim() == 0 or y.dim() == 0:
            return x * y
        return _tensordot(x, y, ([-1], [-1]))
    return _binary(f, a, b, name="inner")


def _weak_cast(tfn, a, b):
    """``tfn`` of two operands cast to the reference's result type of
    ``a`` and ``b``, where a Python scalar is weak (``int8 array, 2``
    stays int8, ``float16 array, 0.5`` float16); a uint16/32 result
    computes in int64, which ``_binary``'s wide route casts back."""
    rt = to_torch_dtype(result_type(_coerce(a), _coerce(b)))
    rt = torch.int64 if rt in _WIDE_UNSIGNED else rt
    return lambda x, y: tfn(x.to(rt), y.to(rt))


def outer(a, b):
    return _binary(_weak_cast(
        lambda x, y: x.reshape(-1)[:, None] * y.reshape(-1)[None], a, b),
        a, b, name="outer")


def tensordot(a, b, axes=2):
    return _binary(lambda x, y: _tensordot(x, y, axes), a, b,
                   name="tensordot")


def kron(a, b):
    return _binary(_weak_cast(torch.kron, a, b), a, b, name="kron")


def _cross(axisa, axisb, axisc):
    def f(x, y):
        x, y = torch.movedim(x, axisa, -1), torch.movedim(y, axisb, -1)
        if x.shape[-1] not in (2, 3) or y.shape[-1] not in (2, 3):
            raise ValueError("Dimension must be either 2 or 3 for cross "
                             "product")
        if x.shape[-1] == 2 and y.shape[-1] == 2:
            return x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]
        a0, a1 = x[..., 0], x[..., 1]
        a2 = x[..., 2] if x.shape[-1] == 3 else torch.zeros_like(a0)
        b0, b1 = y[..., 0], y[..., 1]
        b2 = y[..., 2] if y.shape[-1] == 3 else torch.zeros_like(b0)
        c = torch.stack(torch.broadcast_tensors(
            a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0))
        return torch.movedim(c, 0, axisc)
    return f


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis
    return _binary(_cross(axisa, axisb, axisc), a, b, name="cross")


def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    return sum(diagonal(a, offset, axis1, axis2), axis=-1, dtype=dtype,
               out=out)


def _einsum_terms(subscripts, shapes):
    """The einsum expression with '...' spelled out in free letters, and
    its output term (implicit: the labels seen once, sorted)."""
    s = subscripts.replace(" ", "")
    ins, out = s.split("->") if "->" in s else (s, None)
    ins = ins.split(",")
    free = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
            if c not in s]
    n_ell = builtins.max([len(sh) - (len(t) - 3) for t, sh in
                          zip(ins, shapes) if "..." in t] or [0])
    ell = "".join(free[:n_ell])
    terms = []
    for t, sh in zip(ins, shapes):
        if "..." in t:
            k = len(sh) - (len(t) - 3)
            t = t.replace("...", ell[n_ell - k:])
        terms.append(t)
    if out is None:
        seen = collections.Counter("".join(terms))
        out = ell + "".join(sorted(c for c in seen
                                   if seen[c] == 1 and c not in ell))
    else:
        out = out.replace("...", ell)
    return terms, out


def _einsum_exact(subscripts, xs):
    """einsum of integer or bool operands as a broadcast product in int64
    and a sum (the card has no integer matrix product): exact, wrapping
    as the operands' integer type would."""
    terms, out = _einsum_terms(subscripts, [x.shape for x in xs])
    labels = list(dict.fromkeys("".join(terms) + out))
    prod_ = None
    for t, x in zip(terms, xs):
        x = x.to(torch.int64)
        while len(set(t)) < len(t):            # a repeated label: diagonal
            c = next(c for c in t if t.count(c) > 1)
            i = t.index(c)
            j = t.index(c, i + 1)
            x = torch.diagonal(x, dim1=i, dim2=j)
            t = t[:i] + t[i + 1:j] + t[j + 1:] + c
        x = x.permute([t.index(c) for c in labels if c in t])
        x = x.reshape([x.shape[[c for c in labels if c in t].index(c)]
                       if c in t else 1 for c in labels])
        prod_ = x if prod_ is None else prod_ * x
    gone = [i for i, c in enumerate(labels) if c not in out]
    r = prod_.sum(dim=gone) if gone else prod_
    kept = [c for c in labels if c in out]
    return r.permute([kept.index(c) for c in out])


def einsum(subscripts, *operands, **kwargs):
    arrs = [_coerce(o) for o in operands]

    def f(*xs):
        res = functools.reduce(torch.promote_types, [x.dtype for x in xs])
        if res.is_floating_point or res.is_complex:
            return torch.einsum(subscripts, *[x.to(res) for x in xs])
        return _einsum_exact(subscripts, xs).to(res)
    return apply_op(f, *arrs, name="einsum")


def _matrix_power(x, n):
    """jnp.linalg.matrix_power: binary powers by ``_matmul``, an inverse
    first for n < 0, the identity of x's type for n = 0."""
    n = int(n)
    if n == 0:
        eye_ = torch.eye(x.shape[-1], dtype=torch.bool, device=x.device)
        return eye_.to(x.dtype).expand(x.shape).clone()
    if n < 0:
        x, n = torch.linalg.inv(x), -n
    z = result = None
    while n > 0:
        z = x if z is None else _matmul(z, z)
        n, bit = divmod(n, 2)
        if bit:
            result = z if result is None else _matmul(result, z)
    return result


def matrix_power(a, n):
    return _unary(_int64_route(lambda x: _matrix_power(x, n)), a,
                  name="matrix_power")


def vander(x, N=None, increasing=False):
    def f(v):
        n = v.shape[0] if N is None else int(N)
        iota = torch.arange(n, device=v.device)
        if not increasing:
            iota = n - 1 - iota
        return torch.pow(v[..., None], iota.to(v.dtype))
    return _unary(_int64_route(f), x, name="vander")


# ---------------------------------------------------------------------------
# logic
# ---------------------------------------------------------------------------
def _isclose(rtol, atol, equal_nan):
    """jnp.isclose: ``x == y``, or ``|x - y| <= atol + rtol |y|`` where y
    is finite, in the operands' inexact type."""
    def f(x, y):
        dt = _inexact(torch.result_type(x, y))
        x, y = x.to(dt), y.to(dt)
        rdt = torch.empty((), dtype=dt).real.dtype
        rt = torch.as_tensor(rtol, dtype=rdt, device=x.device)
        at = torch.as_tensor(atol, dtype=rdt, device=x.device)
        out = (x == y) | (torch.isfinite(y)
                          & (torch.abs(x - y) <= at + rt * torch.abs(y)))
        if equal_nan:
            out = out | (torch.isnan(x) & torch.isnan(y))
        return out
    return f


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _binary(_isclose(rtol, atol, equal_nan), a, b, name="isclose")


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(all(isclose(a, b, rtol=rtol, atol=atol,
                            equal_nan=equal_nan)).item())


def _equal_all(equal_nan):
    def f(x, y):
        eq = x == y
        if equal_nan and (x.is_floating_point() or y.is_floating_point()):
            eq = eq | (torch.isnan(x.to(torch.result_type(x, y)))
                       & torch.isnan(y.to(torch.result_type(x, y))))
        return eq.all()
    return f


def array_equal(a1, a2, equal_nan=False):
    a1, a2 = _coerce(a1), _coerce(a2)
    if shape(a1) != shape(a2):
        return False
    return bool(_binary(_equal_all(equal_nan), a1, a2,
                        name="array_equal").item())


def array_equiv(a1, a2):
    try:
        torch.broadcast_shapes(shape(a1), shape(a2))
    except RuntimeError:
        return False
    return bool(_binary(_equal_all(False), a1, a2,
                        name="array_equiv").item())


# ---------------------------------------------------------------------------
# misc numerical
# ---------------------------------------------------------------------------
def diff(a, n=1, axis=-1, prepend=None, append=None):
    extra = [(_coerce(p), side) for p, side in ((prepend, 0), (append, 1))
             if p is not None]

    def f(x, *es):
        ax = axis % x.dim()
        parts = [x]
        it = iter(es)
        for p, side in extra:
            e = next(it) if isinstance(p, NDArray) else _scalar(p).to(
                x.device)
            if e.dim() == 0:
                shp = list(x.shape)
                shp[ax] = 1
                e = e.expand(shp)
            parts.insert(0 if side == 0 else len(parts), e)
        if len(parts) > 1:
            dt = functools.reduce(torch.promote_types,
                                  [p.dtype for p in parts])
            x = torch.cat([p.to(dt) for p in parts], ax)
        for _ in builtins.range(n):
            hi = x.narrow(ax, 1, x.shape[ax] - 1)
            lo = x.narrow(ax, 0, x.shape[ax] - 1)
            x = hi != lo if x.dtype == torch.bool else hi - lo
        return x
    nds = [p for p, _ in extra if isinstance(p, NDArray)]
    return apply_op(_wide_first(f), _coerce(a), *nds, name="diff")


def _wide_first(tfn):
    """``tfn`` whose first tensor may be uint16/32/64: computed as int64
    and cast back, the others passed on."""
    def f(x, *rest):
        if x.dtype not in _WIDE_UNSIGNED:
            return tfn(x, *rest)
        r = tfn(x.to(torch.int64), *rest)
        return r.to(x.dtype) if r.dtype == torch.int64 else r
    return f


def ediff1d(ary, to_end=None, to_begin=None):
    def f(x):
        x = x.reshape(-1)
        r = x[1:] != x[:-1] if x.dtype == torch.bool else x[1:] - x[:-1]
        parts = [r]
        if to_begin is not None:
            parts.insert(0, torch.as_tensor(onp.asarray(to_begin)).to(
                device=x.device, dtype=x.dtype).reshape(-1))
        if to_end is not None:
            parts.append(torch.as_tensor(onp.asarray(to_end)).to(
                device=x.device, dtype=x.dtype).reshape(-1))
        return torch.cat(parts) if len(parts) > 1 else r
    return _unary(_int64_route(f), ary, name="ediff1d")


def gradient(f, *varargs, axis=None, edge_order=1):
    f = _coerce(f)
    spacing = [v._data if isinstance(v, NDArray) else v for v in varargs]

    def g(x):
        x = x.to(_inexact(x.dtype))
        dims = list(_dims(x, axis))
        kw = {"dim": dims, "edge_order": edge_order}
        if len(spacing) == 1 and not torch.is_tensor(spacing[0]):
            kw["spacing"] = float(spacing[0])
        elif spacing:
            kw["spacing"] = [s.to(x.device, x.dtype) if torch.is_tensor(s)
                             else float(s) for s in spacing]
        gs = torch.gradient(x, **kw)
        # several axes give one array of the gradients stacked, as the
        # reference lifts NumPy's tuple of them: at the default float
        return gs[0] if len(gs) == 1 else torch.stack(gs).to(
            default_float())
    return apply_op(g, f, name="gradient")


def _conv(op, mode):
    """jnp's ``_conv``: 1-d operands in their inexact type, the longer
    one slid under the shorter (flipped for convolve, conjugated for
    correlate, whose output reverses when the operands swap), each
    window's products summed (exact fp32 products, no TF32)."""
    def f(x, y):
        if x.dim() != 1 or y.dim() != 1:
            raise ValueError(f"{op}() only support 1-dimensional inputs.")
        dt = _inexact(torch.promote_types(x.dtype, y.dtype))
        x, y = x.to(dt), y.to(dt)
        rev = False
        if op == "correlate":
            y = _conj(y)
            if x.shape[0] < y.shape[0]:
                x, y, rev = y, x, True
        else:
            if x.shape[0] < y.shape[0]:
                x, y = y, x
            y = y.flip(0)
        m = y.shape[0]
        lo, hi = {"valid": (0, 0), "same": (m // 2, m - m // 2 - 1),
                  "full": (m - 1, m - 1)}[mode]
        z = torch.zeros((), dtype=dt, device=x.device)
        xp = torch.cat([z.expand(lo), x, z.expand(hi)])
        r = (xp.unfold(0, m, 1) * y).sum(-1)
        return r.flip(0) if rev else r
    return f


def convolve(a, v, mode="full"):
    return _binary(_conv("convolve", mode), a, v, name="convolve")


def correlate(a, v, mode="valid"):
    return _binary(_conv("correlate", mode), a, v, name="correlate")


def _cov(rowvar, bias, ddof):
    def f(x, *ys):
        def rows(t):
            t = _atleast(t, 2).to(_inexact(t.dtype))
            return t.T if not rowvar and t.shape[0] != 1 else t
        X = rows(x)
        if ys:
            y = rows(ys[0])
            dt = torch.promote_types(X.dtype, y.dtype)
            X = torch.cat([X.to(dt), y.to(dt)], 0)
        d = (1 if not bias else 0) if ddof is None else ddof
        X = X - X.mean(1, keepdim=True)
        return (torch.matmul(X, _conj(X).T) / (X.shape[1] - d)).squeeze()
    return f


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None):
    args = (_lift(m),) if y is None else (_lift(m), _lift(y))
    return apply_op(_cov(rowvar, bias, ddof), *args, name="cov")


def corrcoef(x, y=None, rowvar=True):
    def f(*ts):
        c = _cov(rowvar, False, None)(*ts)
        if c.dim() == 0:
            return c / c
        sd = torch.sqrt(_real(torch.diagonal(c))).to(c.dtype)
        c = c / sd[:, None] / sd[None, :]
        r = torch.clamp(_real(c), -1, 1)
        return torch.complex(r, torch.clamp(c.imag, -1, 1)) \
            if c.is_complex() else r
    args = (_lift(x),) if y is None else (_lift(x), _lift(y))
    return apply_op(f, *args, name="corrcoef")


def polyval(p, x):
    def f(pp, xx):
        dt = _inexact(pp.dtype)
        pp, xx = pp.to(dt), xx.to(dt)
        y = torch.zeros(torch.broadcast_shapes(pp.shape[1:], xx.shape),
                        dtype=dt, device=xx.device)
        for i in builtins.range(pp.shape[0]):
            y = y * xx + pp[i]
        return y
    return _binary(_weak_cast(f, p, x), p, x, name="polyval")


# expose submodules
from . import fft, linalg, random  # noqa: E402,F401

# ---------------------------------------------------------------------------
# dtype utilities
# ---------------------------------------------------------------------------
finfo = onp.finfo
iinfo = onp.iinfo

#: the kinds of JAX's promotion lattice, and each kind's default (the
#: type a weak scalar of the kind takes alone)
_KIND_DEFAULT = {0: torch.bool, 1: torch.int32, 2: torch.float32,
                 3: torch.complex64}


def _kind(dt):
    return (0 if dt == torch.bool else 3 if dt.is_complex
            else 2 if dt.is_floating_point else 1)


def _promote2(a, b):
    """JAX's promotion of two strong types: a float or complex side
    decides (int32 + float16 is float16), integers take numpy's table."""
    if a == b:
        return a
    if _kind(a) >= 2 or _kind(b) >= 2:
        if _kind(a) < 2:
            return b
        if _kind(b) < 2:
            return a
        return torch.promote_types(a, b)
    return to_torch_dtype(onp.promote_types(to_numpy_dtype(a),
                                            to_numpy_dtype(b)))


def _dtype_and_weak(v):
    if isinstance(v, NDArray):
        return v._data.dtype, False
    if isinstance(v, torch.Tensor):
        return v.dtype, False
    if isinstance(v, bool) or v is bool:
        return torch.bool, True
    if isinstance(v, int) or v is int:
        return torch.int32, True
    if isinstance(v, float) or v is float:
        return torch.float32, True
    if isinstance(v, complex) or v is complex:
        return torch.complex64, True
    if isinstance(v, (onp.ndarray, onp.generic)):
        return to_torch_dtype(v.dtype), False
    return to_torch_dtype(v), False


def result_type(*arrays_and_dtypes):
    """jnp.result_type with x64 off: arrays, NumPy scalars and dtypes are
    strong, Python scalars weak (they only raise the kind: a float
    beside int32 arrays gives float32); 64-bit results narrow."""
    pairs = [_dtype_and_weak(v) for v in arrays_and_dtypes]
    strong = [d for d, w in pairs if not w]
    weak = [d for d, w in pairs if w]
    if strong:
        res = functools.reduce(_promote2, strong)
        for d in weak:
            if _kind(d) > _kind(res):
                res = _KIND_DEFAULT[_kind(d)]
    else:
        res = _KIND_DEFAULT[builtins.max(_kind(d) for d in weak)]
    return to_numpy_dtype(NARROW64.get(res, res))


def promote_types(t1, t2):
    """jnp.promote_types: 64-bit only where an argument is 64-bit."""
    a, b = to_torch_dtype(t1), to_torch_dtype(t2)
    res = _promote2(a, b)
    if not builtins.any(d in NARROW64 for d in (a, b)):
        res = NARROW64.get(res, res)
    return to_numpy_dtype(res)


def can_cast(from_, to, casting="safe"):
    if isinstance(from_, NDArray):
        from_ = from_.dtype
    return onp.can_cast(from_, to, casting=casting)


def get_include():
    return onp.get_include()


# ---------------------------------------------------------------------------
# host files (as the reference: numpy's .npy / .npz)
# ---------------------------------------------------------------------------
def save(file, arr):
    onp.save(file, arr.asnumpy() if isinstance(arr, NDArray)
             else onp.asarray(arr))


def savez(file, *args, **kwds):
    args = [a.asnumpy() if isinstance(a, NDArray) else a for a in args]
    kwds = {k: (v.asnumpy() if isinstance(v, NDArray) else v)
            for k, v in kwds.items()}
    onp.savez(file, *args, **kwds)


def load(file, allow_pickle=False):
    res = onp.load(file, allow_pickle=allow_pickle)
    if isinstance(res, onp.lib.npyio.NpzFile):
        return {k: array(res[k]) for k in res.files}
    return array(res)


def genfromtxt(*args, **kwargs):
    return array(onp.genfromtxt(*args, **kwargs))


def fromiter(iterable, dtype, count=-1):
    return array(onp.fromiter(iterable, dtype=dtype, count=count))


set_printoptions = onp.set_printoptions
get_printoptions = onp.get_printoptions

# ---------------------------------------------------------------------------
# legacy aliases, windows and index helpers
# ---------------------------------------------------------------------------
alltrue = all
sometrue = any
product = prod


def _window(coeffs, M, dtype, ctx):
    """numpy's cosine-sum windows on the device: ``n = arange(1 - M, M,
    2)``, ``sum_k c_k cos(k pi n / (M - 1))`` in float64, then the
    type."""
    ctx = ctx or current_context()
    dt = resolve_dtype(dtype) or default_float()
    M = int(M)
    dev = ctx.torch_device
    if M < 1:
        return _new(torch.zeros(0, dtype=dt, device=dev), ctx)
    if M == 1:
        return _new(torch.ones(1, dtype=dt, device=dev), ctx)
    n = torch.arange(1 - M, M, 2, dtype=torch.float64, device=dev)
    w = functools.reduce(torch.add, [
        c * torch.cos(k * math.pi * n / (M - 1)) for k, c in
        enumerate(coeffs) if k], coeffs[0])
    return _new(w.to(dt), ctx)


def blackman(M, dtype=None, ctx=None):
    return _window((0.42, 0.5, 0.08), M, dtype, ctx)


def hamming(M, dtype=None, ctx=None):
    return _window((0.54, 0.46), M, dtype, ctx)


def hanning(M, dtype=None, ctx=None):
    return _window((0.5, 0.5), M, dtype, ctx)


def fill_diagonal(a, val, wrap=False):
    """numpy's in-place diagonal fill: the flat positions ``0, step,
    2 step, ...`` (``step`` = 1 + the sum of the leading strides; a tall
    2-d array wraps only with ``wrap``) take ``val``, cycled; the new
    tensor is installed into ``a``."""
    x = a._data.detach()
    if x.dim() < 2:
        raise ValueError("array must be at least 2-d")
    if x.dim() == 2:
        step = x.shape[1] + 1
        end = x.numel() if wrap else x.shape[1] * x.shape[1]
    else:
        if len(set(x.shape)) != 1:
            raise ValueError("All dimensions of input must be of equal "
                             "length")
        step = 1 + int(onp.cumprod(x.shape[:-1]).sum())
        end = x.numel()
    pos = torch.arange(0, builtins.min(end, x.numel()), step,
                       device=x.device)
    v = (val._data if isinstance(val, NDArray)
         else torch.as_tensor(onp.asarray(val))).to(x.device).reshape(-1)
    v = v.to(x.dtype)[torch.arange(pos.shape[0], device=x.device)
                      % v.shape[0]]
    sv = _SIGNED_VIEW.get(x.dtype)
    flat = x.reshape(-1).clone()
    if sv is not None:
        flat.view(sv)[pos] = v.view(sv)
    else:
        flat[pos] = v
    a._install(flat.reshape(x.shape))
    return None


def triu_indices(n, k=0, m=None, ctx=None):
    ctx = ctx or current_context()
    m = n if m is None else m
    return _index_arrays(torch.triu_indices(n, m, k,
                                            device=ctx.torch_device), ctx)


def triu_indices_from(arr, k=0):
    if arr.ndim != 2:
        raise ValueError("input array must be 2-d")
    return triu_indices(arr.shape[-2], k=k, m=arr.shape[-1], ctx=arr.ctx)


def unravel_index(indices, shape, order="C"):
    """jnp.unravel_index (C order: an index past either end clips to the
    first or last coordinate); ``order='F'`` takes the dims in reverse
    and gives int32, as the reference's host route does."""
    indices = _coerce(indices)
    if not isinstance(indices, NDArray):
        indices = array(onp.asarray(indices, dtype=onp.int32),
                        dtype=onp.int32)
    dims = [int(s) for s in (shape if isinstance(shape, (list, tuple))
                             else (shape,))]

    def f(i):
        res = i.dtype if order == "C" else torch.int32
        rest = i.to(torch.int64)
        out = [None] * len(dims)
        walk = reversed(list(enumerate(dims))) if order == "C" \
            else enumerate(dims)
        for d, s in walk:
            rest, out[d] = torch.div(rest, s, rounding_mode="floor"), \
                torch.remainder(rest, s)
        hi, lo = rest > 0, rest < -1
        return tuple(torch.where(hi, s - 1, torch.where(lo, 0, o)).to(res)
                     for s, o in zip(dims, out))
    return apply_op(f, indices, nout=len(dims), name="unravel_index")


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    """The flat index of each coordinate tuple; ``mode`` 'raise' checks
    the coordinates (one sync), 'wrap' takes them modulo the dims,
    'clip' clamps them. int32, as the reference's int64 narrows."""
    idx = [_coerce(m) for m in multi_index]
    idx = [m if isinstance(m, NDArray) else array(
        onp.asarray(m, dtype=onp.int32), dtype=onp.int32) for m in idx]
    dims = [int(d) for d in dims]
    modes = [mode] * len(dims) if isinstance(mode, str) else list(mode)
    strides = [math.prod(dims[i + 1:]) if order == "C"
               else math.prod(dims[:i]) for i in builtins.range(len(dims))]

    def f(*ms):
        total, bad = None, []
        for m, d, s, md in zip(ms, dims, strides, modes):
            m = m.to(torch.int64)
            if md == "wrap":
                m = m.remainder(d)
            elif md == "clip":
                m = m.clamp(0, d - 1)
            else:
                bad.append(((m < 0) | (m >= d)).any())
            total = m * s if total is None else total + m * s
        if bad and bool(torch.stack(bad).any()):       # the one sync
            raise ValueError("invalid entry in coordinates array")
        return total
    return apply_op(f, *idx, name="ravel_multi_index")


# ---------------------------------------------------------------------------
# financial functions (the reference's closed forms, numpy-financial's,
# in float64 on the current device; a scalar result is a Python float)
# ---------------------------------------------------------------------------
def _fin_when(when):
    table = {"begin": 1, "b": 1, "beginning": 1, "start": 1, 1: 1,
             "end": 0, "e": 0, "finish": 0, 0: 0}
    try:
        return table[when]
    except KeyError:
        raise ValueError(f"when must be 'begin' or 'end' (got {when!r})")


def _fin_t(*vals):
    """The arguments as tensors on the current device, in the type NumPy
    computes them in (NEP 50: a Python number is weak, so a float32
    array stays float32; integers and numbers alone give float64)."""
    dev = current_context().torch_device
    probe = [onp.empty(0, v.dtype) if isinstance(v, NDArray)
             else v if isinstance(v, (bool, int, float))
             else onp.asarray(v) for v in vals]
    dt = onp.result_type(*probe)
    dt = to_torch_dtype(dt if dt.kind == "f" else onp.float64)
    return [(v._data if isinstance(v, NDArray) else torch.as_tensor(
        onp.asarray(v))).to(device=dev, dtype=dt) for v in vals]


def _fin_lift(r):
    if r.dim() > 0:
        return _new(r.to(torch.float32), current_context())
    return float(r)


def _fv_t(rate, nper, pmt_, pv_, when):
    temp = (1 + rate) ** nper
    fact = torch.where(rate == 0, nper, (1 + rate * when) * (temp - 1)
                       / torch.where(rate == 0, 1.0, rate))
    return -(pv_ * temp + pmt_ * fact)


def _pmt_t(rate, nper, pv_, fv_, when):
    temp = (1 + rate) ** nper
    mask = rate == 0
    fact = torch.where(mask, nper, (1 + rate * when) * (temp - 1)
                       / torch.where(mask, 1.0, rate))
    return -(fv_ + pv_ * temp) / fact


def fv(rate, nper, pmt, pv, when="end"):
    return _fin_lift(_fv_t(*_fin_t(rate, nper, pmt, pv), _fin_when(when)))


def pv(rate, nper, pmt, fv=0, when="end"):
    w = _fin_when(when)
    rate, nper, pmt, fv = _fin_t(rate, nper, pmt, fv)
    temp = (1 + rate) ** nper
    fact = torch.where(rate == 0, nper, (1 + rate * w) * (temp - 1)
                       / torch.where(rate == 0, 1.0, rate))
    return _fin_lift(-(fv + pmt * fact) / temp)


def pmt(rate, nper, pv, fv=0, when="end"):
    return _fin_lift(_pmt_t(*_fin_t(rate, nper, pv, fv), _fin_when(when)))


def nper(rate, pmt, pv, fv=0, when="end"):
    w = _fin_when(when)
    rate, pmt, pv, fv = torch.broadcast_tensors(*_fin_t(rate, pmt, pv, fv))
    safe = torch.where(rate == 0, 1.0, rate)
    z = pmt * (1 + safe * w) / safe
    general = torch.log((-fv + z) / (pv + z)) / torch.log(1 + safe)
    return _fin_lift(torch.where(rate == 0, -(fv + pv) / pmt, general))


def _ipmt_t(rate, per, nper, pv_, fv_, w):
    total = _pmt_t(rate, nper, pv_, fv_, w)
    ip = _fv_t(rate, per - 1, total, pv_, w) * rate
    ip = torch.where(per == 1, 0.0 if w == 1 else ip, ip)
    return ip / (1 + rate) if w == 1 else ip


def ipmt(rate, per, nper, pv, fv=0, when="end"):
    return _fin_lift(_ipmt_t(*_fin_t(rate, per, nper, pv, fv),
                             _fin_when(when)))


def ppmt(rate, per, nper, pv, fv=0, when="end"):
    w = _fin_when(when)
    rate, per, nper, pv, fv = _fin_t(rate, per, nper, pv, fv)
    return _fin_lift(_pmt_t(rate, nper, pv, fv, w)
                     - _ipmt_t(rate, per, nper, pv, fv, w))


def _npv_t(rate, values):
    n = torch.arange(values.shape[0], dtype=torch.float64,
                     device=values.device)
    return (values / (1 + rate) ** n).sum()


def npv(rate, values):
    rate, values = _fin_t(rate, values)
    return float(_npv_t(rate, values))


def mirr(values, finance_rate, reinvest_rate):
    values, fr, rr = _fin_t(values, finance_rate, reinvest_rate)
    pos, neg = values > 0, values < 0
    n = values.shape[0]
    numer = torch.abs(_npv_t(rr, values * pos))
    denom = torch.abs(_npv_t(fr, values * neg))
    r = (numer / denom) ** (1 / (n - 1)) * (1 + rr) - 1
    ok = pos.any() & neg.any()
    return float(torch.where(ok, r, torch.nan))


def irr(values):
    """The rate of the real positive root of the cash-flow polynomial
    nearest 0 (numpy's ``roots``: the companion matrix's eigenvalues,
    by ``torch.linalg.eigvals`` on the device)."""
    (values,) = _fin_t(values)
    p = values.flip(0)
    nz = torch.nonzero(p).reshape(-1).tolist()
    if not nz:
        return float("nan")
    p = p[nz[0]:nz[-1] + 1]
    trailing = values.shape[0] - 1 - nz[-1]
    n = p.shape[0] - 1
    if n < 1:
        return float("nan")
    comp = torch.diag(torch.ones(n - 1, dtype=torch.float64,
                                 device=p.device), -1)
    comp[0, :] = -p[1:] / p[0]
    roots = torch.linalg.eigvals(comp)
    if trailing:
        roots = torch.cat([roots, torch.zeros(trailing, dtype=roots.dtype,
                                              device=roots.device)])
    keep = (roots.imag == 0) & (roots.real > 0)
    rates = 1 / roots.real - 1
    rates = torch.where(keep, rates, torch.inf)
    best = torch.where(keep, torch.abs(rates), torch.inf).argmin()
    r = torch.where(keep.any(), rates[best], torch.nan)
    return float(r)


def rate(nper, pmt, pv, fv, when="end", guess=0.1, tol=1e-6, maxiter=100):
    """Newton iteration on the annuity identity (numpy-financial g/g'),
    all on the device: the first iterate whose step is below ``tol``
    everywhere, else the last."""
    w = _fin_when(when)
    nper, pmt, pv, fv, rn = _fin_t(nper, pmt, pv, fv, guess)
    found = torch.zeros((), dtype=torch.bool, device=rn.device)
    out = rn
    for _ in builtins.range(maxiter):
        t1 = (rn + 1) ** nper
        t2 = (rn + 1) ** (nper - 1)
        g = fv + t1 * pv + pmt * (t1 - 1) * (rn * w + 1) / rn
        gp = (nper * t2 * pv - pmt * (t1 - 1) * (rn * w + 1) / (rn ** 2)
              + nper * pmt * t2 * (rn * w + 1) / rn
              + pmt * (t1 - 1) * w / rn)
        rnp1 = rn - g / gp
        conv = (torch.abs(rnp1 - rn) < tol).all()
        out = torch.where(~found & conv, rnp1, out)
        found = found | conv
        rn = rnp1
    return _fin_lift(torch.where(found, out, rn))


# ---------------------------------------------------------------------------
# NumPy fallback for names the port does not define (parity: the
# reference's numpy/fallback.py): the call runs on the HOST, on NumPy
# copies of its arrays, and the result is lifted back to NDArray
# ---------------------------------------------------------------------------
#: host fallback calls by name (the NumPy dispatch protocol's included)
FALLBACK_CALLS = collections.Counter()

_NO_FALLBACK = frozenset({
    # numpy machinery that must not masquerade as mx.np ops
    "ndarray", "generic", "ufunc", "matrix", "memmap", "nditer",
    "frombuffer", "fromfile", "fromiter", "seterr", "geterr", "errstate",
})


def _make_fallback(onp_fn, name):
    from .dispatch import _from_host, _to_host

    def fallback(*args, **kwargs):
        FALLBACK_CALLS[name] += 1
        return _from_host(onp_fn(*_to_host(args), **_to_host(kwargs)))
    fallback.__name__ = name
    fallback.__qualname__ = name
    fallback.__doc__ = (f"Host (NumPy) fallback for np.{name}: the port has "
                        "no native implementation; inputs sync to the "
                        "host and the result is lifted back to NDArray."
                        f"\n\n{onp_fn.__doc__ or ''}")
    return fallback


def __getattr__(name):
    if name.startswith("_") or name in _NO_FALLBACK:
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r}")
    if name == "trapz" and hasattr(onp, "trapezoid"):
        fn = _make_fallback(onp.trapezoid, "trapz")
        globals()[name] = fn
        return fn
    onp_fn = getattr(onp, name, None)
    if onp_fn is None or not callable(onp_fn) or isinstance(onp_fn, type):
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r}")
    fn = _make_fallback(onp_fn, name)
    globals()[name] = fn
    return fn
