"""mx.np — the NumPy-semantics array API, the subset this slice ports.

The port of ``mxnet_tpu/numpy/__init__.py``: every function lowers to a
PyTorch expression through ``ops.apply_op`` (async on the card,
context inference, autograd). Conventions, as in the reference:

- NDArray positional args are differentiable; static attributes (axis,
  shape, ...) are closed over.
- Default dtypes follow the reference (float32 for creation ops unless
  the input carries a dtype), not NumPy's float64; 64-bit results
  narrow to 32 bits (``base.NARROW64``).
- A Python scalar operand takes part as a 0-d tensor, so it promotes
  like a JAX weak-typed scalar (``int32 + 2`` stays int32,
  ``int32 * 2.5`` is float32).
- ``out=`` is honored by installing the result into the target array.

Functions of the reference that are not ported yet raise
``base.not_ported(..., 13)`` (an AttributeError too, so ``hasattr``
answers False).
"""
from __future__ import annotations

import builtins
import functools
import math

import numpy as onp
import torch

from .. import engine
from ..base import (default_float, narrow_dtype, not_ported, resolve_dtype,
                    to_numpy_dtype)
from ..context import current_context
from ..ndarray.ndarray import _SIGNED_VIEW, NDArray, _signed_view
from ..ops import apply_op
from . import random  # noqa: F401  (mx.np.random)

# re-exported names
ndarray = NDArray
pi = onp.pi
e = onp.e
inf = onp.inf
nan = onp.nan
newaxis = None

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


def _scalar(x):
    """A Python or numpy scalar as a 0-d CPU tensor: torch then
    promotes it like a JAX weak-typed scalar, and lets it meet a tensor
    on the card."""
    return torch.as_tensor(x)


def _set_out(out, r):
    if out is None:
        return r
    return out._inplace(r)


#: unsigned dtypes torch neither promotes nor computes on
_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
#: sum and prod of these give uint32, as in the reference
_UNSIGNED = (torch.uint8, *_WIDE_UNSIGNED)


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
            or not any(d in _WIDE_UNSIGNED for d in (da, db)) \
            or not all(d is None or _is_int(d) for d in (da, db)):
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


def _int64_route(tfn, res=None):
    """``tfn`` of one tensor (further arguments passed on): a uint16/32/64
    tensor, which torch's kernels mostly refuse on the CPU and the card
    alike, is computed on as int64 and an int64 result cast back to its
    dtype, so ``negative`` wraps as the narrower type would. ``res``
    names the result dtype of an op with a rule of its own (sum and
    prod give uint32, uint8 included; argmax keeps its index)."""
    routed = _UNSIGNED if res is not None else _WIDE_UNSIGNED

    def f(x, *args):
        if x.dtype not in routed:
            return tfn(x, *args)
        r = tfn(x.to(torch.int64), *args)
        return r.to(res or x.dtype) if r.dtype == torch.int64 else r
    return f


def _bool_route(tfn, res=None):
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
    a = _coerce(a)
    if not isinstance(a, NDArray):
        a = array(a)
    return _set_out(out, apply_op(tfn, a, name=name))


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


def copy(a):
    return _unary(lambda x: x.clone(), a, name="copy")


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


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------
def _float_in(tfn):
    """Integer inputs compute in float32, as jnp does for
    transcendental ops."""
    def f(x):
        if not (x.dtype.is_floating_point or x.dtype.is_complex):
            x = x.to(default_float())
        return tfn(x)
    return f


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
sign = _mkunary(torch.sign, "sign")
square = _mkunary(torch.square, "square")
sqrt = _mkunary(_float_in(torch.sqrt), "sqrt")
exp = _mkunary(_float_in(torch.exp), "exp")
log = _mkunary(_float_in(torch.log), "log")
tanh = _mkunary(_float_in(torch.tanh), "tanh")
invert = _mkunary(torch.bitwise_not, "invert")
bitwise_not = invert


def clip(a, a_min=None, a_max=None, out=None):
    lo = None if a_min is None else (
        a_min._data if isinstance(a_min, NDArray) else a_min)
    hi = None if a_max is None else (
        a_max._data if isinstance(a_max, NDArray) else a_max)

    def f(x):
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
        raise not_ported("mx.np.where(condition) (nonzero)", 13)
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


def __getattr__(name):
    if name.startswith("_") or not callable(getattr(onp, name, None)):
        raise AttributeError(
            f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r}")
    raise not_ported(f"mx.np.{name}", 13)
