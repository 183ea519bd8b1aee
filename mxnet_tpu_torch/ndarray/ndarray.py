"""NDArray: the imperative array type, over a ``torch.Tensor``.

The port of ``mxnet_tpu/ndarray/ndarray.py``:

- The payload is a ``torch.Tensor`` on the card (or the CPU, when asked
  for). Ops enqueue on the current CUDA stream and return at once;
  ``wait_to_read``/``asnumpy`` are the sync points where deferred
  device errors surface.
- Writes are functional: ``x[...] = v``, ``copyto`` and ``zero_grad``
  install a NEW tensor and bump ``_version``; no tensor the port has
  handed out is changed in place. Tensors autograd saved for backward
  therefore keep their values (``CustomOp.assign`` and
  ``x[...] = v`` after ``record()`` rely on this), and torch never
  sees an in-place write on a saved tensor.
- Autograd is torch's: an array is on the tape when its tensor
  ``requires_grad`` (a variable from ``attach_grad``, or an op's output
  recorded under ``autograd.record()``). A variable's leaf tensor
  carries a weak reference to its NDArray (``_mx_owner``), which is how
  ``autograd.backward`` finds the ``.grad`` buffer to write, even for a
  leaf tensor that a later write replaced.
- ``dtype`` reports numpy dtypes, as the reference does (bfloat16, which
  numpy lacks, as ``torch.bfloat16``).
"""
from __future__ import annotations

import builtins
import weakref

import numpy as onp
import torch

from .. import engine
from ..base import resolve_dtype, to_numpy_dtype
from ..context import Context, cpu, gpu

__all__ = ["NDArray", "waitall"]


def _ctx_of(t: torch.Tensor) -> Context:
    return gpu(t.device.index or 0) if t.is_cuda else cpu()


def _needs_grad_dtype(dt: torch.dtype) -> bool:
    """Gradients only exist for inexact dtypes."""
    return dt.is_floating_point or dt.is_complex


def _coerce_index_dtype(t: torch.Tensor) -> torch.Tensor:
    """Float index arrays truncate to int (reference parity: the mx.np
    default dtype is float32, so ``a[np.array([0, 2])]`` arrives float
    and the reference accepts it, for reads AND writes)."""
    if _needs_grad_dtype(t.dtype):
        return t.detach().to(torch.int64)
    if t.dtype != torch.bool and t.dtype != torch.int64:
        return t.to(torch.int64)
    return t


def _to_torch_index(key, device):
    """An index expression with NDArrays in it, as torch takes it."""
    if isinstance(key, NDArray):
        return _coerce_index_dtype(key._data).to(device)
    if isinstance(key, tuple):
        return tuple(_to_torch_index(k, device) for k in key)
    if isinstance(key, list):
        return [_to_torch_index(k, device) for k in key]
    return key


def _index_dims(k) -> int:
    """How many array dims the index element ``k`` consumes."""
    if k is None or k is Ellipsis or isinstance(k, (bool, onp.bool_)):
        return 0
    if isinstance(k, (NDArray, torch.Tensor)):
        t = k._data if isinstance(k, NDArray) else k
        return t.dim() if t.dtype == torch.bool else 1
    if isinstance(k, (list, onp.ndarray)):
        a = onp.asarray(k)
        return a.ndim if a.dtype == onp.bool_ else 1
    return 1


def _reverse_steps(key, shape):
    """Rewrite the negative-step slices of ``key``, which torch refuses.

    Returns ``(pre, dims, rest)`` such that ``x[pre].flip(dims)[rest]``
    is NumPy's ``x[key]``: ``pre`` cuts each such dim with the positive
    slice over the same elements, ``flip`` puts them in the slice's
    order, and ``rest`` is ``key`` with those slices made ``:``. Returns
    None when ``key`` has no negative step."""
    items = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in items):
        return None
    ell = len(shape) - builtins.sum(_index_dims(k) for k in items)
    pre, dims, rest, d = [slice(None)] * len(shape), [], [], 0
    for k in items:
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            r = range(*k.indices(shape[d]))
            pre[d] = slice(r[-1], r[0] + 1, -r.step) if r else slice(0, 0)
            dims.append(d)
            k = slice(None)
        rest.append(k)
        d += ell if k is Ellipsis else _index_dims(k)
    return (tuple(pre), dims,
            tuple(rest) if isinstance(key, tuple) else rest[0])


#: the signed type of each wide unsigned one's width: torch's flip,
#: take_along_dim, triu (and, on the card, where) refuse uint16/32/64,
#: and moving data needs no arithmetic, so such data moves as the signed
#: type of its width, bit for bit
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def _signed_view(tfn):
    """``tfn`` of one tensor (further arguments passed on) that only
    moves data: a uint16/32/64 tensor is moved as ``_SIGNED_VIEW``'s
    type and the result viewed back."""
    def f(x, *args):
        sv = _SIGNED_VIEW.get(x.dtype)
        if sv is None:
            return tfn(x, *args)
        return tfn(x.view(sv), *args).view(x.dtype)
    return f


def _value_tensor(value, dtype, device) -> torch.Tensor:
    """A written value (NDArray data, tensor, array-like or scalar) on
    the target's device and dtype."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        t = torch.as_tensor(onp.asarray(value))
    return t.to(device=device, dtype=dtype)


class NDArray:
    """An asynchronous n-dimensional array on the card (or the CPU)."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_fresh_grad",
                 "_version", "_bucket_pad", "__weakref__")

    # `onp_array op ndarray` hits our reflected ops, not numpy's
    __array_priority__ = 1000.0
    __array_ufunc__ = None

    def __init__(self, data: torch.Tensor, ctx: Context = None):
        self._data = data
        self._ctx = ctx if ctx is not None else _ctx_of(data)
        self._grad = None
        self._grad_req = "null"
        self._fresh_grad = False
        self._version = 0

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return to_numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def ctx(self) -> Context:
        return self._ctx

    context = ctx

    @property
    def device(self) -> Context:
        return self._ctx

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return f"array({self.asnumpy()}, ctx={self._ctx})"

    def __str__(self):
        return str(self.asnumpy())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of an array with more than one element is "
                "ambiguous.")
        return bool(self.item())

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __index__(self):
        if self.ndim == 0 and onp.issubdtype(self.dtype, onp.integer):
            return int(self.item())
        raise TypeError(
            "only integer scalar arrays can be converted to an index")

    def __hash__(self):
        return id(self)

    def __format__(self, fmt):
        if self.size == 1:
            return format(self.item(), fmt)
        return repr(self)

    # ------------------------------------------------------------------
    # sync / conversion
    # ------------------------------------------------------------------
    def wait_to_read(self):
        """Block until computed; re-raise deferred device errors."""
        engine.wait_to_read(self._data)
        return self

    wait_to_write = wait_to_read

    def asnumpy(self) -> onp.ndarray:
        t = engine.wait_to_read(self._data).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # a CPU tensor's .numpy() shares its memory: copy, so writing to
        # the result never writes into the array
        return t.numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def item(self):
        return self.asnumpy().item()

    def asscalar(self):
        return self.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, stream=None):
        return self._data.detach().__dlpack__(stream=stream)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def astype(self, dtype, copy=True):
        dt = resolve_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        from ..ops import apply_op
        return apply_op(lambda x: x.to(dt), self, name="astype")

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    # ------------------------------------------------------------------
    # context movement
    # ------------------------------------------------------------------
    def as_in_context(self, ctx: Context):
        if ctx == self._ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context
    to_device = as_in_context

    def copyto(self, other):
        """Copy to a Context (a new array, off the tape) or into another
        NDArray (installed there in its dtype)."""
        if isinstance(other, Context):
            data = self._data.detach().to(other.torch_device)
            return NDArray(engine.track(data), ctx=other)
        if isinstance(other, NDArray):
            other._install(_value_tensor(self._data, other._data.dtype,
                                         other._data.device))
            return other
        raise TypeError(
            f"copyto expects Context or NDArray, got {type(other)}")

    def copy(self):
        return NDArray(engine.track(self._data.detach().clone()),
                       ctx=self._ctx)

    # ------------------------------------------------------------------
    # autograd attachment
    # ------------------------------------------------------------------
    def _set_data(self, t: torch.Tensor):
        """Make ``t`` this array's tensor; a variable's tensor stays on
        the tape (a leaf requiring grad, owned by this array) unless it
        already carries a graph."""
        if self._grad_req != "null" and not t.requires_grad \
                and _needs_grad_dtype(t.dtype):
            t = t.detach().requires_grad_(True)
            t._mx_owner = weakref.ref(self)
        self._data = t

    def attach_grad(self, grad_req: str = "write", stype=None):
        """Allocate a gradient buffer and mark this array as a variable."""
        self._grad = NDArray(engine.track(torch.zeros_like(
            self._data, requires_grad=False)), ctx=self._ctx)
        self._grad_req = grad_req
        self._set_data(self._data.detach())

    def drop_grad(self):
        self._grad = None
        self._grad_req = "null"
        self._data = self._data.detach()

    def zero_grad(self):
        if self._grad is not None:
            self._grad._install(torch.zeros_like(self._grad._data))

    def detach(self):
        return NDArray(self._data.detach(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], head_grads=[out_grad]
                          if out_grad is not None else None,
                          retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # mutation (functional under the hood)
    # ------------------------------------------------------------------
    def _install(self, new: torch.Tensor):
        """Install a new tensor (the write-var version bump). The write
        is not recorded, as in the reference."""
        self._set_data(engine.track(new.detach()))
        self._version += 1
        return self

    def _inplace(self, result):
        """``x op= y`` and ``out=``: this array takes ``result``'s
        tensor, graph included."""
        self._set_data(result._data)
        self._version += 1
        return self

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        t = self._data
        idx = _to_torch_index(key, t.device)
        rev = _reverse_steps(idx, t.shape)
        with torch.no_grad():
            if rev is not None:
                # write through the flipped copy of the cut, then put
                # it back in place (a wide unsigned array as its signed
                # view: torch flips none)
                pre, dims, rest = rev
                new = t.detach().clone()
                sv = _SIGNED_VIEW.get(t.dtype)
                cut = new[pre] if sv is None else new.view(sv)[pre]
                flipped = cut.flip(dims)
                if sv is not None:
                    flipped[rest] = _value_tensor(value, t.dtype,
                                                  t.device).view(sv)
                elif isinstance(value, (bool, int, float)):
                    flipped[rest] = value
                else:
                    flipped[rest] = _value_tensor(value, t.dtype, t.device)
                cut.copy_(flipped.flip(dims))
            elif idx is Ellipsis or (isinstance(idx, slice)
                                   and idx == slice(None)) \
                    or (isinstance(idx, tuple) and not idx):
                v = _value_tensor(value, t.dtype, t.device)
                try:
                    new = v.expand(t.shape).clone()
                except RuntimeError as e:
                    raise ValueError(
                        f"cannot write a value of shape {tuple(v.shape)} "
                        f"into an array of shape {self.shape}") from e
            else:
                new = t.detach().clone()
                if isinstance(value, (bool, int, float)):
                    new[idx] = value
                else:
                    new[idx] = _value_tensor(value, t.dtype, t.device)
        self._install(new)

    def __getitem__(self, key):
        from ..ops import apply_op
        if isinstance(key, NDArray):
            nd_keys = [key]
        elif isinstance(key, tuple):
            nd_keys = [k for k in key if isinstance(k, NDArray)]
        else:
            nd_keys = []

        rev = _reverse_steps(key, self.shape)
        if rev is not None:
            pre, dims, key = rev

        def do_index(x, *keys):
            kit = iter(keys)

            def one(k):
                if isinstance(k, NDArray):
                    return _coerce_index_dtype(next(kit)).to(x.device)
                return k
            k = tuple(one(kk) for kk in key) if isinstance(key, tuple) \
                else one(key)
            if rev is not None:
                x = _signed_view(lambda t: t[pre].flip(dims))(x)
            return x[k]

        return apply_op(do_index, self, *nd_keys, name="getitem")

    # ------------------------------------------------------------------
    # arithmetic — delegate to the mx.np namespace (single source of truth)
    # ------------------------------------------------------------------
    def _np(self):
        from .. import numpy as _mnp
        return _mnp

    def __add__(self, o): return self._np().add(self, o)
    def __radd__(self, o): return self._np().add(o, self)
    def __sub__(self, o): return self._np().subtract(self, o)
    def __rsub__(self, o): return self._np().subtract(o, self)
    def __mul__(self, o): return self._np().multiply(self, o)
    def __rmul__(self, o): return self._np().multiply(o, self)
    def __truediv__(self, o): return self._np().true_divide(self, o)
    def __rtruediv__(self, o): return self._np().true_divide(o, self)
    def __floordiv__(self, o): return self._np().floor_divide(self, o)
    def __rfloordiv__(self, o): return self._np().floor_divide(o, self)
    def __mod__(self, o): return self._np().mod(self, o)
    def __rmod__(self, o): return self._np().mod(o, self)
    def __divmod__(self, o): return (self // o, self % o)
    def __pow__(self, o): return self._np().power(self, o)
    def __rpow__(self, o): return self._np().power(o, self)
    def __matmul__(self, o): return self._np().matmul(self, o)
    def __rmatmul__(self, o): return self._np().matmul(o, self)
    def __neg__(self): return self._np().negative(self)
    def __pos__(self): return self
    def __abs__(self): return self._np().abs(self)
    def __invert__(self): return self._np().invert(self)
    def __and__(self, o): return self._np().bitwise_and(self, o)
    def __rand__(self, o): return self._np().bitwise_and(o, self)
    def __or__(self, o): return self._np().bitwise_or(self, o)
    def __ror__(self, o): return self._np().bitwise_or(o, self)
    def __xor__(self, o): return self._np().bitwise_xor(self, o)
    def __rxor__(self, o): return self._np().bitwise_xor(o, self)
    def __lshift__(self, o): return self._np().left_shift(self, o)
    def __rshift__(self, o): return self._np().right_shift(self, o)

    def __eq__(self, o): return self._np().equal(self, o)
    def __ne__(self, o): return self._np().not_equal(self, o)
    def __lt__(self, o): return self._np().less(self, o)
    def __le__(self, o): return self._np().less_equal(self, o)
    def __gt__(self, o): return self._np().greater(self, o)
    def __ge__(self, o): return self._np().greater_equal(self, o)

    # in-place: functional rebind (new tensor, version bump)
    def __iadd__(self, o): return self._inplace(self._np().add(self, o))
    def __isub__(self, o): return self._inplace(self._np().subtract(self, o))
    def __imul__(self, o): return self._inplace(self._np().multiply(self, o))
    def __itruediv__(self, o):
        return self._inplace(self._np().true_divide(self, o))
    def __ifloordiv__(self, o):
        return self._inplace(self._np().floor_divide(self, o))
    def __imod__(self, o): return self._inplace(self._np().mod(self, o))
    def __ipow__(self, o): return self._inplace(self._np().power(self, o))

    # ------------------------------------------------------------------
    # shape / reduction methods (delegate to mx.np; a function a later
    # slice ports raises its not-ported error)
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._np().reshape(self, shape)

    def reshape_like(self, other):
        return self._np().reshape(self, other.shape)

    def transpose(self, *axes):
        if len(axes) == 0:
            axes = None
        elif len(axes) == 1 and (axes[0] is None
                                 or isinstance(axes[0], (tuple, list))):
            axes = axes[0]
        return self._np().transpose(self, axes)

    def swapaxes(self, a1, a2): return self._np().swapaxes(self, a1, a2)
    def flatten(self): return self.reshape(-1)
    def ravel(self): return self.reshape(-1)
    def squeeze(self, axis=None): return self._np().squeeze(self, axis)
    def expand_dims(self, axis): return self._np().expand_dims(self, axis)
    def broadcast_to(self, shape): return self._np().broadcast_to(self, shape)
    def broadcast_like(self, other):
        return self._np().broadcast_to(self, other.shape)
    def repeat(self, repeats, axis=None):
        return self._np().repeat(self, repeats, axis)
    def tile(self, reps): return self._np().tile(self, reps)
    def flip(self, axis=None): return self._np().flip(self, axis)
    def split(self, indices_or_sections, axis=0):
        return self._np().split(self, indices_or_sections, axis)
    def clip(self, a_min=None, a_max=None):
        return self._np().clip(self, a_min, a_max)

    def sum(self, axis=None, dtype=None, out=None, keepdims=False):
        return self._np().sum(self, axis=axis, dtype=dtype, out=out,
                              keepdims=keepdims)

    def mean(self, axis=None, dtype=None, out=None, keepdims=False):
        return self._np().mean(self, axis=axis, dtype=dtype, out=out,
                               keepdims=keepdims)

    def prod(self, axis=None, dtype=None, out=None, keepdims=False):
        return self._np().prod(self, axis=axis, dtype=dtype, out=out,
                               keepdims=keepdims)

    def max(self, axis=None, out=None, keepdims=False):
        return self._np().max(self, axis=axis, out=out, keepdims=keepdims)

    def min(self, axis=None, out=None, keepdims=False):
        return self._np().min(self, axis=axis, out=out, keepdims=keepdims)

    def std(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
        return self._np().std(self, axis=axis, dtype=dtype, out=out,
                              ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
        return self._np().var(self, axis=axis, dtype=dtype, out=out,
                              ddof=ddof, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None):
        return self._np().cumsum(self, axis, dtype)

    def take(self, indices, axis=None, mode="clip"):
        return self._np().take(self, indices, axis=axis, mode=mode)

    def pad(self, pad_width, mode="constant", **kw):
        return self._np().pad(self, pad_width, mode=mode, **kw)

    def round(self, decimals=0): return self._np().round(self, decimals)
    def argsort(self, axis=-1): return self._np().argsort(self, axis)
    def sort(self, axis=-1): return self._inplace(self._np().sort(self, axis))
    def all(self, axis=None, keepdims=False):
        return self._np().all(self, axis, keepdims=keepdims)
    def any(self, axis=None, keepdims=False):
        return self._np().any(self, axis, keepdims=keepdims)
    def nonzero(self): return self._np().nonzero(self)
    def argmax(self, axis=None): return self._np().argmax(self, axis)
    def argmin(self, axis=None): return self._np().argmin(self, axis)
    def dot(self, other): return self._np().dot(self, other)

    def abs(self): return self._np().abs(self)
    def exp(self): return self._np().exp(self)
    def log(self): return self._np().log(self)
    def sqrt(self): return self._np().sqrt(self)
    def square(self): return self._np().square(self)
    def sign(self): return self._np().sign(self)
    def tanh(self): return self._np().tanh(self)
    def sigmoid(self): return self._np()._npx().sigmoid(self)
    def relu(self): return self._np()._npx().relu(self)

    def tostype(self, stype):
        if stype == "default":
            return self
        from ..base import not_ported
        raise not_ported("sparse storage (ndarray/sparse.py)", 13)

    def slice_axis(self, axis, begin, end):
        idx = [slice(None)] * self.ndim
        idx[axis] = slice(begin, end)
        return self[tuple(idx)]


def waitall():
    engine.waitall()
