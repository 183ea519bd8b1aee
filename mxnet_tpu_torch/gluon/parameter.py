"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (the port of
``mxnet_tpu/gluon/parameter.py``).

A parameter's tensor is a ``torch.nn.Parameter`` registered on each
``Block`` (an ``nn.Module``) that holds it, under the same attribute
name, so ``Module.to(device)`` moves it and ``state_dict`` sees it. The
tensor never requires grad: no serving call builds an autograd graph.
It is created empty where the block is built (torch's default device,
e.g. under ``with torch.device(...)``) and filled by ``initialize``
(on its context: the card unless the caller asks for the CPU),
``set_data`` or :func:`load_jax_params`. A shape with unknown (0) dims
waits for the first forward (deferred initialization), which infers
them from the input (``_infer_shape``) and then allocates and
initializes the tensor.

**One rule for what a parameter returns.** ``data()`` and ``grad()``
return the port's ``NDArray``, as the reference's do, and copy
nothing: ``data()`` is one ``NDArray`` per parameter whose tensor is
always the parameter's current one (after ``Module.to``, ``cast`` or a
deferred initialization too), and writing into it (``p.data()[:] = v``)
writes the parameter in place; ``grad()`` is the gradient buffer.
Code that works on tensors (the layers, the GPT model, the engines)
reads the tensor through ``_read()``, never ``data()``; the optimizer
steps (``TrainStep``, ``Trainer``) write the registered tensor,
``_var()``, in place. ``_read()`` gives:

- inside ``bind_shadows`` on the binding thread, the tensor bound in
  the parameter's place (the GPT model's bf16 or float16 compute
  copies, or the leaves that ``parallel.TrainStep`` differentiates);
- under ``autograd.record()``, for a parameter whose ``grad_req`` is
  not ``"null"``, a leaf that shares the tensor's storage and requires
  grad, owned by ``data()``'s NDArray (``_mx_owner``), so
  ``autograd.backward`` writes ``grad()`` by ``grad_req``
  (``"write"`` overwrites, ``"add"`` accumulates) and marks the
  gradient fresh for ``Trainer``'s stale-gradient check;
- otherwise the registered tensor itself.

``data()``'s NDArray reads the same way, so a forward written over
NDArrays puts the parameter on the tape too.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import numpy as onp
import torch

from .. import autograd, initializer
from ..base import not_ported, resolve_dtype
from ..context import Context, cpu, current_context, gpu
from ..ndarray.ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "bind_shadows", "load_jax_params"]


class DeferredInitializationError(RuntimeError):
    """A deferred parameter read before the first forward inferred its
    shape."""


def torch_dtype(dtype) -> torch.dtype:
    """A dtype in the numpy, torch or string spelling, as torch's."""
    return dtype if isinstance(dtype, torch.dtype) else resolve_dtype(dtype)


def _check_grad_req(req):
    if req not in ("write", "add", "null"):
        raise ValueError(f"grad_req must be 'write', 'add' or 'null', "
                         f"got {req!r}")
    return req


def _ctx_of(t: torch.Tensor) -> Context:
    return gpu(t.device.index or 0) if t.is_cuda else cpu()


#: this thread's ``{Parameter: tensor}`` binding, or None
_BOUND = threading.local()
#: autograd's thread state (``record()`` sets ``recording``)
_RECORDING = autograd._state


@contextlib.contextmanager
def bind_shadows(mapping):
    """Within the block, on this thread only, ``_read()`` (and
    ``data()``) of every parameter in ``mapping`` returns its tensor
    there instead of the parameter's own; ``None`` binds nothing. Other
    threads keep reading the parameters themselves."""
    prev = getattr(_BOUND, "map", None)
    _BOUND.map = mapping
    try:
        yield
    finally:
        _BOUND.map = prev


class _ParamArray(NDArray):
    """``data()``: an NDArray whose tensor is the parameter's ``_read()``
    and whose writes go into the parameter's tensor in place. It owns
    the gradient buffer (``_grad``), ``_grad_req`` and ``_fresh_grad``
    that ``autograd.backward`` writes."""

    __slots__ = ("_param",)

    def __init__(self, param):
        self._param = param
        self._grad = None
        self._grad_req = "null"
        self._fresh_grad = False
        self._version = 0

    @property
    def _data(self):
        return self._param._read()

    @_data.setter
    def _data(self, t):
        var = self._param._var()
        if t is var or (t.data_ptr() == var.data_ptr()
                        and t.shape == var.shape and t.dtype == var.dtype):
            return
        with torch.no_grad():
            var.copy_(t.detach().to(device=var.device, dtype=var.dtype)
                      .expand(var.shape))

    @property
    def _ctx(self):
        return _ctx_of(self._param._var())


class Parameter:
    """A named parameter (``shape`` with 0 for a dim the first forward
    infers when ``allow_deferred_init``). ``differentiable=False`` makes
    ``grad_req`` ``"null"`` for good; ``stype``/``grad_stype`` are
    accepted for the reference's signature (dense storage only, as in
    the reference)."""

    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._name = name
        self._structured_name = None
        self._shape = tuple(int(s) for s in shape) \
            if shape is not None else None
        self.dtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._tensor = torch.nn.Parameter(
            torch.empty(self._shape if self._shape_known() else (0,),
                        dtype=self.dtype), requires_grad=False)
        self._owner = None
        self._key = None
        self._initialized = False
        self._deferred_init = None      # (init, ctx, default_init)
        self._leaf = None               # the record() leaf, see _read
        self._nd = _ParamArray(self)
        self._grad_req = "null"
        self.grad_req = grad_req if differentiable else "null"

    # -- naming ---------------------------------------------------------
    @property
    def name(self):
        """The dotted path ``collect_params`` gave it, else its own
        name."""
        return self._structured_name or self._name

    @name.setter
    def name(self, value):
        self._name = value

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")

    # -- grad_req -------------------------------------------------------
    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        req = _check_grad_req(req)
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        self._nd._grad_req = req
        if req == "null":
            self._nd._grad = None
            self._leaf = None

    @property
    def _fresh_grad(self) -> bool:
        return self._nd._fresh_grad

    @_fresh_grad.setter
    def _fresh_grad(self, value):
        self._nd._fresh_grad = bool(value)

    # -- shape ----------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(s) for s in new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or not all(
                j in (0, i) or i in (0, -1)
                for i, j in zip(self._shape, new_shape)):
            raise AssertionError(
                f"Expected shape {new_shape} is incompatible with given "
                f"shape {self._shape} for Parameter {self.name}")
        self._shape = new_shape

    @property
    def _shape(self):
        return self._shape_v

    @_shape.setter
    def _shape(self, value):
        # every forward asks whether the shape is known: keep the answer
        self._shape_v = value
        self._known = value is not None and all(s > 0 for s in value)

    def _shape_known(self):
        return self._known

    def _infer_shape(self, new_shape):
        """Merge the dims a forward inferred and finish a pending
        deferred initialization."""
        self._shape = tuple(
            int(n) if s in (0, -1) else int(s)
            for s, n in zip(self._shape, new_shape)) \
            if self._shape else tuple(int(n) for n in new_shape)
        if self._deferred_init is not None and self._shape_known():
            self._finish_deferred_init()

    # -- the tensor -----------------------------------------------------
    def _bind(self, owner, key):
        if self._owner is None:
            self._owner, self._key = owner, key

    def _var(self) -> torch.Tensor:
        """The registered tensor (the owner's, should a module have
        replaced it)."""
        if self._owner is not None:
            t = self._owner._parameters.get(self._key)
            if t is not None:
                return t
        return self._tensor

    def _alloc(self, device):
        """Give the tensor this parameter's shape and dtype on
        ``device`` (contents undefined), keeping the object every owner
        registered."""
        var = self._var()
        if tuple(var.shape) != self._shape or var.dtype != self.dtype \
                or var.device != device:
            var.data = torch.empty(self._shape, dtype=self.dtype,
                                   device=device)
        self._leaf = None
        self._nd._grad = None
        return var

    def _check_initialized(self):
        if not self._initialized:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter '{self.name}' has not been initialized yet "
                    f"because initialization was deferred. Actual "
                    f"initialization happens during the first forward "
                    f"pass. Please pass one batch of data through the "
                    f"network before accessing Parameters.")
            raise RuntimeError(
                f"Parameter '{self.name}' has not been initialized: call "
                f"initialize() on the model or set_data() first")

    def _read(self) -> torch.Tensor:
        """The tensor a forward reads (see the module docstring): the
        thread's shadow, a record() leaf, or the registered tensor."""
        bound = getattr(_BOUND, "map", None)
        if bound:
            shadow = bound.get(self)
            if shadow is not None:
                return shadow
        if not self._initialized:
            self._check_initialized()
        var = self._var()
        if self._grad_req == "null" or not _RECORDING.recording:
            return var
        leaf = self._leaf
        if leaf is None or leaf.data_ptr() != var.data_ptr() \
                or leaf.shape != var.shape or leaf.dtype != var.dtype:
            self._grad_nd()
            leaf = var.detach().requires_grad_(True)
            leaf._mx_owner = weakref.ref(self._nd)
            self._leaf = leaf
        return leaf

    # -- initialization -------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None,
                   default_init=initializer.Uniform(), force_reinit=False):
        """Allocate on ``ctx`` (default the current context) and fill:
        ``init``, else the parameter's own ``init``, with
        ``_init_weight``; else ``default_init`` by the name dispatch. A
        shape with unknown dims waits for the first forward (when
        ``allow_deferred_init``)."""
        ctx = ctx or device or current_context()
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise not_ported("initializing on several contexts", 19)
            ctx = ctx[0]
        if self._initialized and not force_reinit:
            return
        self._deferred_init = (init, ctx, default_init)
        if self._shape_known():
            self._finish_deferred_init()
        elif not self._allow_deferred_init:
            raise ValueError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape: {self._shape}. Set allow_deferred_init="
                f"True or specify in_units/in_channels.")

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = None
        var = self._alloc(ctx.torch_device)
        desc = initializer.InitDesc(self.name)
        explicit = init if init is not None else self.init
        with torch.no_grad():
            if explicit is not None:
                initializer.create(explicit)._init_weight(desc, var)
            else:
                initializer.create(default_init)(desc, var)
        self._initialized = True

    # -- accessors ------------------------------------------------------
    def data(self, ctx=None) -> NDArray:
        """The parameter as an NDArray (no copy; see the module
        docstring)."""
        self._check_initialized()
        return self._nd

    def list_data(self):
        return [self.data()]

    def _grad_nd(self) -> NDArray:
        """The gradient buffer, (re)made as zeros when missing or when
        the tensor's shape, dtype or device changed."""
        var = self._var()
        buf = self._nd._grad
        if buf is None or buf._data.shape != var.shape \
                or buf._data.dtype != var.dtype \
                or buf._data.device != var.device:
            buf = NDArray(torch.zeros(var.shape, dtype=var.dtype,
                                      device=var.device), ctx=_ctx_of(var))
            self._nd._grad = buf
        return buf

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer (zeros until a backward writes it): an
        NDArray, overwritten by a ``"write"`` parameter's backward and
        summed into by an ``"add"`` one. A ``"null"`` parameter has none
        and raises."""
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter '{self.name}' "
                f"because grad_req='null'")
        return self._grad_nd()

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [_ctx_of(self._var())]

    def zero_grad(self):
        if self._nd._grad is not None:
            self._nd.zero_grad()

    def _write_grad(self, g):
        """Store ``g`` by ``grad_req`` (overwrite or accumulate) and mark
        it fresh."""
        buf = self._grad_nd()
        g = g.detach().to(buf._data.dtype)
        buf._install(buf._data + g if self._grad_req == "add" else g)
        self._nd._fresh_grad = True

    def set_data(self, data):
        """Write ``data`` (an NDArray, a tensor or an array of this
        parameter's shape) into the parameter, on the parameter's
        device and in its dtype. A parameter not yet initialized takes
        the shape it is given where its dims are unknown."""
        if isinstance(data, NDArray):
            src = data._data.detach()
        elif torch.is_tensor(data):
            src = data.detach()
        else:
            src = torch.as_tensor(onp.asarray(data))
        shape = tuple(src.shape)
        have = self._shape
        if have is not None and (len(have) != len(shape) or any(
                h not in (0, -1, n) for h, n in zip(have, shape))):
            raise ValueError(f"Parameter '{self.name}': shape {shape} "
                             f"does not match {have}")
        if self._initialized:
            var = self._var()
        else:
            self.shape = shape
            pending = self._deferred_init
            self._deferred_init = None
            var = self._var()
            device = pending[1].torch_device if pending is not None \
                else var.device
            var = self._alloc(device)
        with torch.no_grad():
            var.copy_(src.to(device=var.device, dtype=var.dtype))
        self._initialized = True

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a pending deferred
        initialization will allocate there)."""
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise not_ported("parameters on several contexts", 19)
            ctx = ctx[0]
        if self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)
            return
        self._check_initialized()
        var = self._var()
        var.data = var.data.to(ctx.torch_device)
        self._leaf = None
        self._nd._grad = None

    reset_device = reset_ctx

    def cast(self, dtype):
        """Cast the parameter (and its future gradients) to ``dtype``."""
        self.dtype = torch_dtype(dtype)
        var = self._var()
        if self._initialized:
            var.data = var.data.to(self.dtype)
        else:
            var.data = torch.empty(tuple(var.shape), dtype=self.dtype,
                                   device=var.device)
        self._leaf = None
        self._nd._grad = None

    def var(self):
        raise not_ported("Parameter.var (a Symbol variable)", 26)

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self


class Constant(Parameter):
    """A parameter that never changes: ``grad_req`` ``"null"``,
    initialized to ``value``."""

    def __init__(self, value, name="const"):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        elif torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        value = onp.asarray(value)
        self.value = value
        super().__init__(name=name, grad_req="null", shape=value.shape,
                         dtype=value.dtype,
                         init=initializer.InitWithArray(value),
                         differentiable=False)


class ParameterDict(dict):
    """``{name: Parameter}`` with the reference's batched operations."""

    def initialize(self, init=None, device=None, ctx=None,
                   default_init=initializer.Uniform(), force_reinit=False,
                   verbose=False):
        for p in self.values():
            p.initialize(init=init, device=device, ctx=ctx,
                         default_init=default_init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    reset_device = reset_ctx

    def save(self, filename, strip_prefix=""):
        """``mx.save`` of ``{name less strip_prefix: data()}``; a name
        not starting with ``strip_prefix`` raises."""
        from .. import utils_io
        arg_dict = {}
        for name, param in self.items():
            weight = param.data()
            if not name.startswith(strip_prefix):
                raise ValueError(f"Prefix '{strip_prefix}' is to be striped "
                                 f"before saving, but Parameter's name "
                                 f"'{name}' does not start with it")
            arg_dict[name[len(strip_prefix):]] = weight
        utils_io.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a file of :meth:`save` into the parameters (names
        prefixed by ``restore_prefix``), in place; read on the host."""
        from .. import utils_io
        with cpu():
            loaded = utils_io.load(filename)
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self:
                if name not in loaded:
                    raise AssertionError(f"Parameter '{name}' is missing in "
                                         f"file '{filename}'")
        for name, val in loaded.items():
            if name not in self:
                if not ignore_extra:
                    raise ValueError(
                        f"Parameter '{name}' loaded from file '{filename}' "
                        "is not present in this ParameterDict")
                continue
            self[name].set_data(val)


def _host_array(a):
    """A writable numpy copy torch can take (a bfloat16 array, which
    numpy lacks natively, widened to float32)."""
    a = onp.asarray(a)
    return a.astype(onp.float32) if a.dtype.kind not in "biufc" \
        else onp.array(a, order="C")


def load_jax_params(block, params):
    """Fill ``block``'s parameters from the JAX block's
    ``collect_params()`` exported to numpy (``{name: array}``), one name
    to one. Raises on a missing name, an extra name or a shape mismatch
    (a deferred dim matches any size) before writing anything. Each
    parameter keeps its dtype; a deferred one takes the given shape and
    is initialized by it. Returns ``block``."""
    ours = block.collect_params()
    missing = [n for n in ours if n not in params]
    extra = [n for n in params if n not in ours]
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")

    def fits(p, shape):
        have = p.shape or ()
        return len(have) == len(shape) and all(
            s in (0, -1, n) for s, n in zip(have, shape))

    bad = [(n, tuple(onp.shape(params[n])), p.shape)
           for n, p in ours.items() if not fits(p, tuple(onp.shape(params[n])))]
    if bad:
        raise ValueError(f"parameter shapes differ (name, given, "
                         f"expected): {bad}")
    for name, p in ours.items():
        p.set_data(torch.from_numpy(_host_array(params[name])))
    return block
