"""``Block``, ``HybridBlock`` and ``CachedOp`` (the port of
``mxnet_tpu/gluon/block.py``), as ``nn.Module``s.

Assigning a :class:`~.parameter.Parameter` to a block attribute
registers it (its tensor becomes the module's ``nn.Parameter`` of the
same name); assigning a block registers a child, as ``nn.Module`` does.
``collect_params()`` returns the reference's dotted names in the
reference's order (a block's own parameters first, then each child's
in registration order), so a checkpoint of the JAX model loads by name
(:func:`~.parameter.load_jax_params`).

**Tensors or NDArrays.** A block takes ``NDArray`` or tensor inputs
and returns the same kind. The port's own layers write ``forward`` over
tensors (``_tensor_forward``): given tensors, it runs as it is (the GPT
model and ``parallel.TrainStep`` call it so); given NDArrays, the block
runs it on their tensors, with torch's grad mode on only inside
``autograd.record()`` (as ``ops.apply_op`` does for one op), and wraps
the outputs. A user's block writes ``forward`` over NDArrays and gets
NDArrays. Under ``record()`` each parameter with ``grad_req`` not
``"null"`` enters the tape as it is read, so ``loss.backward()`` writes
its ``grad()``; outside ``record()`` no forward builds a graph.

**Hybridize.** The reference traces a hybridized block into one XLA
program per input signature. PyTorch runs eagerly and this port adds no
trace-compile step, so a ``CachedOp`` entry runs the block's forward
eagerly. It keeps the reference's bookkeeping: one entry per signature
(``_signature``: shapes, dtypes, the nesting of the arguments, the
training flag), rebuilt when a parameter was rebound
(``share_parameters``), the ``bucketing`` pad-and-slice on the
inference path, the outermost hybridized block owning the entry, and
the telemetry counters that mean something without XLA
(``gluon.cachedop.cache_miss``/``cache_hit``/``bucket_pad``/``infer``,
the ``signature``/``build``/``run`` durations). With no trace there is
no data-dependent op to fall back from.
"""
from __future__ import annotations

import re
import threading
import warnings
from collections import OrderedDict

import numpy as onp
import torch

from .. import autograd, engine, telemetry
from .. import bucketing as _bucketing
from ..base import narrowing, not_ported
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedOp"]

# bumped whenever a registered Parameter attribute is rebound to a
# different Parameter object (share_parameters, tied weights), so
# CachedOp entries re-validate
_PARAM_REBIND_EPOCH = [0]


class _Local(threading.local):
    def __init__(self):
        self.in_cached = False


_local = _Local()


def _has_ndarray(args, kwargs):
    for a in args:
        if isinstance(a, NDArray):
            return True
    for a in kwargs.values():
        if isinstance(a, NDArray):
            return True
    return False


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x, ctx):
    """Tensors of a forward's result as NDArrays (the 64-bit narrowing
    and engine tracking of ``ops.apply_op``)."""
    if torch.is_tensor(x):
        narrow = narrowing().get(x.dtype)
        if narrow is not None:
            x = x.to(narrow)
        return NDArray(engine.track(x), ctx=ctx)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v, ctx) for v in x)
    return x


def _first_ctx(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a.ctx
    return None


def _flatten(args):
    """Array leaves (NDArrays or tensors) of nested arguments and a
    hashable spec of the nesting (other values are static)."""
    leaves = []

    def walk(x):
        if isinstance(x, NDArray) or torch.is_tensor(x):
            leaves.append(x)
            return ("arr", len(leaves) - 1)
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in sorted(x.items())))
        return ("static", repr(x))

    return leaves, walk(list(args))


def _maybe_transpose_conv_kernel(name, p, val):
    """Transpose a reference-written NCHW convolution kernel (O, I, H,
    W) into a channels-last layer's (O, H, W, I), for parameters a
    ``Conv2D`` tagged ``_kernel_layout == "OHWI"`` only (the reference's
    rule, ``mxnet_tpu/gluon/block.py:52``): a shape that already fits is
    kept; with ``in_channels`` deferred the kernel's (H, W) dims tell the
    layout, and a kernel where both readings fit raises."""
    if getattr(p, "_kernel_layout", None) != "OHWI" \
            or getattr(val, "ndim", 0) != 4:
        return val
    kh, kw = p._kernel_hw
    shape = tuple(val.shape)
    if p._shape_known():
        expected = tuple(p.shape)
        if shape == expected:
            return val
        if (shape[0], shape[2], shape[3], shape[1]) == expected:
            warnings.warn(
                f"Parameter '{name}': loaded kernel {shape} treated as "
                f"reference NCHW (O,I,H,W) and transposed to {expected}"
                f" (O,H,W,I). If this checkpoint was NOT written by an "
                f"NCHW model, the weights are mis-permuted.",
                UserWarning, stacklevel=4)
            return val.transpose((0, 2, 3, 1))
        return val  # set_data raises its shape error
    looks_ohwi = shape[1:3] == (kh, kw)
    looks_oihw = shape[2:4] == (kh, kw)
    if looks_ohwi and looks_oihw:
        raise ValueError(
            f"Parameter '{name}': cannot tell whether the checkpoint "
            f"kernel {shape} is NCHW (O,I,H,W) or NHWC (O,H,W,I) — "
            f"kernel {kh}x{kw} with matching channel count is "
            f"ambiguous while in_channels is deferred. Run one forward "
            f"pass (or construct the layer with in_channels=...) "
            f"before load_parameters.")
    if looks_oihw:
        return val.transpose((0, 2, 3, 1))
    return val


class _HookHandle:
    def __init__(self, hooks, key):
        self._hooks = hooks
        self._key = key

    def remove(self):
        self._hooks.pop(self._key, None)

    # the reference's HookHandle spells it detach()
    detach = remove


class Block(torch.nn.Module):
    """Base class of every layer and model."""

    #: the layer's ``forward`` is written over tensors (see the module
    #: docstring); a user's block (False) gets NDArrays as it is called
    _tensor_forward = False

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_reg_params", OrderedDict())
        object.__setattr__(self, "_mx_pre_hooks", OrderedDict())
        object.__setattr__(self, "_mx_hooks", OrderedDict())
        object.__setattr__(self, "_hook_seq", [0])

    # -- registration ---------------------------------------------------
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            if reg.get(name) is not value:
                _PARAM_REBIND_EPOCH[0] += 1
            self._modules.pop(name, None)
            reg[name] = value
            self._parameters[name] = value._var()
            value._bind(self, name)
            object.__setattr__(self, name, value)
            return
        if reg is not None and name in reg:
            # a registered parameter overwritten by something else is
            # deregistered (collect_params keeps no ghost)
            del reg[name]
            self._parameters.pop(name, None)
            self.__dict__.pop(name, None)
            _PARAM_REBIND_EPOCH[0] += 1
        elif isinstance(value, Block) and self._modules.get(name) \
                is not value and name in self._modules:
            _PARAM_REBIND_EPOCH[0] += 1
        super().__setattr__(name, value)

    @property
    def _children(self):
        return OrderedDict((k, v) for k, v in self._modules.items()
                           if isinstance(v, Block))

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)
        return block

    def _hook(self, hooks, hook):
        key = self._hook_seq[0]
        self._hook_seq[0] += 1
        hooks[key] = hook
        return _HookHandle(hooks, key)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward."""
        return self._hook(self._mx_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each forward."""
        return self._hook(self._mx_hooks, hook)

    # -- parameters -----------------------------------------------------
    def collect_params(self, select=None) -> ParameterDict:
        """Every Parameter of this block and its children, keyed by
        dotted attribute path; ``select`` keeps the names a regular
        expression matches (``re.match``)."""
        out = ParameterDict()

        def walk(block, prefix):
            for name, p in block._reg_params.items():
                key = f"{prefix}{name}"
                p._structured_name = key
                out[key] = p
            for cname, child in block._modules.items():
                if isinstance(child, Block):
                    walk(child, f"{prefix}{cname}.")

        walk(self, "")
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, v) for k, v in out.items()
                                if pat.match(k))
        return out

    @property
    def params(self):
        return ParameterDict(self._reg_params)

    def share_parameters(self, shared):
        """Tie this block's Parameters to ``shared`` (a dict like
        ``collect_params()``'s), matched by dotted path relative to this
        block: the Parameter objects are shared. Returns self."""
        if shared is None:
            return self
        if not isinstance(shared, dict):
            raise ValueError(f"'shared' should be in type of Dict. Get "
                             f"type {type(shared)}!")
        left = set(shared.keys())
        self._shared_parameters(shared, left)
        for name in left:
            warnings.warn(f"Parameter name {name} is not in the current "
                          f"model!")
        return self

    def _shared_parameters(self, shared, left, prefix=""):
        if prefix:
            prefix += "."
        for name in list(self._reg_params):
            key = prefix + name
            if shared.get(key) is not None:
                setattr(self, name, shared[key])
                left.discard(key)
        for name, child in self._children.items():
            child._shared_parameters(shared, left, prefix + name)
        self._clear_cached_op()

    def initialize(self, init=None, device=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (the current context by
        default): ``init`` (default ``Uniform()``) by the name dispatch,
        unless a parameter has its own initializer."""
        from .. import initializer
        self.collect_params().initialize(
            init=None, device=device, ctx=ctx,
            default_init=init if init is not None else initializer.Uniform(),
            force_reinit=force_reinit)

    def zero_grad(self, set_to_none=None):  # noqa: ARG002 - torch's name
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        self.collect_params().reset_ctx(ctx)

    reset_device = reset_ctx

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        self._clear_cached_op()

    def _clear_cached_op(self):
        pass

    def save_parameters(self, filename, deduplicate=False):
        """Write every initialized parameter to ``filename`` (``mx.save``
        of ``{dotted name: data()}``)."""
        from .. import utils_io
        utils_io.save(filename, {k: p.data() for k, p in
                                 self.collect_params().items()
                                 if p._initialized})

    def load_parameters(self, filename, device=None, ctx=None,
                        allow_missing=False, ignore_extra=False,
                        cast_dtype=False, dtype_source="current"):
        """Read a file of :meth:`save_parameters` (either package's, or
        a legacy ``.params``) into the parameters by name, in place:
        each keeps its storage (a hybridized entry and a ``Trainer``
        hold those tensors). ``cast_dtype`` casts each parameter first,
        to the saved dtype with ``dtype_source="saved"``; a channels-last
        2-d convolution's kernel saved as (O, I, H, W) is transposed
        (``_maybe_transpose_conv_kernel``). The file is read on the
        host and each value copied to its parameter's device; a
        parameter initialized here goes to ``ctx`` when it is given."""
        from .. import utils_io
        from ..context import cpu
        with cpu():
            loaded = utils_io.load(filename)
        params = self.collect_params()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError(
                        f"Parameter '{name}' is missing in '{filename}'")
        ctx = ctx or device
        for name, val in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError(
                        f"Parameter '{name}' loaded from '{filename}' is "
                        "not present in the Block")
                continue
            p = params[name]
            if cast_dtype:
                p.cast(val.dtype if dtype_source == "saved" else p.dtype)
            val = _maybe_transpose_conv_kernel(name, p, val)
            fresh = not p._initialized
            p.set_data(val)
            if fresh and ctx is not None:
                p.reset_ctx(ctx)

    def save(self, prefix):
        """``save_parameters`` to ``{prefix}-model.params``."""
        self.save_parameters(f"{prefix}-model.params")

    def load(self, prefix):
        """``load_parameters`` from ``{prefix}-model.params``."""
        self.load_parameters(f"{prefix}-model.params")

    # -- execution ------------------------------------------------------
    #: a hybridized block's calls go through its CachedOp (HybridBlock)
    _active = False

    def __call__(self, *args, **kwargs):
        # the GPT model calls its layers on every decode step: the plain
        # path stays one frame above torch's own
        if self._active and not kwargs and not _local.in_cached:
            run = self._cached()
        elif self._mx_pre_hooks or self._mx_hooks:
            def run(*a):
                return self._run(a, kwargs)
        elif self._tensor_forward and not (
                args and type(args[0]) is torch.Tensor):
            return self._run(args, kwargs)
        else:
            return self._call_impl(*args, **kwargs)
        for hook in list(self._mx_pre_hooks.values()):
            hook(self, args)
        out = run(*args)
        for hook in list(self._mx_hooks.values()):
            hook(self, args, out)
        return out

    def _run(self, args, kwargs):
        """One forward: a tensor forward given NDArrays runs on their
        tensors (see the module docstring)."""
        if self._tensor_forward and _has_ndarray(args, kwargs):
            ctx = _first_ctx(args, kwargs)
            targs = _unwrap(args)
            tkw = {k: _unwrap(v) for k, v in kwargs.items()}
            with torch.set_grad_enabled(autograd.is_recording()):
                out = self._call_impl(*targs, **tkw)
            return _wrap(out, ctx)
        return self._call_impl(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print each block's output shapes and parameter count after a
        forward of ``inputs``."""
        rows = []

        def hook(block, ins, out):
            outs = out if isinstance(out, (list, tuple)) else [out]
            shapes = [tuple(o.shape) for o in outs
                      if isinstance(o, NDArray) or torch.is_tensor(o)]
            n_params = sum(int(onp.prod(p.shape))
                           for p in block._reg_params.values()
                           if p._shape_known())
            rows.append((type(block).__name__, shapes, n_params))

        handles = [blk.register_forward_hook(hook)
                   for blk in self._iter_blocks()]
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        print(f"{'Layer':<30}{'Output Shape':<30}{'Params':<15}")
        print("=" * 75)
        total = 0
        for name, shapes, n in rows:
            print(f"{name:<30}{str(shapes):<30}{n:<15}")
            total += n
        print("=" * 75)
        print(f"Total params: {total}")

    def _iter_blocks(self):
        yield self
        for child in self._children.values():
            yield from child._iter_blocks()


class _CachedEntry:
    __slots__ = ("params", "epoch")


class CachedOp:
    """A hybridized block's per-signature entries (the counterpart of
    the reference's whole-graph executor). An entry runs the block's
    forward eagerly."""

    def __init__(self, block: "HybridBlock"):
        self.block = block
        self._entries = {}

    def _signature(self, leaves, spec, training):
        return (tuple((tuple(l.shape), str(l.dtype)) for l in leaves),
                spec, training)

    def _entry(self, leaves, spec, training):
        t_sig = telemetry.clock()
        key = self._signature(leaves, spec, training)
        telemetry.duration_since("gluon.cachedop.signature", t_sig)
        entry = self._entries.get(key)
        if entry is not None and entry.epoch != _PARAM_REBIND_EPOCH[0]:
            # some Parameter was rebound since: re-validate against the
            # live parameter set
            current = list(self.block.collect_params().values())
            if [id(p) for p in current] != [id(p) for p in entry.params]:
                self._entries.clear()
                entry = None
            else:
                entry.epoch = _PARAM_REBIND_EPOCH[0]
        if entry is None:
            telemetry.counter("gluon.cachedop.cache_miss")
            t0 = telemetry.clock()
            entry = _CachedEntry()
            entry.params = list(self.block.collect_params().values())
            entry.epoch = _PARAM_REBIND_EPOCH[0]
            self._entries[key] = entry
            telemetry.duration_since("gluon.cachedop.build", t0)
        else:
            telemetry.counter("gluon.cachedop.cache_hit")
        return entry

    def warmup(self, *args, training=False):
        """Make the entry of these template inputs' signature, finishing
        deferred initialization (a forward in predict mode, off the
        tape)."""
        leaves, spec = _flatten(args)
        if any(not p._initialized for p in
               self.block.collect_params().values()):
            self.block.infer_shape(*args)
        self._entry(leaves, spec, training)
        return self

    def __call__(self, *args):
        leaves, spec = _flatten(args)
        training = autograd.is_training()
        # bucketing: pad an off-bucket batch up to its bucket and slice
        # the outputs back (the inference path only: under record() the
        # input gradients would come back padded)
        pad_n, orig = 0, None
        policy = _bucketing.get_policy()
        if policy is not None and not autograd.is_recording() and leaves:
            dims = [l.shape[0] for l in leaves if len(l.shape)]
            if dims and all(d == dims[0] for d in dims):
                orig = dims[0]
                target = policy.bucket(orig)
                if target > orig:
                    telemetry.counter("gluon.cachedop.bucket_pad")
                    padded, pad_n = _bucketing.pad_leaves(leaves, target,
                                                          orig)
                    args = _rebuild_args(args, leaves, padded)
                    leaves = padded
        self._entry(leaves, spec, training)
        t0 = telemetry.clock()
        prev = _local.in_cached
        _local.in_cached = True
        try:
            out = self.block._run(args, {})
        finally:
            _local.in_cached = prev
        telemetry.duration_since("gluon.cachedop.run", t0)
        if pad_n:
            out = _slice_back(out, orig, orig + pad_n)
        return out

    def infer(self, *args):
        """The inference path: the entry's forward with no hooks, in
        predict mode and off the tape unless the caller is recording or
        training (then the full call)."""
        if autograd.is_recording() or autograd.is_training():
            return self.block(*args)
        telemetry.counter("gluon.cachedop.infer")
        return self(*args)


def _rebuild_args(args, old, new):
    swap = {id(o): n for o, n in zip(old, new)}

    def walk(x):
        if id(x) in swap:
            return swap[id(x)]
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x
    return walk(args)


def _slice_back(out, orig, padded):
    if isinstance(out, (list, tuple)):
        return type(out)(_slice_back(o, orig, padded) for o in out)
    if (isinstance(out, NDArray) or torch.is_tensor(out)) \
            and len(out.shape) and out.shape[0] == padded:
        return out[0:orig]
    return out


class HybridBlock(Block):
    """A Block that can be hybridized (see the module docstring)."""

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_active", False)
        object.__setattr__(self, "_cached_op", None)

    def hybridize(self, active=True, **kwargs):
        """Route calls through a ``CachedOp``; only the outermost active
        block owns one, and children called inside it run their plain
        forward. ``static_alloc``, ``static_shape`` and a backend name
        are accepted as in the reference and change nothing: there is no
        trace to plan."""
        object.__setattr__(self, "_active", bool(active))
        object.__setattr__(self, "_cached_op", None)
        super().hybridize(active, **kwargs)

    def _clear_cached_op(self):
        object.__setattr__(self, "_cached_op", None)

    def _cached(self):
        if self._cached_op is None:
            object.__setattr__(self, "_cached_op", CachedOp(self))
        return self._cached_op

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Hybridize and run once (the reference's backend partitioning
        is its XLA compile; the port has none to choose)."""
        self.hybridize(True)
        return self(x, *args)

    def infer_shape(self, *args):
        """Finish deferred shape inference with one forward of a batch-1
        slice of the inputs (all of them if that fails), in predict mode
        and off the tape."""
        probes = [a[0:1] if (isinstance(a, NDArray) or torch.is_tensor(a))
                  and len(a.shape) and a.shape[0] > 1 else a for a in args]
        prev = _local.in_cached
        _local.in_cached = True
        try:
            with autograd.pause(train_mode=False), torch.no_grad():
                try:
                    self._run(tuple(probes), {})
                except Exception:  # noqa: BLE001 - batch not on axis 0
                    self._run(args, {})
        finally:
            _local.in_cached = prev

    def warmup(self, *args, training=False):
        """Hybridize and make the entry of these template inputs ahead
        of the first real call."""
        if not self._active:
            self.hybridize(True)
        self._cached().warmup(*args, training=training)
        return self

    def infer(self, *args):
        """Inference through the entry, with no hooks (see
        ``CachedOp.infer``)."""
        if not self._active:
            self.hybridize(True)
        return self._cached().infer(*args)

    def export(self, path, epoch=0, remove_amp_cast=True):
        raise not_ported("HybridBlock.export", "15c")

    def forward(self, *args, **kwargs):
        raise NotImplementedError
