"""Define-by-run autograd on ``torch.autograd`` (the port of
``mxnet_tpu/autograd.py``).

The reference captures each op's VJP on its own tape; the port lets
torch record the graph and keeps MXNet's semantics around it:

- ``record()``/``pause()`` decide whether ops build a graph at all
  (``ops.apply_op`` turns torch's grad mode on only inside ``record()``
  and only when an input is on the tape);
- ``backward`` writes ``.grad`` buffers by grad_req: ``write``
  OVERWRITES (two backward calls give the same value), ``add``
  accumulates. It runs ``torch.autograd.grad`` on the leaf tensors it
  finds in the heads' graph and writes each gradient to the NDArray
  that owns the leaf (``NDArray._mx_owner``), so an array written after
  the forward still gets the gradient of the value the forward used;
- a head that is not on the tape raises ``ValueError``; a second
  backward through a graph freed by the first raises ``RuntimeError``
  with the reference's message;
- ``grad(..., variables=)`` returns zeros for a variable the heads do
  not depend on; ``create_graph=True`` gives differentiable gradients;
- ``Function`` runs its ``forward`` under ``pause()`` and becomes a
  ``torch.autograd.Function`` that carries the instance, so state kept
  on ``self`` between ``forward`` and ``backward`` works.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training",
           "mark_variables", "backward", "grad", "Function"]

_FREED_MSG = ("backward through the graph failed: the graph has already "
              "been freed by a previous backward(). Pass retain_graph=True "
              "to backward() to backprop through the same graph twice.")


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------
class _RecordingScope:
    def __init__(self, recording: bool, training: Optional[bool]):
        self._recording = recording
        self._training = training
        self._prev = None

    def __enter__(self):
        self._prev = (_state.recording, _state.training)
        _state.recording = self._recording
        if self._training is not None:
            _state.training = self._training
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training = self._prev
        return False


def record(train_mode: bool = True):
    """Scope in which executed ops are recorded for backward()."""
    return _RecordingScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope in which recording is suspended."""
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(_state.recording, True)


def predict_mode():
    return _RecordingScope(_state.recording, False)


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_record: bool) -> bool:
    prev, _state.recording = _state.recording, is_record
    return prev


def set_training(train: bool) -> bool:
    prev, _state.training = _state.training, train
    return prev


def _on_tape(arr) -> bool:
    """True if this array participates in the current tape."""
    return arr._data.requires_grad


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to arrays (parity: autograd.mark_variables)."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables = [variables]
    if isinstance(gradients, NDArray):
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g
        v._grad_req = req
        v._set_data(v._data.detach())


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------
def _owned_leaves(heads):
    """The leaf tensors of the heads' graph that an NDArray owns, each
    once, found by walking ``next_functions`` to the AccumulateGrad
    nodes."""
    leaves, seen_leaf, seen_fn = [], set(), set()
    keep = []                       # hold nodes so ids stay unique
    stack = []
    for t in heads:
        if t.grad_fn is not None:
            stack.append(t.grad_fn)
        elif id(t) not in seen_leaf:          # a head that is a leaf
            seen_leaf.add(id(t))
            leaves.append(t)
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen_fn:
            continue
        seen_fn.add(id(fn))
        keep.append(fn)
        var = getattr(fn, "variable", None)       # AccumulateGrad
        if var is not None:
            if id(var) not in seen_leaf:
                seen_leaf.add(id(var))
                leaves.append(var)
            continue
        stack.extend(nxt for nxt, _ in fn.next_functions)
    out = []
    for t in leaves:
        ref = getattr(t, "_mx_owner", None)
        owner = ref() if ref is not None else None
        if owner is not None and owner._grad is not None \
                and owner._grad_req != "null":
            out.append((t, owner))
    return out


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             variables=None, create_graph=False):
    """Run backward from ``heads``.

    If ``variables`` is None, gradients are written into the ``.grad``
    buffers of marked arrays (grad_req 'write' overwrites, 'add'
    accumulates). Otherwise gradients w.r.t. ``variables`` are returned
    and ``.grad`` buffers are untouched (parity: autograd.grad).
    """
    from .ndarray.ndarray import NDArray
    from . import engine

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]

    hts, gos = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            raise ValueError(
                "cannot differentiate a head that is not on the tape; "
                "wrap the forward in autograd.record() and/or "
                "attach_grad()")
        if t.grad_fn is not None and t.grad_fn.metadata.get("mx_freed"):
            raise RuntimeError(_FREED_MSG)
        if hg is None:
            g = torch.ones_like(t, requires_grad=False)
        else:
            g = hg._data if isinstance(hg, NDArray) else torch.as_tensor(hg)
            g = g.detach().to(device=t.device, dtype=t.dtype)
        hts.append(t)
        gos.append(g)

    if variables is not None:
        inputs = [v._data for v in variables]
        idx = [i for i, t in enumerate(inputs) if t.requires_grad]
        targets = [inputs[i] for i in idx]
    else:
        owned = _owned_leaves(hts)
        targets = [t for t, _ in owned]

    keep = retain_graph or create_graph
    grads = ()
    if targets:
        with _RecordingScope(create_graph, train_mode):
            try:
                grads = torch.autograd.grad(
                    hts, targets, gos, retain_graph=keep,
                    create_graph=create_graph, allow_unused=True)
            except RuntimeError as e:
                if "second time" in str(e):
                    raise RuntimeError(_FREED_MSG) from e
                raise
    if not keep:
        for t in hts:
            if t.grad_fn is not None:
                t.grad_fn.metadata["mx_freed"] = True

    if variables is not None:
        out = [None] * len(variables)
        for i, g in zip(idx, grads):
            out[i] = g
        res = []
        for v, g in zip(variables, out):
            if g is None:
                g = torch.zeros_like(v._data, requires_grad=False)
            elif not create_graph:
                g = g.detach()
            res.append(NDArray(engine.track(g), ctx=v.ctx))
        return res

    # write into .grad buffers; two leaves of one array (a write after
    # the forward) sum into it
    per_owner = {}
    for (_, owner), g in zip(owned, grads):
        if g is None:
            continue
        g = g.detach()
        cur = per_owner.get(id(owner))
        per_owner[id(owner)] = (owner, g if cur is None else cur[1] + g)
    for owner, g in per_owner.values():
        buf = owner._grad
        if owner._grad_req == "add":
            g = buf._data + g
        buf._data = engine.track(g.to(buf._data.dtype))
        buf._version += 1
        owner._fresh_grad = True
    return None


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Functional gradient computation (parity: mx.autograd.grad)."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    return backward(heads, head_grads=head_grads, retain_graph=retain_graph,
                    train_mode=train_mode, variables=variables,
                    create_graph=create_graph)


# ---------------------------------------------------------------------------
# custom Function (parity: mx.autograd.Function)
# ---------------------------------------------------------------------------
class _FunctionBridge(torch.autograd.Function):
    """Runs an ``autograd.Function`` instance as a torch Function: the
    instance rides on ``ctx``; the NDArray inputs come in as tensors."""

    @staticmethod
    def forward(ctx, func, inputs, nd_pos, *tensors):
        from .ndarray.ndarray import NDArray
        args = list(inputs)
        for i, t in zip(nd_pos, tensors):
            args[i] = NDArray(t.detach(), ctx=inputs[i].ctx)
        with pause():
            outputs = func.forward(*args)
        single = not isinstance(outputs, (tuple, list))
        outs = (outputs,) if single else tuple(outputs)
        ctx.func, ctx.n_inputs, ctx.nd_pos = func, len(inputs), nd_pos
        ctx.out_ctx = [o.ctx for o in outs]
        ctx.in_meta = [(t.dtype, t.device) for t in tensors]
        res = tuple(o._data for o in outs)
        return res[0] if single else res

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        with pause():
            ct_nd = [NDArray(c, ctx=oc) for c, oc in zip(cts, ctx.out_ctx)]
            in_grads = ctx.func.backward(*ct_nd)
        if not isinstance(in_grads, (tuple, list)):
            in_grads = (in_grads,)
        # a grad for every input, or one for each NDArray input
        if len(in_grads) == ctx.n_inputs:
            in_grads = [in_grads[i] for i in ctx.nd_pos]
        gs = []
        for g, (dt, dev) in zip(in_grads, ctx.in_meta):
            if isinstance(g, NDArray):
                g = g._data
            elif g is not None:
                g = torch.as_tensor(g)
            gs.append(None if g is None else g.to(device=dev, dtype=dt))
        return (None, None, None, *gs)


class Function:
    """User-defined differentiable function.

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` operating on NDArrays. Call the
    instance inside autograd.record(); saved state may be stashed on
    ``self`` between forward and backward (e.g. via save_for_backward).
    """

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        from . import engine

        nd_pos = [i for i, a in enumerate(inputs) if isinstance(a, NDArray)]
        if not (is_recording()
                and any(inputs[i]._data.requires_grad for i in nd_pos)):
            with pause():
                return self.forward(*inputs)
        with torch.enable_grad():
            res = _FunctionBridge.apply(self, inputs, nd_pos,
                                        *[inputs[i]._data for i in nd_pos])
        octx = inputs[nd_pos[0]].ctx
        if isinstance(res, torch.Tensor):
            return NDArray(engine.track(res), ctx=octx)
        return tuple(NDArray(engine.track(r), ctx=octx) for r in res)
