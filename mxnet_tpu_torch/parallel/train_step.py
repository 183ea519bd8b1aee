"""The training step of the port: forward, backward and the optimizer
update of one batch, on one device.

Counterpart of ``mxnet_tpu/parallel/train_step.py:71-1027``. The
reference compiles ``loss_fn(net(data), label)``, its gradient and the
update into one XLA program; PyTorch runs eagerly, so here one step is
the same sequence run op by op:

1. count the update, then read the optimizer's hyperparameters;
2. run the forward in training mode (the reference's
   ``_RecordingScope(False, True)``: ``Dropout`` acts), with each
   differentiated parameter replaced by a leaf tensor that shares its
   storage (``bind_shadows``; the parameters themselves never require
   grad, so no other call builds a graph);
3. take the loss mean over the valid rows only, by a ``where`` (a
   padded row's non-finite loss cannot poison the sum);
4. take the gradients of the parameters whose ``grad_req`` is not
   ``"null"`` (``torch.autograd.grad``);
5. apply the optimizer's ``_step`` (or ``_step_mp`` for a 16-bit weight
   with an fp32 master) to every such parameter, in place, under
   ``no_grad``.

``compute_dtype="bfloat16"`` casts the floating parameters (the leaves)
and inputs to bf16 inside the differentiated forward, so the cast's
backward returns fp32 gradients to the fp32 masters; the loss is
reported in fp32, and LayerNorm and softmax accumulate in fp32 as the
serving path's bf16 does. The GPT model's attention is
``ops.attention.flash_attention``: K1 forward and K1-bwd backward on the
card.

Optimizer states are created once and shared across batch signatures,
so a last odd batch does not reset Adam. ``run_chain`` runs a leading
steps axis as a Python loop with the reference's counting (the LR held
for the chain, Adam's ``t`` advancing by each step's offset). A mesh,
``param_rules`` or ``layout`` waits for ROADMAP.md queue 1, item 20;
``donate`` and ``overlap_gather`` are accepted and have no effect (the
updates are in place, and nothing is gathered on one device).
"""
from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as onp
import torch

from .. import autograd
from .. import bucketing as _bucketing
from .. import telemetry
from ..base import not_ported, resolve_dtype
from ..gluon.parameter import bind_shadows
from ..ndarray.ndarray import NDArray
from ..optimizer import assign_state

__all__ = ["TrainStep"]


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def _tensor(x):
    """The tensor of a batch leaf: an NDArray's, a tensor, or an array."""
    if isinstance(x, NDArray):
        return x._data
    return x if torch.is_tensor(x) else torch.as_tensor(onp.asarray(x))


def _batch_size(leaves):
    return next((l.shape[0] for l in leaves if l.dim()), 1)


class TrainStep:
    """``loss_fn(net(data), label)``, its gradient and the optimizer
    update, one call per batch.

    Parameters
    ----------
    net : HybridBlock whose forward takes the data leaves
    loss_fn : callable(out, *label) -> per-sample loss (``gluon.loss.*``)
        or a scalar; None takes the net's output as the loss
    optimizer : ``optimizer.Optimizer`` or its registered name
    optimizer_params : dict for ``optimizer.create``
    mesh, param_rules, layout : sharded training, not ported (item 20)
    batch_axis, donate, overlap_gather : accepted, no effect here
    bucketing : BucketingPolicy; None inherits the global policy, False
        opts out. An odd batch is padded up to its bucket and the padded
        rows are masked out of the loss.
    compute_dtype : None / ``"float32"`` or ``"bfloat16"``
    """

    def __init__(self, net, loss_fn, optimizer, optimizer_params=None,
                 mesh=None, batch_axis="dp", param_rules=None,
                 layout=None, donate=True, bucketing=None,
                 compute_dtype=None, overlap_gather=True):
        from .. import optimizer as opt_mod
        if mesh is not None or param_rules or layout is not None:
            raise not_ported("TrainStep over a device mesh (mesh=, "
                             "param_rules=, layout=)", 20)
        self.net = net
        self.loss_fn = loss_fn
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.optimizer = optimizer
        self.batch_axis = batch_axis
        self.donate = donate
        self.overlap_gather = bool(overlap_gather)
        if compute_dtype is None or str(compute_dtype) == "float32":
            self.compute_dtype = "float32"
            self._cast_dt = None
        elif str(compute_dtype) == "bfloat16":
            self.compute_dtype = "bfloat16"
            self._cast_dt = torch.bfloat16
        else:
            raise ValueError(
                f"TrainStep compute_dtype must be None, 'float32' or "
                f"'bfloat16', got {compute_dtype!r}")
        self.bucketing = False if bucketing is False \
            else _bucketing.as_policy(bucketing)
        self._entries = {}
        self._opt_states = None   # shared across signatures: a shape
        self._mp_flags = None     # change must not reset Adam/momentum
        self._warned_scalar_loss = False

    @property
    def mesh(self):
        return None

    # -- build -----------------------------------------------------------
    def _build(self):
        params = self.net.collect_params()
        diff = OrderedDict((n, p) for n, p in params.items()
                           if p.grad_req != "null")
        frozen = [p for p in params.values() if p.grad_req == "null"]
        opt = self.optimizer
        if self._opt_states is None:
            self._opt_states = [
                opt.create_state_multi_precision(k, p._var())
                for k, p in enumerate(diff.values())]
            self._mp_flags = [opt._use_mp(p._var()) for p in diff.values()]
        return {"diff": diff, "frozen": frozen, "device": self._device(),
                "scalar_loss": False}

    def _device(self):
        """The net's device (its first parameter's)."""
        return next(iter(self.net.collect_params().values()))._var().device

    @staticmethod
    def _sig(data, labels):
        return (tuple((tuple(l.shape), str(l.dtype)) for l in data),
                tuple((tuple(l.shape), str(l.dtype)) for l in labels))

    def _get_entry(self, data, labels):
        sig = self._sig(data, labels)
        entry = self._entries.get(sig)
        if entry is None:
            telemetry.counter("parallel.train_step.build")
            t0 = telemetry.clock()
            entry = self._build()
            telemetry.duration_since("parallel.train_step.build", t0)
            self._entries[sig] = entry
        return sig, entry

    # -- bucketing ---------------------------------------------------------
    def _effective_policy(self):
        if self.bucketing is False:
            return None
        return self.bucketing if self.bucketing is not None \
            else _bucketing.get_policy()

    def _apply_bucketing(self, data, labels, pad):
        """Resolve the pad count of one batch: an explicit ``pad`` wins,
        then the pipeline's pad marks, then the active bucketing policy
        (which pads the leaves here). Returns (data, labels, pad) as
        tensors."""
        explicit = pad is not None
        if not explicit:
            pad = max([_bucketing.get_pad(l) for l in data + labels]
                      or [0])
        data = [_tensor(l) for l in data]
        labels = [_tensor(l) for l in labels]
        policy = None if explicit or pad else self._effective_policy()
        if policy is not None:
            bsz = _batch_size(data)
            target = policy.bucket(bsz)
            if target > bsz:
                telemetry.counter("parallel.train_step.bucket_pad")
                data, pad = _bucketing.pad_leaves(data, target, bsz)
                labels, _ = _bucketing.pad_leaves(labels, target, bsz)
        return data, labels, int(pad)

    def _check_maskable(self, entry, pad):
        """A padded batch whose loss_fn already reduced to a scalar cannot
        be masked: the padded rows WILL contribute. Warn once."""
        if pad and entry["scalar_loss"] and not self._warned_scalar_loss:
            self._warned_scalar_loss = True
            warnings.warn(
                "TrainStep received a padded batch but loss_fn returns "
                "a scalar (already reduced over the batch): padded rows "
                "cannot be masked out of the loss and WILL affect "
                "training. Return a per-sample loss (gluon.loss.* "
                "default) to make padding exact, or disable bucketing "
                "for this step (bucketing=False).")

    # -- one step ----------------------------------------------------------
    def _loss_and_grads(self, entry, data, labels, n_valid):
        """The loss (0-d fp32, detached) and the gradient of every
        differentiated parameter, in ``entry["diff"]``'s order."""
        dev, cast = entry["device"], self._cast_dt
        data = [l.to(dev) for l in data]
        labels = [l.to(dev) for l in labels]
        diff = list(entry["diff"].values())
        leaves = [p._var().detach().requires_grad_(True) for p in diff]
        with torch.enable_grad():
            bind = {}
            for p, leaf in zip(diff, leaves):
                bind[p] = leaf.to(cast) \
                    if cast is not None and leaf.is_floating_point() else leaf
            if cast is not None:
                for p in entry["frozen"]:
                    if p._var().is_floating_point():
                        bind[p] = p._var().to(cast)
                data = [l.to(cast) if l.is_floating_point() else l
                        for l in data]
            with bind_shadows(bind), autograd._RecordingScope(False, True):
                out = self.net(*data)
                loss = self.loss_fn(out, *labels) \
                    if self.loss_fn is not None else out
            if loss.dim() > 0:
                # the mean over the VALID rows only; with n_valid equal
                # to the batch this is exactly loss.mean()
                rows = loss.shape[0]
                mask = (torch.arange(rows, device=loss.device) < n_valid
                        ).reshape((rows,) + (1,) * (loss.dim() - 1))
                denom = max(n_valid, 1) * (loss.numel() // rows)
                loss = torch.where(mask, loss, torch.zeros_like(loss)) \
                    .sum() / denom
            else:
                entry["scalar_loss"] = True
            loss = loss.float()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for l, g in zip(leaves, grads)]
        return loss.detach(), grads

    def _update(self, entry, grads, hypers):
        cls = type(self.optimizer)
        with torch.no_grad():
            for k, (p, g) in enumerate(zip(entry["diff"].values(), grads)):
                w, state, h = p._var(), self._opt_states[k], hypers[k]
                if self._mp_flags[k]:
                    new_w, new_s = cls._step_mp(w, g, state, h)
                else:
                    new_w, new_s = cls._step(w, g.to(w.dtype), state, h)
                w.copy_(new_w)
                assign_state(state, new_s)

    def _prepare(self, data, label, pad):
        data, label = list(_as_tuple(data)), list(_as_tuple(label))
        wrap = any(isinstance(x, NDArray) for x in data + label)
        data, label, pad = self._apply_bucketing(data, label, pad)
        _, entry = self._get_entry(data, label)
        return data, label, pad, entry, wrap

    def __call__(self, data, label, pad=None):
        """Run one training step; returns the loss, a 0-d fp32 tensor (an
        NDArray when the batch came as NDArrays). ``pad`` marks the
        trailing rows of the batch as padding; when None, pad marks left
        on the arrays by the data pipeline apply, and an active bucketing
        policy pads an odd batch here."""
        data, label, pad, entry, wrap = self._prepare(data, label, pad)
        opt = self.optimizer
        n_diff = len(entry["diff"])
        opt._update_count(list(range(n_diff)))
        hypers = [opt._hyper(k) for k in range(n_diff)]
        t0 = telemetry.clock()
        loss, grads = self._loss_and_grads(
            entry, data, label, _batch_size(data) - pad)
        self._update(entry, grads, hypers)
        telemetry.duration_since("parallel.train_step.run", t0)
        self._check_maskable(entry, pad)
        return NDArray(loss) if wrap else loss

    def gradients(self, data, label, pad=None):
        """The loss and the gradients one step would apply, without
        counting or applying an update: ``(loss, {name: gradient})``.
        Each differentiated parameter's ``grad()`` buffer also receives
        its gradient by its ``grad_req`` (``"write"`` overwrites,
        ``"add"`` accumulates)."""
        data, label, pad, entry, _ = self._prepare(data, label, pad)
        loss, grads = self._loss_and_grads(
            entry, data, label, _batch_size(data) - pad)
        out = OrderedDict()
        for (name, p), g in zip(entry["diff"].items(), grads):
            p._write_grad(g)
            out[name] = g
        return loss, out

    def run_chain(self, data, label, pad=None):
        """Run ``data.shape[0]`` training steps, one per slice of the
        leading steps axis (``(n_steps, batch, ...)``). ``pad`` (an int
        or one per step) marks each step's trailing padded rows. As in
        the reference, the hyperparameters are read once, after counting
        the first step, and held for the chain; Adam's ``t`` advances by
        each step's offset. Returns the per-step losses, shape
        ``(n_steps,)``."""
        data, label = list(_as_tuple(data)), list(_as_tuple(label))
        wrap = any(isinstance(x, NDArray) for x in data + label)
        data, label = [_tensor(l) for l in data], [_tensor(l) for l in label]
        n_steps = data[0].shape[0]
        _, entry = self._get_entry([l[0] for l in data],
                                   [l[0] for l in label])
        opt = self.optimizer
        n_diff = len(entry["diff"])
        opt._update_count(list(range(n_diff)))
        hypers = [opt._hyper(k) for k in range(n_diff)]
        for _ in range(n_steps - 1):
            opt._update_count(list(range(n_diff)))
        bsz = next((l.shape[1] for l in data if l.dim() > 1), 1)
        pads = onp.broadcast_to(onp.asarray(0 if pad is None else pad,
                                            onp.int32), (n_steps,))
        losses = []
        t0 = telemetry.clock()
        for i in range(n_steps):
            hy = [{**h, "t": onp.int32(h["t"] + i)} for h in hypers]
            loss, grads = self._loss_and_grads(
                entry, [l[i] for l in data], [l[i] for l in label],
                bsz - int(pads[i]))
            self._update(entry, grads, hy)
            losses.append(loss)
        telemetry.duration_since("parallel.train_step.run_chain", t0)
        telemetry.counter("parallel.train_step.chained_steps", n_steps)
        self._check_maskable(entry, int(pads.max()) if n_steps else 0)
        out = torch.stack(losses)
        return NDArray(out) if wrap else out

    # -- introspection and warmup -------------------------------------------
    def compiled_hlo(self, data, label, optimized=True):
        raise not_ported("TrainStep.compiled_hlo (the eager port compiles "
                         "no program; the step's structure is read with "
                         "the profiler)", 23)

    def warmup(self, shapes, dtype="float32", label_dtype="int32"):
        """Run one step's forward and backward per signature on zeros,
        ahead of the first step, updating nothing (no count, no
        parameter or state change): the port's form of the reference's
        ahead-of-time compile, which here allocates the activations and
        builds the kernels. ``shapes`` is a list of ``(data_shapes,
        label_shapes)``; each side is one shape or a list of them, and a
        ``(shape, dtype)`` pair overrides the default dtype of a leaf.
        Returns the signatures warmed."""

        def leafspecs(side, default):
            items = list(side) if side and isinstance(side[0],
                                                      (list, tuple)) \
                else [side]
            if len(side) == 2 and isinstance(side[1], str):
                items = [side]
            return [(tuple(it[0]), it[1])
                    if len(it) == 2 and isinstance(it[1], str)
                    else (tuple(it), default) for it in items]

        warmed = []
        dev = self._device()
        for data_side, label_side in shapes:
            data = [torch.zeros(s, dtype=resolve_dtype(dt), device=dev)
                    for s, dt in leafspecs(data_side, dtype)]
            label = [torch.zeros(s, dtype=resolve_dtype(dt), device=dev)
                     for s, dt in leafspecs(label_side, label_dtype)]
            data, label, pad = self._apply_bucketing(data, label, None)
            sig, entry = self._get_entry(data, label)
            telemetry.counter("parallel.train_step.warmup")
            self._loss_and_grads(entry, data, label,
                                 _batch_size(data) - pad)
            warmed.append(sig)
        return warmed
