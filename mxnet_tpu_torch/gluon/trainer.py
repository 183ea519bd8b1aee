"""Gluon ``Trainer`` on one device (the port of
``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` sets ``rescale_grad`` to ``scale / batch_size``,
all-reduces (the identity on one device) and applies the optimizer to
every parameter whose ``grad_req`` is not ``"null"``, in place on the
card, with any optimizer of ``optimizer``. The update is
``Optimizer.fused_update_multi_precision`` over every parameter at
once: the same bits as one ``update_multi_precision`` a parameter in
the reference's order (the parameters sorted by name), since each
parameter is still its own ``_step``, so the reference's
``MXTPU_FUSED_TRAINER`` switch selects nothing here. Grouping the
launches of a group is ROADMAP.md queue 2, item 14. A parameter whose
gradient no backward wrote since the last step warns, naming it
(``ignore_stale_grad`` silences it).

Dynamic loss scaling (``amp.init_trainer``): ``step`` first checks the
gradients for an inf or a NaN (one host read); on an overflow it skips
the whole update, halves the scale and clears the fresh-gradient
flags. The gradients are divided by the scale through
``rescale_grad``, unless ``amp.unscale`` already divided them; a
successful ``update`` lets the scale grow.

Stores: ``kvstore=None``, ``"device"`` and ``"local"`` on one context
give the single-device update. Any other store, a store object,
``update_on_kvstore=True`` or gradient compression wait for
``kvstore/`` (queue 1, item 19). ``fusion=`` (the gradient buckets'
byte cap) is validated as the reference does it; only those stores
would read it.

``save_states`` writes the reference's pickle: the optimizer states as
numpy arrays (bfloat16 as float32) with ``num_update``,
``begin_num_update`` and ``index_update_count``, so either package
reads the other's file. ``load_states`` copies them into the states in
place (made first where a parameter has none yet, on its device and in
its dtype), so a run resumed after step k continues bit-identically.
"""
from __future__ import annotations

import pickle
import warnings

import numpy as onp
import torch

from .. import telemetry
from .. import optimizer as opt
from ..base import not_ported
from ..utils_io import _host
from .parameter import Parameter, _host_array

__all__ = ["Trainer"]

_ONE_DEVICE_STORES = (None, False, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, fusion=None):
        if isinstance(params, dict):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        self._params = []
        seen = set()
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 f"Parameters, got list of {type(p)}.")
            if id(p) in seen:
                continue            # a tied parameter is updated once
            seen.add(id(p))
            self._params.append(p)
        if not (kvstore in _ONE_DEVICE_STORES
                or (isinstance(kvstore, str)
                    and kvstore in ("device", "local"))):
            raise not_ported(f"Trainer(kvstore={kvstore!r})", 19)
        if update_on_kvstore:
            raise not_ported("Trainer(update_on_kvstore=True)", 19)
        if compression_params is not None:
            raise not_ported("Trainer(compression_params=...)", 19)
        self._kvstore = None
        self._update_on_kvstore = False
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._states = [None] * len(self._params)
        self._states_initialized = [False] * len(self._params)
        if fusion and fusion is not True and int(fusion) <= 0:
            # negatives and 0 < fusion < 1
            raise ValueError(
                f"fusion must be a positive byte cap, False, or None "
                f"(got {fusion!r})")

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an " \
                "Optimizer instance"
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
            return
        self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                     **optimizer_params)

    # -- properties -----------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- the step -------------------------------------------------------
    def _grad_rescale(self, batch_size):
        """``scale / batch_size``, and the inverse loss scale unless
        ``amp.unscale`` already divided the gradients."""
        r = self._scale / batch_size
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and not getattr(
                self, "_amp_manual_unscaled", False):
            r /= scaler.loss_scale
        return r

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by ``1 / batch_size``, all-reduce, update; under
        loss scaling an overflowing step updates nothing."""
        self._optimizer.rescale_grad = self._grad_rescale(batch_size)
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and scaler.has_overflow(self._params):
            scaler.update_scale(True)
            self._amp_manual_unscaled = False
            for p in self._params:
                if p.grad_req != "null" and p._initialized:
                    p._fresh_grad = False
            return
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """The identity: one device holds every gradient."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` without the all-reduce."""
        self._optimizer.rescale_grad = self._grad_rescale(batch_size)
        self._update(ignore_stale_grad)
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            scaler.update_scale(False)
            self._amp_manual_unscaled = False

    def _update(self, ignore_stale_grad=False):
        updates, stale = [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or not p._initialized:
                continue
            if not ignore_stale_grad and not p._fresh_grad:
                stale.append(p)
            if not self._states_initialized[i]:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, p._var())
                self._states_initialized[i] = True
            updates.append((i, p))
        if stale:
            names = ", ".join(f"`{p.name}`" for p in stale)
            warnings.warn(
                f"Gradient of Parameter(s) {names} on context "
                f"{stale[0].list_ctx()[0]} has not been updated by "
                f"backward since last `step`. This could mean a bug in "
                f"your model that made it only use a subset of the "
                f"Parameters for the last iteration, call step with "
                f"ignore_stale_grad=True to suppress this warning")
        if not updates:
            return
        t0 = telemetry.clock()
        idxs = [i for i, _ in updates]
        if self._optimizer.fused_update_multi_precision(
                idxs, [p._var() for _, p in updates],
                [p._grad_nd()._data for _, p in updates],
                [self._states[i] for i in idxs]):
            telemetry.duration_since("trainer.fused.update", t0)
        for _, p in updates:
            p._fresh_grad = False

    # -- state io -------------------------------------------------------
    def save_states(self, fname):
        """Pickle the optimizer states and update counts to ``fname``."""
        with open(fname, "wb") as f:
            pickle.dump({"states": _host_tree(self._states),
                         "num_update": self._optimizer.num_update,
                         "begin_num_update":
                             self._optimizer.begin_num_update,
                         "index_update_count":
                             dict(self._optimizer._index_update_count)}, f)

    def load_states(self, fname):
        """Read a file of :meth:`save_states` (either package's)."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        states = blob["states"]
        if len(states) != len(self._params):
            raise ValueError(f"'{fname}' holds {len(states)} states for "
                             f"{len(self._params)} parameters")
        for i, (p, saved) in enumerate(zip(self._params, states)):
            saved = self._optimizer._migrate_state(saved)
            if saved is None:
                self._states[i] = None
                self._states_initialized[i] = False
                continue
            if not self._states_initialized[i]:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, p._var())
                self._states_initialized[i] = True
            self._states[i] = _fill(self._states[i], saved, p._var())
        self._optimizer.num_update = blob["num_update"]
        self._optimizer.begin_num_update = blob.get("begin_num_update", 0)
        self._optimizer._index_update_count = dict(
            blob["index_update_count"])


def _host_tree(x):
    """Tensors of a state tree as numpy arrays (bfloat16 as float32)."""
    if torch.is_tensor(x):
        return _host(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    return x


def _fill(have, saved, like):
    """Copy the saved tree into ``have``'s tensors in place; a saved
    array with no tensor to go into becomes one on ``like``'s device."""
    if isinstance(saved, (list, tuple)):
        if not isinstance(have, (list, tuple)) or len(have) != len(saved):
            have = [None] * len(saved)
        return type(saved)(_fill(h, s, like) for h, s in zip(have, saved))
    if isinstance(saved, onp.ndarray) or onp.isscalar(saved):
        src = torch.from_numpy(_host_array(saved))
        if torch.is_tensor(have) and tuple(have.shape) == tuple(src.shape):
            with torch.no_grad():
                have.copy_(src.to(device=have.device, dtype=have.dtype))
            return have
        return src.to(like.device)
    return saved
