"""Optimizers of the port: ``Optimizer``, ``create``, ``register`` and
``Test``, ``SGD``, ``NAG``, ``Adam``, ``AdamW``.

Counterpart of ``mxnet_tpu/optimizer/__init__.py:28-479``. Each
optimizer keeps the reference's pure functional step
``_step(w, g, state, hyper) -> (new_w, new_state)``, here over torch
tensors, with the reference's arithmetic in the reference's order (not
``torch.optim``'s): ``_pre`` rescales, clips and adds ``wd * w`` to the
gradient; Adam's step is ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` and
``w - lr_t * m / (sqrt(v) + eps)``; AdamW decays the updated weight with
the same ``lr_t``. The hyperparameters are float32 scalars (``_hyper``),
and every scalar computed from them (``1 - b1``, the bias corrections,
``lr_t``) is computed in float32, as the reference's traced scalars
are. ``_step_mp`` runs the step on an fp32 master copy of a float16 or
bf16 weight (``multi_precision=True``) and casts the new master back.

``update``/``update_multi_precision`` take weights (and gradients) as
``Parameter``s, NDArrays or tensors and write the new weight and state
into the given tensors in place (the reference installs new arrays). The other optimizers of the
reference (Adamax through LAMB) wait for ROADMAP.md queue 1, item 16.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam", "AdamW",
           "Test"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _REGISTRY[name.lower()](**kwargs)


def _f(x) -> float:
    """A float32 hyper value as the Python float torch takes as a
    scalar: exactly the float32 value, which torch's float32 kernels
    then use as it is."""
    return float(onp.float32(x))


def _tensor(x) -> torch.Tensor:
    """The tensor of a weight given as a ``Parameter``, an NDArray or a
    tensor."""
    if torch.is_tensor(x):
        return x
    return x._var() if hasattr(x, "_var") else x._data


def _grad_tensor(g) -> torch.Tensor:
    """The tensor of a gradient given as a tensor, an NDArray or a
    ``Parameter`` (its gradient buffer)."""
    if torch.is_tensor(g):
        return g
    return g.grad()._data if hasattr(g, "_var") else g._data


def assign_state(old, new):
    """Write ``new`` into the tensors of ``old`` (the same nesting of
    tuples), in place."""
    if torch.is_tensor(old):
        old.copy_(new)
        return
    for o, n in zip(old, new):
        assign_state(o, n)


class Optimizer:
    """Base optimizer (parity: mxnet.optimizer.Optimizer)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=0,
                 use_fused_step=True, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.param_dict = param_dict or {}
        self.idx2name = dict(param_idx2name or {})
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = 0
        self.num_update = 0
        self._index_update_count = {}

    # -- lr/wd plumbing ------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning(
                "LRScheduler of the optimizer has already been defined. "
                "Note that set_learning_rate can mutate the value of the "
                "learning rate of the optimizer only when the LRScheduler "
                "of the optimizer is undefined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if not isinstance(index, (list, tuple, range)):
            index = [index]
        for idx in index:
            if idx not in self._index_update_count:
                self._index_update_count[idx] = self.begin_num_update
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- state ---------------------------------------------------------
    def _use_mp(self, weight):
        return self.multi_precision and _tensor(weight).dtype in (
            torch.float16, torch.bfloat16)

    def create_state(self, index, weight):
        """The optimizer state of ``weight``: a tuple of tensors."""
        return ()

    def create_state_multi_precision(self, index, weight):
        if self._use_mp(weight):
            master = _tensor(weight).detach().float()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- hypers handed to the step -------------------------------------
    def _hyper(self, index):
        t = self._index_update_count.get(index, self.num_update)
        return {
            "lr": onp.float32(self._get_lr(index)),
            "wd": onp.float32(self._get_wd(index)),
            "rescale": onp.float32(self.rescale_grad),
            "clip": (onp.float32(self.clip_gradient)
                     if self.clip_gradient is not None else None),
            "t": onp.int32(t),
        }

    @staticmethod
    def _pre(g, w, hyper, wd_in_grad=True):
        """rescale -> clip -> (optionally) add L2 wd into the gradient."""
        g = g * _f(hyper["rescale"])
        if hyper["clip"] is not None:
            c = _f(hyper["clip"])
            g = torch.clamp(g, -c, c)
        if wd_in_grad:
            g = g + _f(hyper["wd"]) * w
        return g

    # -- update API (parity: update / update_multi_precision) ----------
    def _apply(self, index, weight, grad, state, mp):
        hyper = self._hyper(index)
        w = _tensor(weight)
        g = _grad_tensor(grad)
        with torch.no_grad():
            if mp:
                new_w, new_s = type(self)._step_mp(w, g, state, hyper)
            else:
                new_w, new_s = type(self)._step(w, g.to(w.dtype), state,
                                                hyper)
            w.copy_(new_w)
            assign_state(state, new_s)

    def update(self, index, weight, grad, state):
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        for i, w, g, s in zip(index, weight, grad, state):
            self._apply(i, w, g, s, mp=False)

    def update_multi_precision(self, index, weight, grad, state):
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        for i, w, g, s in zip(index, weight, grad, state):
            mp = self._use_mp(w) and isinstance(s, tuple) and len(s) == 2 \
                and torch.is_tensor(s[0]) and s[0].dtype == torch.float32
            self._apply(i, w, g, s, mp)

    # The functional step; subclasses override. Default: plain SGD.
    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        return w - _f(hyper["lr"]) * g, state

    @classmethod
    def _step_mp(cls, w, g, state, hyper):
        master, inner = state
        new_master, new_inner = cls._step(master, g.float(), inner, hyper)
        return new_master.to(w.dtype), (new_master, new_inner)


@register
class Test(Optimizer):
    """Trivial optimizer used by tests (parity: mx.optimizer.Test)."""

    def create_state(self, index, weight):
        return (torch.zeros_like(_tensor(weight)),)

    @staticmethod
    def _step(w, g, state, hyper):
        (acc,) = state
        g = Optimizer._pre(g, w, hyper)
        return w - _f(hyper["lr"]) * g, (acc + g,)


@register
class SGD(Optimizer):
    """SGD with momentum (parity: optimizer/sgd.py)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(_tensor(weight)),)

    def _hyper(self, index):
        h = super()._hyper(index)
        h["momentum"] = onp.float32(self.momentum)
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        if not state:
            return w - _f(hyper["lr"]) * g, state
        (mom,) = state
        mom = _f(hyper["momentum"]) * mom - _f(hyper["lr"]) * g
        return w + mom, (mom,)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (parity: optimizer/nag.py)."""

    def __init__(self, learning_rate=0.1, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return (torch.zeros_like(_tensor(weight)),)

    def _hyper(self, index):
        h = super()._hyper(index)
        h["momentum"] = onp.float32(self.momentum)
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        (mom,) = state
        mu = _f(hyper["momentum"])
        mom = mu * mom + g
        return w - _f(hyper["lr"]) * (g + mu * mom), (mom,)


def _bias_corrected_lr(hyper):
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` in float32."""
    t = onp.float32(hyper["t"])
    coef1 = onp.float32(1.0) - onp.power(hyper["beta1"], t)
    coef2 = onp.float32(1.0) - onp.power(hyper["beta2"], t)
    return hyper["lr"] * onp.sqrt(coef2) / coef1


def _moments(g, state, hyper):
    m, v = state
    b1, b2 = hyper["beta1"], hyper["beta2"]
    m = _f(b1) * m + _f(1 - b1) * g
    v = _f(b2) * v + _f(1 - b2) * torch.square(g)
    return m, v


@register
class Adam(Optimizer):
    """Adam (parity: optimizer/adam.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w))

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(beta1=onp.float32(self.beta1), beta2=onp.float32(self.beta2),
                 eps=onp.float32(self.epsilon))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        m, v = _moments(g, state, hyper)
        lr_t = _f(_bias_corrected_lr(hyper))
        return w - lr_t * m / (torch.sqrt(v) + _f(hyper["eps"])), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (parity: optimizer/adamW.py: the
    wd term uses the SAME bias-corrected lr, on the already-updated
    weight)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.correct_bias = correct_bias

    def _hyper(self, index):
        h = super()._hyper(index)
        h["correct"] = 1.0 if self.correct_bias else None
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper, wd_in_grad=False)
        m, v = _moments(g, state, hyper)
        lr_t = _bias_corrected_lr(hyper) if hyper.get("correct") is not None \
            else hyper["lr"]
        w = w - _f(lr_t) * m / (torch.sqrt(v) + _f(hyper["eps"]))
        return w - _f(lr_t * hyper["wd"]) * w, (m, v)
