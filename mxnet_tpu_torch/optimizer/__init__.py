"""Optimizers of the port: ``Optimizer``, ``create``, ``register``,
every optimizer of the reference (``Test``, ``SGD``, ``NAG``, ``Adam``,
``AdamW``, ``Adamax``, ``Nadam``, ``AdaBelief``, ``RMSProp``,
``AdaGrad``, ``GroupAdaGrad``, ``AdaDelta``, ``Ftrl``, ``FTML``,
``LAMB``, ``LARS``, ``LANS``, ``Signum``, ``SGLD``, ``DCASGD``),
``Updater`` and ``get_updater``.

Counterpart of ``mxnet_tpu/optimizer/__init__.py``. Each
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
into the given tensors in place (the reference installs new arrays).
``fused_update_multi_precision`` is the Trainer's multi-tensor entry
point: the reference's contract (counts and hypers per index in list
order, groups by dtype and multi-precision, the same bits as the
per-parameter loop, ``False`` and the loop for a class that overrides
``update``). Inside a group the update is still a loop of ``_step``
calls; grouping their launches is ROADMAP.md queue 2, item 14.

``SGLD`` draws its noise from the port's generator of the weight's
device (``random_state``): a seeded run repeats, but its draws are not
JAX's. ``Updater.get_states`` pickles the states as numpy arrays, so
the two packages read each other's files.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["Optimizer", "create", "register", "SGD", "NAG", "Adam", "AdamW",
           "Adamax", "Nadam", "AdaBelief", "RMSProp", "AdaGrad",
           "GroupAdaGrad", "AdaDelta", "Ftrl", "FTML", "LAMB", "LARS",
           "LANS", "Signum", "SGLD", "DCASGD", "Test", "Updater",
           "get_updater"]

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

    def _migrate_state(self, state):
        """Adapt a state of an older layout (``Updater.set_states``,
        ``Trainer.load_states``); default: unchanged."""
        return state

    def __setstate__(self, d):
        """Unpickling restores ``__dict__`` without ``__init__``: fill
        the attributes an older pickle lacks from the ``__init__``
        defaults of the class and its bases."""
        import inspect
        self.__dict__.update(d)
        for klass in type(self).__mro__:
            ctor = klass.__dict__.get("__init__")
            if ctor is None:
                continue
            for name, p in inspect.signature(ctor).parameters.items():
                if p.default is inspect.Parameter.empty:
                    continue
                if name not in self.__dict__ and not name.startswith("_"):
                    self.__dict__.setdefault(name, p.default)

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
    def _apply(self, index, weight, grad, state, mp, hyper=None):
        if hyper is None:
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

    def _is_mp(self, weight, state):
        return self._use_mp(weight) and isinstance(state, tuple) \
            and len(state) == 2 and torch.is_tensor(state[0]) \
            and state[0].dtype == torch.float32

    def update(self, index, weight, grad, state):
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        for i, w, g, s in zip(index, weight, grad, state):
            self._apply(i, w, g, s, mp=False)

    def update_multi_precision(self, index, weight, grad, state):
        if type(self).update is not Optimizer.update:
            # a class with its own update() (SGLD) keeps it
            return self.update(index, weight, grad, state)
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        for i, w, g, s in zip(index, weight, grad, state):
            self._apply(i, w, g, s, self._is_mp(w, s))

    def fused_update_multi_precision(self, index, weight, grad, state):
        """The multi-tensor update: the per-index counts and hypers in
        list order (the per-parameter loop's sequence), then each
        (dtype, multi-precision) group's parameters in turn. The same
        ``_step`` on the same hypers: the same bits as calling
        ``update_multi_precision`` per parameter. A class overriding
        ``update`` or ``update_multi_precision`` runs that per
        parameter instead, and the call returns ``False``."""
        if type(self).update is not Optimizer.update or \
                type(self).update_multi_precision is not \
                Optimizer.update_multi_precision:
            for i, w, g, st in zip(index, weight, grad, state):
                self.update_multi_precision([i], [w], [g], [st])
            return False
        hypers = []
        for i in index:
            self._update_count([i])
            hypers.append(self._hyper(i))
        groups = {}
        for pos, (w, s) in enumerate(zip(weight, state)):
            mp = self._is_mp(w, s)
            groups.setdefault((_tensor(w).dtype, mp), []).append(pos)
        for (_, mp), poss in groups.items():
            for p in poss:
                self._apply(index[p], weight[p], grad[p], state[p], mp,
                            hypers[p])
        return True

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


def _f32(x):
    return onp.float32(x)


def _pow(base, t):
    """``base ** t`` in float32, ``t`` the update count."""
    return onp.power(_f32(base), _f32(t))


def _zeros(weight, n):
    """``n`` distinct zero tensors like ``weight``."""
    w = _tensor(weight)
    return tuple(torch.zeros_like(w) for _ in range(n))


def _norm(x):
    return torch.linalg.vector_norm(x)


def _rescale_clip(g, hyper):
    g = g * _f(hyper["rescale"])
    if hyper["clip"] is not None:
        c = _f(hyper["clip"])
        g = torch.clamp(g, -c, c)
    return g


@register
class Adamax(Adam):
    """AdaMax (parity: optimizer/adamax.py)."""

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        m, u = state
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m = _f(b1) * m + _f(1 - b1) * g
        u = torch.maximum(_f(b2) * u, torch.abs(g))
        lr_t = hyper["lr"] / (_f32(1.0) - _pow(b1, hyper["t"]))
        return w - _f(lr_t) * m / (u + _f(hyper["eps"])), (m, u)


@register
class Nadam(Adam):
    """Nesterov Adam with the reference's warming momentum schedule
    ``mu_t = b1 (1 - 0.5 * 0.96^(t sd))``; the running product
    ``m_schedule`` is per parameter, a 0-d state (the reference's
    documented deviation from its own single shared product)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon, **kwargs)
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), torch.zeros_like(w),
                torch.ones((), dtype=torch.float32, device=w.device))

    def _migrate_state(self, state):
        # an older (m, v) state takes m_schedule = 1; a multi-precision
        # state is (master, inner)
        if isinstance(state, tuple) and len(state) == 2:
            if isinstance(state[1], tuple):
                return (state[0], self._migrate_state(state[1]))
            return state + (onp.ones((), onp.float32),)
        return state

    def _hyper(self, index):
        h = super()._hyper(index)
        h["sd"] = onp.float32(self.schedule_decay)
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        m, v, msched = state
        b1, b2 = hyper["beta1"], hyper["beta2"]
        tf, sd = _f32(hyper["t"]), hyper["sd"]
        coef2 = _f32(1.0) - _pow(b2, tf)
        mu_t = b1 * (_f32(1.0) - _f32(0.5) * _pow(0.96, tf * sd))
        mu_t1 = b1 * (_f32(1.0) - _f32(0.5)
                      * _pow(0.96, (tf + _f32(1.0)) * sd))
        msched = msched * _f(mu_t)
        msched_next = msched * _f(mu_t1)
        m = _f(b1) * m + _f(1 - b1) * g
        v = _f(b2) * v + _f(1 - b2) * torch.square(g)
        g_prime = g / (1.0 - msched)
        m_prime = m / (1.0 - msched_next)
        v_prime = v / _f(coef2)
        m_bar = _f(mu_t1) * m_prime + _f(_f32(1.0) - mu_t) * g_prime
        return w - _f(hyper["lr"]) * m_bar / (torch.sqrt(v_prime)
                                              + _f(hyper["eps"])), \
            (m, v, msched)


@register
class AdaBelief(Adam):
    """AdaBelief: the second moment tracks ``(g - m)^2`` (parity:
    optimizer/adabelief.py; epsilon is folded into the accumulator and
    added again in the denominator, as there)."""

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
        g = Optimizer._pre(g, w, hyper)
        m, s = state
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m = _f(b1) * m + _f(1 - b1) * g
        s = _f(b2) * s + _f(1 - b2) * torch.square(g - m) \
            + _f(hyper["eps"])
        lr_t = hyper["lr"]
        if hyper["correct"] is not None:
            lr_t = _bias_corrected_lr(hyper)
        return w - _f(lr_t) * m / (torch.sqrt(s) + _f(hyper["eps"])), (m, s)


@register
class RMSProp(Optimizer):
    """RMSProp, optionally centered (parity: optimizer/rmsprop.py)."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(rho=onp.float32(self.rho), mom=onp.float32(self.momentum),
                 eps=onp.float32(self.epsilon))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        rho, eps = hyper["rho"], _f(hyper["eps"])
        if len(state) == 1:
            (n,) = state
            n = _f(rho) * n + _f(1 - rho) * torch.square(g)
            return w - _f(hyper["lr"]) * g / torch.sqrt(n + eps), (n,)
        n, gavg, delta = state
        n = _f(rho) * n + _f(1 - rho) * torch.square(g)
        gavg = _f(rho) * gavg + _f(1 - rho) * g
        delta = _f(hyper["mom"]) * delta - _f(hyper["lr"]) * g / \
            torch.sqrt(n - torch.square(gavg) + eps)
        return w + delta, (n, gavg, delta)


@register
class AdaGrad(Optimizer):
    """AdaGrad (parity: optimizer/adagrad.py)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 1)

    def _hyper(self, index):
        h = super()._hyper(index)
        h["eps"] = onp.float32(self.epsilon)
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        (h,) = state
        h = h + torch.square(g)
        return w - _f(hyper["lr"]) * g / (torch.sqrt(h)
                                          + _f(hyper["eps"])), (h,)


adagrad = AdaGrad


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulator per row (parity:
    optimizer/contrib.py GroupAdaGrad); weight decay is refused, as
    there."""

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        if kwargs.get("wd"):
            raise ValueError(
                "Weight decay is not supported for GroupAdaGrad")
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        w = _tensor(weight)
        if w.dim() != 2:
            raise ValueError("GroupAdaGrad requires 2D weights "
                             f"(got shape {tuple(w.shape)})")
        return (torch.zeros((w.shape[0], 1), dtype=w.dtype,
                            device=w.device),)

    def _hyper(self, index):
        h = super()._hyper(index)
        h["eps"] = onp.float32(self.epsilon)
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper, wd_in_grad=False)
        (h,) = state
        h = h + torch.mean(torch.square(g), dim=1, keepdim=True)
        return w - _f(hyper["lr"]) * g / (torch.sqrt(h)
                                          + _f(hyper["eps"])), (h,)


@register
class AdaDelta(Optimizer):
    """AdaDelta (parity: optimizer/adadelta.py)."""

    def __init__(self, learning_rate=1.0, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(rho=onp.float32(self.rho), eps=onp.float32(self.epsilon))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        acc_g, acc_d = state
        rho, eps = hyper["rho"], _f(hyper["eps"])
        acc_g = _f(rho) * acc_g + _f(1 - rho) * torch.square(g)
        delta = torch.sqrt(acc_d + eps) / torch.sqrt(acc_g + eps) * g
        acc_d = _f(rho) * acc_d + _f(1 - rho) * torch.square(delta)
        return w - _f(hyper["lr"]) * delta, (acc_g, acc_d)


@register
class Ftrl(Optimizer):
    """FTRL (parity: optimizer/ftrl.py)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)  # z, n

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(lamda1=onp.float32(self.lamda1),
                 beta=onp.float32(self.beta))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper, wd_in_grad=False)
        z, n = state
        lr, l1 = _f(hyper["lr"]), _f(hyper["lamda1"])
        sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
        z = z + g - sigma * w
        n = n + torch.square(g)
        denom = (_f(hyper["beta"]) + torch.sqrt(n)) / lr + _f(hyper["wd"])
        new_w = torch.where(torch.abs(z) > l1,
                            -(z - torch.sign(z) * l1) / denom,
                            torch.zeros_like(w))
        return new_w, (z, n)


@register
class FTML(Optimizer):
    """FTML (parity: optimizer/ftml.py)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 3)  # d, v, z

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(beta1=onp.float32(self.beta1), beta2=onp.float32(self.beta2),
                 eps=onp.float32(self.epsilon))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        d, v, z = state
        b1, b2, t = hyper["beta1"], hyper["beta2"], hyper["t"]
        v = _f(b2) * v + _f(1 - b2) * torch.square(g)
        d_t = _f((_f32(1.0) - _pow(b1, t)) / hyper["lr"]) * \
            (torch.sqrt(v / _f(_f32(1.0) - _pow(b2, t))) + _f(hyper["eps"]))
        sigma = d_t - _f(b1) * d
        z = _f(b1) * z + _f(1 - b1) * g - sigma * w
        return -z / d_t, (d_t, v, z)


@register
class LAMB(Optimizer):
    """LAMB, the layerwise-adaptive large-batch optimizer (parity:
    optimizer/lamb.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(beta1=onp.float32(self.beta1), beta2=onp.float32(self.beta2),
                 eps=onp.float32(self.epsilon),
                 lb=onp.float32(self.lower_bound
                                if self.lower_bound is not None else 0.0),
                 ub=onp.float32(self.upper_bound
                                if self.upper_bound is not None else 1e30),
                 bc=onp.float32(1.0 if self.bias_correction else 0.0))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper, wd_in_grad=False)
        m, v = _moments(g, state, hyper)
        m_hat, v_hat = m, v
        if hyper["bc"] > 0:
            t = hyper["t"]
            m_hat = m / _f(_f32(1.0) - _pow(hyper["beta1"], t))
            v_hat = v / _f(_f32(1.0) - _pow(hyper["beta2"], t))
        r = m_hat / (torch.sqrt(v_hat) + _f(hyper["eps"])) \
            + _f(hyper["wd"]) * w
        r_norm = _norm(r)
        w_norm_c = torch.clamp(_norm(w), _f(hyper["lb"]), _f(hyper["ub"]))
        ratio = torch.where((w_norm_c > 0) & (r_norm > 0),
                            w_norm_c / r_norm, 1.0)
        return w - _f(hyper["lr"]) * ratio * r, (m, v)


@register
class LARS(Optimizer):
    """LARS (parity: optimizer/lars.py)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 1)

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(mom=onp.float32(self.momentum), eta=onp.float32(self.eta),
                 eps=onp.float32(self.epsilon))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = _rescale_clip(g, hyper)
        (mom,) = state
        wd = _f(hyper["wd"])
        w_norm, g_norm = _norm(w), _norm(g)
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                       _f(hyper["eta"]) * w_norm
                       / (g_norm + wd * w_norm + _f(hyper["eps"])), 1.0)
        lr_l = _f(hyper["lr"]) * trust
        mom = _f(hyper["mom"]) * mom + lr_l * (g + wd * w)
        return w - mom, (mom,)


@register
class LANS(LAMB):
    """LANS: LAMB with the gradient normalized per tensor and a
    Nesterov blend (parity: optimizer/lans.py)."""

    @staticmethod
    def _step(w, g, state, hyper):
        g = _rescale_clip(g, hyper)
        g_norm = _norm(g)
        g = torch.where(g_norm > 0, g / g_norm, g)
        m, v = _moments(g, state, hyper)
        b1, t, eps = hyper["beta1"], hyper["t"], _f(hyper["eps"])
        wd = _f(hyper["wd"])
        m_hat = m / _f(_f32(1.0) - _pow(b1, t))
        v_hat = v / _f(_f32(1.0) - _pow(hyper["beta2"], t))
        w_norm = _norm(w)
        r1 = m_hat / (torch.sqrt(v_hat) + eps) + wd * w
        r2 = g / (torch.sqrt(v_hat) + eps) + wd * w
        r1n, r2n = _norm(r1), _norm(r2)
        rat1 = torch.where((w_norm > 0) & (r1n > 0), w_norm / r1n, 1.0)
        rat2 = torch.where((w_norm > 0) & (r2n > 0), w_norm / r2n, 1.0)
        upd = _f(b1) * rat1 * r1 + _f(1 - b1) * rat2 * r2
        return w - _f(hyper["lr"]) * upd, (m, v)


@register
class Signum(Optimizer):
    """SignSGD / Signum (parity: optimizer/signum.py)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return _zeros(weight, 1)

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(mom=onp.float32(self.momentum),
                 wd_lh=onp.float32(self.wd_lh))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        lr = hyper["lr"]
        decay = _f(_f32(1.0) - lr * hyper["wd_lh"])
        if not state:
            return w * decay - _f(lr) * torch.sign(g), state
        (mom,) = state
        mom = _f(hyper["mom"]) * mom - _f(1 - hyper["mom"]) * g
        return w * decay + _f(lr) * torch.sign(mom), (mom,)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (parity: optimizer/sgld.py):
    ``w - lr / 2 * g + N(0, lr)``, the noise drawn in float32 from the
    generator of the weight's device (``random_state.generator``)."""

    def update(self, index, weight, grad, state):
        from .. import random_state
        if not isinstance(index, (list, tuple)):
            index, weight, grad, state = [index], [weight], [grad], [state]
        self._update_count(index)
        for i, w, g, s in zip(index, weight, grad, state):
            hyper = self._hyper(i)
            wt = _tensor(w)
            with torch.no_grad():
                gg = Optimizer._pre(_grad_tensor(g).to(wt.dtype), wt, hyper)
                noise = torch.randn(
                    wt.shape, dtype=torch.float32, device=wt.device,
                    generator=random_state.generator(wt.device))
                noise = _f(onp.sqrt(hyper["lr"])) * noise.to(wt.dtype)
                wt.copy_(wt - _f(hyper["lr"] / _f32(2)) * gg + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (parity: optimizer/dcasgd.py)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        w = _tensor(weight)
        return (torch.zeros_like(w), w.detach().clone())

    def _hyper(self, index):
        h = super()._hyper(index)
        h.update(mom=onp.float32(self.momentum),
                 lamda=onp.float32(self.lamda))
        return h

    @staticmethod
    def _step(w, g, state, hyper):
        g = Optimizer._pre(g, w, hyper)
        mom, prev_w = state
        comp = g + _f(hyper["lamda"]) * g * g * (w - prev_w)
        mom = _f(hyper["mom"]) * mom - _f(hyper["lr"]) * comp
        return w + mom, (mom, w.clone())


# ---------------------------------------------------------------------------
# Updater (parity: optimizer.Updater)
# ---------------------------------------------------------------------------
def _to_host(x):
    """A state tree's tensors as numpy arrays (bfloat16 as float32)."""
    if torch.is_tensor(x):
        from ..utils_io import _host
        return _host(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _to_device(x, device):
    """Numpy arrays (and tensors on another device) of a state tree as
    tensors on ``device``."""
    if isinstance(x, onp.ndarray) or isinstance(x, onp.generic):
        return torch.from_numpy(onp.array(x)).to(device)
    if torch.is_tensor(x):
        return x if x.device == device else x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, device) for v in x)
    return x


class Updater:
    """Applies an optimizer to ``(index, grad, weight)`` and keeps the
    states by index (parity: mxnet.optimizer.Updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            indices, grads, weights = [index], [grad], [weight]
        else:
            indices, grads, weights = index, grad, weight
        for i, w, g in zip(indices, weights, grads):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
            else:
                # a state read by set_states lands on the weight's device
                self.states[i] = _to_device(self.states[i],
                                            _tensor(w).device)
            self.optimizer.update_multi_precision([i], [w], [g],
                                                  [self.states[i]])

    def get_states(self, dump_optimizer=False):
        """The states as a pickle of numpy arrays (bfloat16 as float32),
        with the optimizer when ``dump_optimizer``."""
        import pickle
        host = _to_host(self.states)
        return pickle.dumps((host, self.optimizer) if dump_optimizer
                            else host)

    def set_states(self, states):
        """Read a pickle of :meth:`get_states` (either package's)."""
        import pickle
        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2 and \
                isinstance(obj[1], Optimizer):
            states, self.optimizer = obj
        else:
            states = obj
        if isinstance(states, dict):
            states = {k: self.optimizer._migrate_state(v)
                      for k, v in states.items()}
        self.states = _to_device(states, torch.device("cpu")) \
            if not isinstance(states, dict) else \
            {k: _to_device(v, torch.device("cpu")) for k, v in states.items()}


def get_updater(optimizer):
    return Updater(optimizer)
