"""Weight initializers (the port of ``mxnet_tpu/initializer.py``).

An initializer fills a tensor in place: ``init(desc, arr)`` takes the
parameter's name (an ``InitDesc``) and a torch tensor or an NDArray
(into which the values are installed). Called directly, it dispatches
on the name as the reference does: ``*weight`` → ``_init_weight``,
``*bias`` and ``*beta`` → 0, ``*gamma`` → 1, ``*running_mean`` /
``*moving_mean`` → 0, ``*running_var`` / ``*moving_var`` → 1, anything
else → ``_init_default``. A parameter's own ``init`` skips the dispatch
(``_init_weight``).

Random draws come from the port's per-device ``torch.Generator``
(``random_state.generator``), so ``mx.random.seed`` repeats them; they
are float32 draws on the tensor's device, cast into its dtype. Torch's
generators and JAX's give different numbers for one seed: compare
their statistics, not their values. ``Orthogonal`` takes the SVD of its
draw on the same device (``torch.linalg.svd``).

``register``/``create`` go through ``registry``; ``create`` also takes
an instance or any callable as it is.
"""
from __future__ import annotations

import math
import re

import numpy as onp
import torch

from . import registry
from .random_state import generator

__all__ = ["InitDesc", "Initializer", "register", "alias", "create",
           "Zero", "Zeros", "One", "Ones", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "InitWithArray", "Load", "Mixed"]


class InitDesc(str):
    """A parameter's name, with attribute hints for the initializer
    (``attrs["__init__"]`` names an initializer that overrides the
    name dispatch)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base class: subclasses implement ``_init_weight(desc, t)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        """Fill ``arr`` (a tensor, in place, or an NDArray, installed)
        by the name dispatch."""
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        with _Target(arr) as t:
            init = desc.attrs.get("__init__", "")
            if init:
                create(init)._init_weight(desc, t)
                return
            name = str(desc)
            if name.endswith("weight"):
                self._init_weight(desc, t)
            elif name.endswith("bias"):
                self._init_bias(desc, t)
            elif name.endswith("gamma"):
                self._init_gamma(desc, t)
            elif name.endswith("beta"):
                self._init_beta(desc, t)
            elif name.endswith("running_mean") or name.endswith("moving_mean"):
                self._init_zero(desc, t)
            elif name.endswith("running_var") or name.endswith("moving_var"):
                self._init_one(desc, t)
            else:
                self._init_default(desc, t)

    # helpers ----------------------------------------------------------
    @staticmethod
    def _set(t, value):
        """Write ``value`` (a scalar, an array or a tensor, broadcast)
        into ``t``."""
        with torch.no_grad():
            if isinstance(value, (int, float, bool)):
                t.fill_(value)
            else:
                t.copy_(_as_tensor(value, t).expand(t.shape))

    def _init_weight(self, desc, t):
        raise NotImplementedError

    def _init_default(self, desc, t):
        self._init_weight(desc, t)

    def _init_bias(self, desc, t):
        self._set(t, 0.0)

    def _init_gamma(self, desc, t):
        self._set(t, 1.0)

    def _init_beta(self, desc, t):
        self._set(t, 0.0)

    def _init_zero(self, desc, t):
        self._set(t, 0.0)

    def _init_one(self, desc, t):
        self._set(t, 1.0)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class _Target:
    """The tensor to fill: a tensor itself, or a copy of an NDArray's
    tensor that is installed back into the NDArray on exit."""

    def __init__(self, arr):
        self._arr = arr
        self._nd = not torch.is_tensor(arr)

    def __enter__(self):
        if self._nd:
            self._t = self._arr._data.detach().clone()
            return self._t
        return self._arr

    def __exit__(self, exc_type, *exc):
        if self._nd and exc_type is None:
            self._arr._install(self._t)
        return False


def _as_tensor(value, like):
    """``value`` (NDArray, tensor, array-like) on ``like``'s device and
    in its dtype."""
    data = getattr(value, "_data", None)
    if torch.is_tensor(data):
        value = data
    if not torch.is_tensor(value):
        value = torch.as_tensor(onp.asarray(value))
    return value.detach().to(device=like.device, dtype=like.dtype)


def _uniform(t, low, high):
    """A float32 U(low, high) draw of ``t``'s shape on its device."""
    return torch.empty(t.shape, dtype=torch.float32, device=t.device) \
        .uniform_(low, high, generator=generator(t.device))


def _normal(t, sigma):
    return torch.empty(t.shape, dtype=torch.float32, device=t.device) \
        .normal_(0.0, sigma, generator=generator(t.device))


register = registry.get_register_func(Initializer, "initializer")
alias = registry.get_alias_func(Initializer, "initializer")
_create = registry.get_create_func(Initializer, "initializer")


def create(name, **kwargs):
    """An initializer from an instance or a callable (returned as they
    are), a registered name or a JSON spec."""
    if isinstance(name, Initializer):
        return name
    if callable(name) and not isinstance(name, str):
        return name
    return _create(name, **kwargs)


@alias("zeros")
@register
class Zero(Initializer):
    def _init_weight(self, desc, t):
        self._set(t, 0.0)


@alias("ones")
@register
class One(Initializer):
    def _init_weight(self, desc, t):
        self._set(t, 1.0)


Zeros = Zero
Ones = One


@register
class Constant(Initializer):
    """Every element ``value`` (a scalar, or an array broadcast)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, t):
        self._set(t, self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, t):
        self._set(t, _uniform(t, -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, t):
        self._set(t, _normal(t, self.sigma))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis: the U (or V^T) factor of
    the SVD of a (nout, nin) U(-1, 1) or N(0, 1) draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, t):
        nout = t.shape[0]
        nin = int(onp.prod(t.shape[1:]))
        flat = t.new_empty((nout, nin), dtype=torch.float32)
        tmp = _uniform(flat, -1.0, 1.0) if self.rand_type == "uniform" \
            else _normal(flat, 1.0)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == tuple(tmp.shape) else v
        self._set(t, (self.scale * q).reshape(t.shape))


@register
class Xavier(Initializer):
    """Glorot: U(-a, a) (or N(0, a^2)) with a = sqrt(magnitude / factor),
    factor the fan-in, the fan-out or their mean; each fan counts the
    receptive field (the dims after the second)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, t):
        shape = tuple(t.shape)
        if len(shape) < 2:
            raise ValueError(f"Xavier initializer needs >=2D weight, got "
                             f"{shape} for {desc}")
        hw_scale = float(onp.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(t, _uniform(t, -scale, scale))
        elif self.rnd_type == "gaussian":
            self._set(t, _normal(t, scale))
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He: Xavier gaussian with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel in the last two dims."""

    def _init_weight(self, desc, t):
        shape = tuple(t.shape)
        f = shape[3] // 2
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = onp.arange(int(onp.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - onp.abs(x / f - c)) * (1 - onp.abs(y / f - c))) \
            .astype(onp.float32).reshape(shape)
        self._set(t, weight)


@register
class LSTMBias(Initializer):
    """The forget gate's quarter ``forget_bias``, the rest 0."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, t):
        b = onp.zeros(tuple(t.shape), dtype=onp.float32)
        num_hidden = t.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(t, b)

    _init_default = _init_weight
    _init_bias = _init_weight


@register
class InitWithArray(Initializer):
    """The given array (numpy, NDArray or tensor), broadcast."""

    def __init__(self, arr):
        super().__init__()
        self.arr = arr

    def _init_weight(self, desc, t):
        self._set(t, self.arr)


Load = InitWithArray


@register
class Mixed(Initializer):
    """The first initializer whose pattern matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, desc, arr):
        for prog, init in self.map:
            if prog.match(str(desc)):
                init(desc, arr)
                return
        raise ValueError(f"Parameter name {desc} did not match any pattern")
