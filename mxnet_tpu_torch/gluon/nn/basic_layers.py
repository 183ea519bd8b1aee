"""Basic Gluon layers (the port of ``mxnet_tpu/gluon/nn/basic_layers.py``).

Each keeps the reference's constructor, parameter names
(``weight``/``bias``, ``gamma``/``beta``, ``running_mean``/
``running_var``), layouts (Dense weight ``(units, in_units)``, Embedding
weight ``(input_dim, output_dim)``) and deferred shapes (``in_units``/
``in_channels`` 0: inferred at the first forward). ``forward`` is
written over tensors, on ``ops.nn`` (see ``block.py``). Dense is
``ops.nn.fully_connected`` (``F.linear``: full fp32 on the card while
torch's ``backends.cuda.matmul.allow_tf32`` is off, its default). The
GPT model calls Dense, LayerNorm, Embedding and Dropout with tensors,
at no extra cost.
"""
from __future__ import annotations

import numpy as onp
import torch

from ... import autograd, random_state
from ...ndarray.ndarray import NDArray
from ...ops import nn as _nn
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "BatchNormReLU", "SyncBatchNorm",
           "LayerNorm", "GroupNorm", "InstanceNorm", "Embedding", "Flatten",
           "Identity", "Lambda", "HybridLambda", "Concatenate",
           "HybridConcatenate", "Concurrent", "HybridConcurrent"]


def _infer(params, shape):
    for p in params:
        if p is not None and not p._shape_known():
            p._infer_shape(shape)


class Sequential(Block):
    """Children run in the order they were added; extra arguments go to
    the first one."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for child in self._children.values():
            x = child(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        children = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*children[key])
            return net
        return children[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(Sequential, HybridBlock):
    def __init__(self, *blocks):
        HybridBlock.__init__(self)
        self.add(*blocks)


class Activation(HybridBlock):
    """``ops.nn.activation``'s table (``relu``, ``sigmoid``, ``tanh``,
    ``softrelu``, ``softsign``, ``gelu``, ``silu``, ...)."""

    _tensor_forward = True

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _nn.activation(x, self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class Dense(HybridBlock):
    """``act(x @ W^T + b)``; ``flatten`` folds every axis after the
    first into the input, else the product is over the last axis. The
    activation is applied inline (``ops.nn.activation``), not through
    a child ``Activation`` block as in the reference: the GPT model
    calls its Dense layers on every decode step."""

    _tensor_forward = True

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = int(units)
        self._flatten = flatten
        self._act_type = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None

    def forward(self, x):
        if not self.weight._known:
            in_units = int(onp.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            self.weight._infer_shape((self._units, in_units))
        bias = self.bias
        out = _nn.fully_connected(x, self.weight._read(),
                                  None if bias is None else bias._read(),
                                  flatten=self._flatten)
        if self._act_type is not None:
            out = _nn.activation(out, self._act_type)
        return out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} -> "
                f"{self._units}, {self._act_type or 'linear'})")


class Dropout(HybridBlock):
    """Inverted dropout, active only in training mode
    (``autograd.is_training()``: ``record()`` sets it by default, and
    ``parallel.TrainStep`` for its forward), the identity otherwise and
    at rate 0. A kept element is scaled by ``1 / (1 - rate)``; ``axes``
    share one mask draw along those axes. The mask comes from the
    device's generator (``random_state``), so ``mx.random.seed``
    repeats it."""

    _tensor_forward = True

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes or ())

    def forward(self, x):
        if self._rate <= 0 or not autograd.is_training():
            return x
        return _nn.dropout(x, self._rate, self._axes,
                           random_state.generator(x.device))

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalization over every axis but ``axis``. In training
    mode (``autograd.is_training()``, without ``use_global_stats``) it
    normalizes by the batch's mean and biased variance and updates the
    running statistics in place, off the tape:
    ``momentum * running + (1 - momentum) * batch``; otherwise it reads
    them. ``scale=False`` fixes gamma at one."""

    _tensor_forward = True

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)
        self.running_mean = Parameter("running_mean", shape=(in_channels,),
                                      init=running_mean_initializer,
                                      differentiable=False,
                                      allow_deferred_init=True)
        self.running_var = Parameter("running_var", shape=(in_channels,),
                                     init=running_variance_initializer,
                                     differentiable=False,
                                     allow_deferred_init=True)

    def forward(self, x):
        _infer((self.gamma, self.beta, self.running_mean, self.running_var),
               (x.shape[self._axis],))
        gamma = self.gamma._read()
        if not self._scale:
            gamma = torch.ones_like(gamma.detach())
        beta = self.beta._read()
        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = _nn.batch_norm_train(x, gamma, beta,
                                                  axis=self._axis,
                                                  eps=self._epsilon)
            m = self._momentum
            with torch.no_grad():
                for p, new in ((self.running_mean, mean),
                               (self.running_var, var)):
                    old = p._var()
                    old.copy_((m * old + (1 - m) * new.detach())
                              .to(old.dtype))
            return out
        return _nn.batch_norm_inference(
            x, gamma, beta, self.running_mean._read(),
            self.running_var._read(), axis=self._axis, eps=self._epsilon)

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, momentum={self._momentum}, "
                f"eps={self._epsilon}, in_channels={self.gamma.shape[0]})")


class BatchNormReLU(BatchNorm):
    """BatchNorm followed by relu (one fused layer in the reference)."""

    def forward(self, x):
        return torch.relu(super().forward(x))


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm. On one device it is
    ``BatchNorm`` over axis 1; several devices wait for ROADMAP.md
    queue 1, item 19."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        if num_devices not in (None, 1):
            from ...base import not_ported
            raise not_ported("SyncBatchNorm over several devices", 19)
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` (biased variance)."""

    _tensor_forward = True

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self.gamma = Parameter("gamma", shape=(in_channels,), dtype=dtype,
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(in_channels,), dtype=dtype,
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)

    def forward(self, x):
        if not (self.gamma._known and self.beta._known):
            _infer((self.gamma, self.beta), (x.shape[self._axis],))
        return _nn.layer_norm(x, self.gamma._read(), self.beta._read(),
                              axis=self._axis, eps=self._epsilon)

    def __repr__(self):
        return f"LayerNorm(axis={self._axis}, eps={self._epsilon})"


class GroupNorm(HybridBlock):
    """Group normalization of the channels (axis 1) in ``num_groups``."""

    _tensor_forward = True

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)

    def forward(self, x):
        _infer((self.gamma, self.beta), (x.shape[1],))
        return _nn.group_norm(x, self.gamma._read(), self.beta._read(),
                              num_groups=self._num_groups, eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """Instance normalization, channels on ``axis``."""

    _tensor_forward = True

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer, differentiable=scale,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer, differentiable=center,
                              allow_deferred_init=True)

    def forward(self, x):
        _infer((self.gamma, self.beta), (x.shape[self._axis],))
        if self._axis != 1:
            x = x.swapaxes(1, self._axis)
        out = _nn.instance_norm(x, self.gamma._read(), self.beta._read(),
                                eps=self._epsilon)
        if self._axis != 1:
            out = out.swapaxes(1, self._axis)
        return out


class Embedding(HybridBlock):
    """Rows of a ``(input_dim, output_dim)`` table at the indices."""

    _tensor_forward = True

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype, init=weight_initializer)

    def forward(self, x):
        return _nn.embedding(x, self.weight._read())

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    _tensor_forward = True

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _np_function(function, with_npx):
    """``mx.np``'s function of that name (then ``mx.npx``'s)."""
    from ... import numpy as np
    from ... import numpy_extension as npx
    fn = getattr(np, function, None)
    if fn is None and with_npx:
        fn = getattr(npx, function)
    if fn is None:
        raise AttributeError(f"mx.np has no function {function!r}")
    return fn


def _call_np(fn, args):
    """An ``mx.np`` function on tensors: as NDArrays, under record() when
    torch's grad mode is on, and back to tensors."""
    if any(isinstance(a, NDArray) for a in args) or not any(
            torch.is_tensor(a) for a in args):
        return fn(*args)
    nds = [NDArray(a) if torch.is_tensor(a) else a for a in args]
    with autograd._RecordingScope(torch.is_grad_enabled(), None):
        out = fn(*nds)
    if isinstance(out, (list, tuple)):
        return type(out)(o._data if isinstance(o, NDArray) else o
                         for o in out)
    return out._data if isinstance(out, NDArray) else out


class Lambda(Block):
    """A function as a block: a name of ``mx.np`` or a callable."""

    def __init__(self, function):
        super().__init__()
        if isinstance(function, str):
            self._func = _np_function(function, with_npx=False)
            self._func_name = function
            self._np = True
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
            self._np = False

    def forward(self, *args):
        if self._np:
            return _call_np(self._func, args)
        return self._func(*args)

    def __repr__(self):
        return f"Lambda({self._func_name})"


class HybridLambda(HybridBlock):
    """A function as a hybrid block: a name of ``mx.np`` or ``mx.npx``,
    or a callable."""

    def __init__(self, function):
        super().__init__()
        if isinstance(function, str):
            self._func = _np_function(function, with_npx=True)
            self._func_name = function
            self._np = True
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")
            self._np = False

    def forward(self, *args):
        if self._np:
            return _call_np(self._func, args)
        return self._func(*args)

    def __repr__(self):
        return f"HybridLambda({self._func_name})"


def _concat(outs, axis):
    if isinstance(outs[0], NDArray):
        from ... import numpy as np
        return np.concatenate(outs, axis=axis)
    return torch.cat(outs, dim=axis)


class Concatenate(Sequential):
    """Run every child on the same input and concatenate the outputs
    along ``axis``."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _concat([child(x) for child in self._children.values()],
                       self.axis)


class HybridConcatenate(HybridSequential):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _concat([child(x) for child in self._children.values()],
                       self.axis)


Concurrent = Concatenate
HybridConcurrent = HybridConcatenate
