"""Fused recurrent layers ``RNN``/``LSTM``/``GRU`` (the port of
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

The parameter names (``{l|r}{layer}_{i2h|h2h|h2r}_{weight|bias}``) and
the flat concatenation order are the reference's, so a JAX model's
parameters (``load_jax_params``) and a ``.params`` file map one to one.
Each forward concatenates the parameters into the flat vector of
``ops.nn.rnn_param_size``'s length (every weight, i2h then h2h then the
LSTMP projection, per layer and direction; then every bias) and runs
``ops.nn.rnn``: one input projection a layer and direction, then the
recurrence step by step on cuBLAS products. The forward is written over
tensors (``_tensor_forward``); NDArrays in give NDArrays out.

``input_size=0`` defers the i2h shapes to the first forward.
``begin_state`` makes the states on the parameters' device (a card net
gets card states, a CPU net CPU ones); ``states=None`` returns the
output alone. Dropout between layers runs in training mode only, drawn
from the device's generator (``random_state``).
"""
from __future__ import annotations

import torch

from ... import autograd, random_state
from ...context import current_context
from ...ops import nn as _nn
from ..block import HybridBlock
from ..parameter import Parameter, _ctx_of

__all__ = ["RNN", "LSTM", "GRU"]


def _param_ctx(block):
    """The context of ``block``'s parameters: an initialized one's, else
    the one a pending deferred initialization will use, else the
    current context."""
    pending = None
    for p in block.collect_params().values():
        if p._initialized:
            return _ctx_of(p._var())
        if pending is None and p._deferred_init is not None:
            pending = p._deferred_init[1]
    return pending or current_context()


def _begin_state(block, batch_size, func, kwargs):
    """``block.state_info(batch_size)``'s states: ``func(shape,
    **kwargs)``, or zeros on the parameters' context when ``func`` is
    None (``ctx``/``device`` in ``kwargs`` choose another)."""
    if func is None:
        from ... import numpy as mxnp
        ctx = kwargs.pop("ctx", None) or kwargs.pop("device", None) \
            or _param_ctx(block)
        func = mxnp.zeros
        kwargs = dict(kwargs, ctx=ctx)
    states = []
    for info in block.state_info(batch_size):
        kw = dict(kwargs)
        if info is not None:
            kw.update(info)
        shape = kw.pop("shape")
        kw.pop("__layout__", None)
        states.append(func(shape, **kw))
    return states


class _RNNLayer(HybridBlock):
    _tensor_forward = True

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None,
                 h2r_weight_initializer=None, lstm_state_clip_min=None,
                 lstm_state_clip_max=None, lstm_state_clip_nan=False,
                 dtype="float32", use_sequence_length=False):
        super().__init__()
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be 'TNC' or 'NTC'"
        if projection_size and mode != "lstm":
            raise ValueError("projection_size is only defined for LSTM "
                             "(rnn-inl.h LSTMP)")
        self._hidden_size = hidden_size
        self._projection_size = projection_size or None
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._lstm_state_clip_min = lstm_state_clip_min
        self._lstm_state_clip_max = lstm_state_clip_max
        self._lstm_state_clip_nan = lstm_state_clip_nan
        self._dtype = dtype
        self._use_sequence_length = use_sequence_length
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        rec = self._projection_size or nh  # recurrent/output width
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                specs = [
                    ("i2h_weight", (ng * nh, ni), i2h_weight_initializer),
                    ("h2h_weight", (ng * nh, rec), h2h_weight_initializer),
                    ("i2h_bias", (ng * nh,), i2h_bias_initializer),
                    ("h2h_bias", (ng * nh,), h2h_bias_initializer)]
                if self._projection_size:
                    specs.append(("h2r_weight", (rec, nh),
                                  h2r_weight_initializer))
                for g, shape, init in specs:
                    name = f"{j}{i}_{g}"
                    setattr(self, name, Parameter(
                        name, shape=shape, init=init, dtype=dtype,
                        allow_deferred_init=True))
            ni = rec * self._dir
        w_gates = ("i2h", "h2h", "h2r") if self._projection_size \
            else ("i2h", "h2h")
        dirs = ["l", "r"][:self._dir]
        # the flat vector's order: every weight, then every bias
        self._flat_names = [
            f"{d}{layer}_{g}_weight" for layer in range(num_layers)
            for d in dirs for g in w_gates] + [
            f"{d}{layer}_{g}_bias" for layer in range(num_layers)
            for d in dirs for g in ("i2h", "h2h")]

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = f"{shape[1] if shape[1] else None} -> {self._hidden_size}"
        return s.format(name=type(self).__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, inputs, *args):
        """Settle the deferred i2h shapes from a rank-3 input."""
        assert inputs.ndim == 3, \
            "Input should be rank-3 [seq_len, batch, input_size]"
        ni = inputs.shape[2]
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                p = getattr(self, f"{j}{i}_i2h_weight")
                if not p._shape_known():
                    p._infer_shape((self._gates * self._hidden_size, ni))
            ni = (self._projection_size or self._hidden_size) * self._dir

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, zeros on the parameters' context unless
        ``func`` (called as ``func(shape, **kwargs)``) is given."""
        return _begin_state(self, batch_size, func, kwargs)

    def forward(self, inputs, states=None, sequence_length=None):
        self.infer_shape(inputs)
        batch_axis = 0 if self._layout == "NTC" else 1
        batch_size = inputs.shape[batch_axis]
        skip_states = states is None
        if skip_states:
            states = [torch.zeros(info["shape"], dtype=inputs.dtype,
                                  device=inputs.device)
                      for info in self.state_info(batch_size)]
        if torch.is_tensor(states):
            states = [states]
        for info, state in zip(self.state_info(batch_size), states):
            if tuple(state.shape) != info["shape"]:
                raise ValueError(
                    f"Invalid recurrent state shape. Expecting "
                    f"{info['shape']}, got {tuple(state.shape)}.")
        out, out_states = self._forward_kernel(inputs, states,
                                               sequence_length)
        return out if skip_states else (out, out_states)

    def _forward_kernel(self, inputs, states, sequence_length):
        if self._layout == "NTC":
            inputs = inputs.transpose(0, 1)
        params = torch.cat([getattr(self, n)._read().reshape(-1)
                            for n in self._flat_names])
        train = autograd.is_training()
        gen = random_state.generator(inputs.device) \
            if train and self._dropout > 0 else None
        rnn_out = _nn.rnn(
            inputs, params, states[0],
            state_cell=states[1] if self._mode == "lstm" else None,
            sequence_length=sequence_length
            if self._use_sequence_length else None,
            mode=self._mode, state_size=self._hidden_size,
            num_layers=self._num_layers, bidirectional=self._dir == 2,
            p=self._dropout, generator=gen, train=train,
            projection_size=self._projection_size,
            lstm_state_clip_min=self._lstm_state_clip_min,
            lstm_state_clip_max=self._lstm_state_clip_max,
            lstm_state_clip_nan=self._lstm_state_clip_nan)
        outputs, out_states = rnn_out[0], list(rnn_out[1:])
        if self._layout == "NTC":
            outputs = outputs.transpose(0, 1)
        return outputs, out_states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with tanh or ReLU non-linearity."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, dtype="float32", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, dtype=dtype, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (gates [i, f, g, o]); ``projection_size`` makes
    it an LSTMP."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 projection_size=None, h2r_weight_initializer=None,
                 state_clip_min=None, state_clip_max=None,
                 state_clip_nan=False, dtype="float32", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", projection_size, h2r_weight_initializer,
                         state_clip_min, state_clip_max, state_clip_nan,
                         dtype=dtype, **kwargs)

    def state_info(self, batch_size=0):
        h_shape = (self._num_layers * self._dir, batch_size,
                   self._projection_size or self._hidden_size)
        c_shape = (self._num_layers * self._dir, batch_size,
                   self._hidden_size)
        return [{"shape": h_shape, "__layout__": "LNC"},
                {"shape": c_shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (linear-before-reset, cuDNN's convention)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", dtype=dtype, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
