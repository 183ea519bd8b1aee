"""Convolutional recurrent cells (the port of
``mxnet_tpu/gluon/rnn/conv_rnn_cell.py``): ``Conv{1,2,3}D{RNN,LSTM,GRU}
Cell``.

The input-to-hidden and hidden-to-hidden paths are ``ops.nn``
convolutions (cuDNN, TF32 off; stride 1; the h2h kernel must be odd so
``pad = dilate * (k - 1) / 2`` keeps the state's spatial shape, and an
even one is refused), and the gate math is the dense cells'
(``rnn_cell.py``). Layouts are channels-first (``NCW``/``NCHW``/
``NCDHW``). The forward is written over tensors, as the other cells'.
"""
from __future__ import annotations

import torch

from ...ops import nn as _nn
from ..parameter import Parameter
from .rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _spec(v, dims):
    if isinstance(v, int):
        return (v,) * dims
    v = tuple(int(x) for x in v)
    assert len(v) == dims, f"expected {dims}-d conv spec, got {v}"
    return v


class _ConvRNNBase(RecurrentCell):
    _gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2, conv_layout="NCHW", activation="tanh"):
        super().__init__()
        if not conv_layout.startswith("NC"):
            raise ValueError("conv cells support channels-first "
                             f"layouts only, got {conv_layout!r}")
        self._dims = dims
        self._layout = conv_layout
        self._hc = hidden_channels
        self._activation = activation
        self._input_shape = tuple(input_shape)  # (C, *spatial)
        self._i2h_kernel = _spec(i2h_kernel, dims)
        self._i2h_pad = _spec(i2h_pad, dims)
        self._i2h_dilate = _spec(i2h_dilate, dims)
        self._h2h_kernel = _spec(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError("h2h_kernel must be odd so the state's "
                             f"spatial shape is preserved, got "
                             f"{self._h2h_kernel}")
        self._h2h_dilate = _spec(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))

        in_c = self._input_shape[0]
        spatial = self._input_shape[1:]
        state_sp = tuple(
            s + 2 * p - d * (k - 1) for s, p, d, k in
            zip(spatial, self._i2h_pad, self._i2h_dilate,
                self._i2h_kernel)) if spatial else ()
        self._state_shape = (hidden_channels,) + state_sp

        g = self._gates
        self.i2h_weight = Parameter(
            "i2h_weight", shape=(g * hidden_channels, in_c)
            + self._i2h_kernel, init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(g * hidden_channels, hidden_channels)
            + self._h2h_kernel, init=h2h_weight_initializer,
            allow_deferred_init=True)
        self.i2h_bias = Parameter("i2h_bias",
                                  shape=(g * hidden_channels,),
                                  init=i2h_bias_initializer,
                                  allow_deferred_init=True)
        self.h2h_bias = Parameter("h2h_bias",
                                  shape=(g * hidden_channels,),
                                  init=h2h_bias_initializer,
                                  allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": self._layout}] * self._n_states

    _n_states = 1

    def _convs(self, inputs, states):
        i2h = _nn.convolution(
            inputs, self.i2h_weight._read(), self.i2h_bias._read(),
            kernel=self._i2h_kernel, stride=1, pad=self._i2h_pad,
            dilate=self._i2h_dilate, layout=self._layout)
        h2h = _nn.convolution(
            states[0], self.h2h_weight._read(), self.h2h_bias._read(),
            kernel=self._h2h_kernel, stride=1, pad=self._h2h_pad,
            dilate=self._h2h_dilate, layout=self._layout)
        return i2h, h2h

    def _act(self, x):
        return _nn.activation(x, self._activation)


class _ConvRNNCell(_ConvRNNBase):
    _gates = 1
    _n_states = 1

    def _alias(self):
        return "conv_rnn"

    def forward(self, inputs, states):
        i2h, h2h = self._convs(inputs, states)
        output = self._act(i2h + h2h)
        return output, [output]


class _ConvLSTMCell(_ConvRNNBase):
    """Gate order [i, f, g, o] on the channel axis, matching
    LSTMCell/the fused kernel."""

    _gates = 4
    _n_states = 2

    def _alias(self):
        return "conv_lstm"

    def forward(self, inputs, states):
        i2h, h2h = self._convs(inputs, states)
        gates = i2h + h2h
        in_g, forget_g, in_t, out_g = gates.chunk(4, dim=1)
        in_g = torch.sigmoid(in_g)
        forget_g = torch.sigmoid(forget_g)
        in_t = self._act(in_t)
        out_g = torch.sigmoid(out_g)
        next_c = forget_g * states[1] + in_g * in_t
        next_h = out_g * self._act(next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_ConvRNNBase):
    _gates = 3
    _n_states = 1

    def _alias(self):
        return "conv_gru"

    def forward(self, inputs, states):
        i2h, h2h = self._convs(inputs, states)
        i2h_r, i2h_z, i2h_n = i2h.chunk(3, dim=1)
        h2h_r, h2h_z, h2h_n = h2h.chunk(3, dim=1)
        reset = torch.sigmoid(i2h_r + h2h_r)
        update = torch.sigmoid(i2h_z + h2h_z)
        cand = self._act(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make(name, base, dims, layout, doc):
    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", conv_layout=layout,
                 activation="tanh"):
        base.__init__(self, input_shape, hidden_channels, i2h_kernel,
                      h2h_kernel, i2h_pad=i2h_pad,
                      i2h_dilate=i2h_dilate, h2h_dilate=h2h_dilate,
                      i2h_weight_initializer=i2h_weight_initializer,
                      h2h_weight_initializer=h2h_weight_initializer,
                      i2h_bias_initializer=i2h_bias_initializer,
                      h2h_bias_initializer=h2h_bias_initializer,
                      dims=dims, conv_layout=conv_layout,
                      activation=activation)
    cls = type(name, (base,), {"__init__": __init__, "__doc__": doc})
    return cls


Conv1DRNNCell = _make("Conv1DRNNCell", _ConvRNNCell, 1, "NCW",
                      "1D convolutional RNN cell; input (B, C, W).")
Conv2DRNNCell = _make("Conv2DRNNCell", _ConvRNNCell, 2, "NCHW",
                      "2D convolutional RNN cell; input (B, C, H, W).")
Conv3DRNNCell = _make("Conv3DRNNCell", _ConvRNNCell, 3, "NCDHW",
                      "3D convolutional RNN cell; input (B, C, D, H, W).")
Conv1DLSTMCell = _make("Conv1DLSTMCell", _ConvLSTMCell, 1, "NCW",
                       "1D ConvLSTM (Shi et al. 2015); input (B, C, W).")
Conv2DLSTMCell = _make("Conv2DLSTMCell", _ConvLSTMCell, 2, "NCHW",
                       "2D ConvLSTM (Shi et al. 2015); input "
                       "(B, C, H, W).")
Conv3DLSTMCell = _make("Conv3DLSTMCell", _ConvLSTMCell, 3, "NCDHW",
                       "3D ConvLSTM (Shi et al. 2015); input "
                       "(B, C, D, H, W).")
Conv1DGRUCell = _make("Conv1DGRUCell", _ConvGRUCell, 1, "NCW",
                      "1D convolutional GRU cell; input (B, C, W).")
Conv2DGRUCell = _make("Conv2DGRUCell", _ConvGRUCell, 2, "NCHW",
                      "2D convolutional GRU cell; input (B, C, H, W).")
Conv3DGRUCell = _make("Conv3DGRUCell", _ConvGRUCell, 3, "NCDHW",
                      "3D convolutional GRU cell; input "
                      "(B, C, D, H, W).")
