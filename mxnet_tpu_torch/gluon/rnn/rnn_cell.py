"""Recurrent cells (the port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``).

The cell math is the fused layers' (LSTM gates [i, f, g, o]; GRU linear
before reset), so cells and ``rnn.LSTM``/``GRU``/``RNN`` are
interchangeable. A cell's ``forward(inputs, states)`` is written over
tensors (``_tensor_forward``): called with NDArrays it takes and gives
NDArrays. ``unroll`` steps the cell ``length`` times in a Python loop
on tensors, whatever it was given, and returns the kind it was given
(under ``autograd.record()`` with NDArrays, on the tape).
``begin_state`` makes zeros on the parameters' context; a cell wrapped
by a modifier refuses to be called or to make states on its own
(``_modified``), as in the reference.

The regularizing cells draw their masks from the device's generator
(``random_state``) in training mode only (``autograd.is_training()``):
``DropoutCell`` a mask a step, ``ZoneoutCell`` a mask a step for the
outputs and the states, ``VariationalDropoutCell`` one mask a sequence
for the inputs, the first state and the outputs (``reset()``, which
``unroll`` calls, draws anew).
"""
from __future__ import annotations

import torch

from ... import autograd, random_state
from ...ndarray.ndarray import NDArray
from ...ops import nn as _nn
from ..block import HybridBlock, _unwrap, _wrap
from ..parameter import Parameter
from .rnn_layer import _begin_state

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "LSTMPCell", "GRUCell", "SequentialRNNCell",
           "HybridSequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "VariationalDropoutCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """The inputs as a list of per-step tensors (``merge`` False) or one
    tensor with the time axis of ``layout``; and that axis and the batch
    size."""
    assert layout in ("TNC", "NTC")
    batch_axis = layout.find("N")
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        batch_size = inputs[0].shape[batch_axis - 1 if batch_axis > axis
                                     else batch_axis]
        if merge:
            return torch.stack(list(inputs), dim=axis), axis, batch_size
        return list(inputs), axis, batch_size
    batch_size = inputs.shape[batch_axis]
    if merge is False:
        return list(inputs.unbind(axis)), axis, batch_size
    return inputs, axis, batch_size


def _ndarray_ctx(*values):
    """The context of the first NDArray among ``values`` (lists too), or
    None when they are all tensors."""
    for v in values:
        if isinstance(v, NDArray):
            return v.ctx
        if isinstance(v, (list, tuple)):
            ctx = _ndarray_ctx(*v)
            if ctx is not None:
                return ctx
    return None


def _drop(x, p, axes=()):
    """Inverted dropout in training mode, from the device's generator."""
    if p <= 0 or not autograd.is_training():
        return x
    return _nn.dropout(x, p, axes, random_state.generator(x.device))


class RecurrentCell(HybridBlock):
    """Base class of the recurrent cells."""

    _tensor_forward = True

    def __init__(self):
        super().__init__()
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters (and the children's)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: zeros on the parameters' context, or
        ``func(shape, **kwargs)``."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        states = _begin_state(self, batch_size, func, kwargs)
        self._init_counter += len(states)
        return states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states):
        raise NotImplementedError

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times over ``inputs`` (one array
        with the time axis of ``layout``, or a list of steps): the
        outputs (merged unless ``merge_outputs`` is False) and the last
        states; with ``valid_length``, each sequence's state at its last
        valid step and zeros past it in the outputs."""
        ctx = _ndarray_ctx(inputs, begin_state, valid_length)
        if ctx is None:
            return self._unroll(length, inputs, begin_state, layout,
                                merge_outputs, valid_length)
        with torch.set_grad_enabled(autograd.is_recording()):
            out = self._unroll(length, _unwrap(inputs), _unwrap(begin_state),
                               layout, merge_outputs, _unwrap(valid_length))
        return _wrap(out, ctx)

    def _begin_tensors(self, batch_size):
        return _unwrap(self.begin_state(batch_size))

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        states = begin_state if begin_state is not None else \
            self._begin_tensors(batch_size)
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            stacked = [torch.stack([s[j] for s in all_states], dim=0)
                       for j in range(len(states))]
            idx = (valid_length - 1).to(torch.int64)
            batch = torch.arange(batch_size, device=idx.device)
            states = [s[idx, batch] for s in stacked]
            outputs = [
                torch.where((valid_length > i).unsqueeze(-1), outputs[i],
                            torch.zeros_like(outputs[i]))
                for i in range(length)]
        merged, _, _ = _format_sequence(
            length, outputs, layout,
            merge_outputs if merge_outputs is not None else True)
        return merged, states


HybridRecurrentCell = RecurrentCell


def _weight(name, shape, init):
    return Parameter(name, shape=shape, init=init, allow_deferred_init=True)


class RNNCell(RecurrentCell):
    """Elman RNN cell: ``h' = act(W_i2h x + b_i2h + W_h2h h + b_h2h)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = _weight("i2h_weight", (hidden_size, input_size),
                                  i2h_weight_initializer)
        self.h2h_weight = _weight("h2h_weight", (hidden_size, hidden_size),
                                  h2h_weight_initializer)
        self.i2h_bias = _weight("i2h_bias", (hidden_size,),
                                i2h_bias_initializer)
        self.h2h_bias = _weight("h2h_bias", (hidden_size,),
                                h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _products(self, inputs, states, gates):
        """``i2h`` and ``h2h``, the i2h shape settled from ``inputs``."""
        if not self.i2h_weight._shape_known():
            self.i2h_weight._infer_shape(
                (gates * self._hidden_size,
                 inputs.reshape(inputs.shape[0], -1).shape[1]))
        i2h = _nn.fully_connected(inputs, self.i2h_weight._read(),
                                  self.i2h_bias._read())
        h2h = _nn.fully_connected(states[0], self.h2h_weight._read(),
                                  self.h2h_bias._read())
        return i2h, h2h

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states, 1)
        output = _nn.activation(i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(RecurrentCell):
    """LSTM cell, gates [i, f, g, o] (cuDNN's and the fused layer's)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, activation="tanh",
                 recurrent_activation="sigmoid", _recurrent_size=None):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._activation = activation
        self._recurrent_activation = recurrent_activation
        self.i2h_weight = _weight("i2h_weight",
                                  (4 * hidden_size, input_size),
                                  i2h_weight_initializer)
        # what feeds h2h: the hidden state, or LSTMPCell's projection
        self.h2h_weight = _weight(
            "h2h_weight", (4 * hidden_size, _recurrent_size or hidden_size),
            h2h_weight_initializer)
        self.i2h_bias = _weight("i2h_bias", (4 * hidden_size,),
                                i2h_bias_initializer)
        self.h2h_bias = _weight("h2h_bias", (4 * hidden_size,),
                                h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    _products = RNNCell._products

    def _lstm_step(self, inputs, states):
        """The gates from ``states[0]`` (the hidden state, or the
        projection) and the cell ``states[1]``: (hidden, next cell)."""
        i2h, h2h = self._products(inputs, states, 4)
        in_gate, forget_gate, in_transform, out_gate = \
            (i2h + h2h).chunk(4, dim=-1)
        rec = self._recurrent_activation
        in_gate = _nn.activation(in_gate, rec)
        forget_gate = _nn.activation(forget_gate, rec)
        in_transform = _nn.activation(in_transform, self._activation)
        out_gate = _nn.activation(out_gate, rec)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * _nn.activation(next_c, self._activation)
        return next_h, next_c

    def forward(self, inputs, states):
        next_h, next_c = self._lstm_step(inputs, states)
        return next_h, [next_h, next_c]


class LSTMPCell(LSTMCell):
    """LSTM cell with a projection (Sak et al., 2014): the output is
    ``r = W_h2r (o * act(c))`` of ``projection_size``, and h2h reads
    ``r``. States ``[r, c]``."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, activation="tanh",
                 recurrent_activation="sigmoid"):
        super().__init__(hidden_size,
                         i2h_weight_initializer=i2h_weight_initializer,
                         h2h_weight_initializer=h2h_weight_initializer,
                         i2h_bias_initializer=i2h_bias_initializer,
                         h2h_bias_initializer=h2h_bias_initializer,
                         input_size=input_size, activation=activation,
                         recurrent_activation=recurrent_activation,
                         _recurrent_size=projection_size)
        self._projection_size = projection_size
        self.h2r_weight = _weight("h2r_weight",
                                  (projection_size, hidden_size),
                                  h2r_weight_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def forward(self, inputs, states):
        hidden, next_c = self._lstm_step(inputs, states)
        next_r = _nn.fully_connected(hidden, self.h2r_weight._read())
        return next_r, [next_r, next_c]


class GRUCell(RecurrentCell):
    """GRU cell (linear before reset, as the fused layer)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = _weight("i2h_weight",
                                  (3 * hidden_size, input_size),
                                  i2h_weight_initializer)
        self.h2h_weight = _weight("h2h_weight",
                                  (3 * hidden_size, hidden_size),
                                  h2h_weight_initializer)
        self.i2h_bias = _weight("i2h_bias", (3 * hidden_size,),
                                i2h_bias_initializer)
        self.h2h_bias = _weight("h2h_bias", (3 * hidden_size,),
                                h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    _products = RNNCell._products

    def forward(self, inputs, states):
        prev_h = states[0]
        i2h, h2h = self._products(inputs, states, 3)
        i2h_r, i2h_z, i2h_n = i2h.chunk(3, dim=-1)
        h2h_r, h2h_z, h2h_n = h2h.chunk(3, dim=-1)
        reset_gate = torch.sigmoid(i2h_r + h2h_r)
        update_gate = torch.sigmoid(i2h_z + h2h_z)
        next_h_tmp = torch.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input."""

    def __init__(self):
        super().__init__()

    def add(self, cell):
        self.register_child(cell)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            next_states.extend(state)
            p += n
        return inputs, next_states


HybridSequentialRNNCell = SequentialRNNCell


class DropoutCell(RecurrentCell):
    """Dropout on the input, a fresh mask a step (``axes`` share a
    draw)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def forward(self, inputs, states):
        return _drop(inputs, self._rate, self._axes), states


class ModifierCell(RecurrentCell):
    """Base of the cells that wrap another cell (which then refuses to
    be used on its own)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % str(base_cell)
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin


def _ones_mask(p, like):
    """Dropout of ones shaped like ``like``: the mask itself."""
    return _drop(torch.ones_like(like), p)


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al., 2016): in training, each output and
    state element keeps its previous value with probability
    ``zoneout_outputs``/``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Apply ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self._zoneout_outputs, self._zoneout_states
        prev_output = self._prev_output if self._prev_output is not None \
            else torch.zeros_like(next_output)
        output = torch.where(_ones_mask(p_outputs, next_output) > 0,
                             next_output, prev_output) \
            if p_outputs != 0.0 else next_output
        new_states = [torch.where(_ones_mask(p_states, ns) > 0, ns, s)
                      for ns, s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """``output = base(input) + input``."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class VariationalDropoutCell(ModifierCell):
    """Variational (locked) dropout (Gal & Ghahramani, 2016): one mask a
    sequence for the inputs, the first state and the outputs, shared by
    every step; ``reset()`` draws anew. Without state dropout ``unroll``
    masks the whole sequence at once (one draw broadcast along time) and
    unrolls the base cell, which is how a wrapped ``BidirectionalCell``
    works."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell), \
            "BidirectionalCell doesn't support variational state " \
            "dropout; apply it to the cells underneath instead."
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def forward(self, inputs, states):
        if self._drop_inputs:
            if self._input_mask is None:
                self._input_mask = _ones_mask(self._drop_inputs, inputs)
            inputs = inputs * self._input_mask
        if self._drop_states:
            if self._state_mask is None:
                self._state_mask = _ones_mask(self._drop_states, states[0])
            states = [states[0] * self._state_mask] + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if self._drop_outputs:
            if self._output_mask is None:
                self._output_mask = _ones_mask(self._drop_outputs, output)
            output = output * self._output_mask
        return output, next_states

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        self.reset()
        if self._drop_states:
            return super()._unroll(length, inputs, begin_state, layout,
                                   merge_outputs, valid_length)
        t_axis = layout.find("T")
        merged, _, _ = _format_sequence(length, inputs, layout, True)
        merged = _drop(merged, self._drop_inputs, (t_axis,))
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell._unroll(
                length, merged, begin_state, layout, True, valid_length)
        finally:
            self.base_cell._modified = True
        outputs = _drop(outputs, self._drop_outputs, (t_axis,))
        outputs, _, _ = _format_sequence(
            length, outputs, layout,
            merge_outputs if merge_outputs is not None else True)
        return outputs, states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence in opposite directions, outputs
    concatenated (through ``unroll`` only)."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state([self.l_cell, self.r_cell],
                                  batch_size=batch_size, **kwargs)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = begin_state if begin_state is not None else \
            self._begin_tensors(batch_size)
        n_l = len(self.l_cell.state_info())
        l_outputs, l_states = self.l_cell._unroll(
            length, inputs, begin_state[:n_l], layout, False, valid_length)
        if valid_length is None:
            rev_inputs = list(reversed(inputs))
        else:
            # each sequence reversed within its valid length, the padding
            # left in place (the reference's _reverse_sequences)
            rev_inputs = list(_nn.sequence_reverse(
                torch.stack(inputs, dim=0), valid_length, True).unbind(0))
        r_outputs, r_states = self.r_cell._unroll(
            length, rev_inputs, begin_state[n_l:], layout, False,
            valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            r_outputs = list(_nn.sequence_reverse(
                torch.stack(r_outputs, dim=0), valid_length, True).unbind(0))
        outputs = [torch.cat([l, r], dim=-1)
                   for l, r in zip(l_outputs, r_outputs)]
        merged, _, _ = _format_sequence(
            length, outputs, layout,
            merge_outputs if merge_outputs is not None else True)
        return merged, l_states + r_states
