"""Recurrent layers and cells (the port of ``mxnet_tpu/gluon/rnn``)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (  # noqa: F401
    RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell, GRUCell,
    SequentialRNNCell, HybridSequentialRNNCell, DropoutCell, ModifierCell,
    ZoneoutCell, ResidualCell, BidirectionalCell, LSTMPCell,
    VariationalDropoutCell,
)
from .conv_rnn_cell import (  # noqa: F401
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell,
)
