"""The port's ``npx.rnn`` and ``npx.ctc_loss`` against the JAX package's,
on the CPU: ``rnn`` (rnn_relu, rnn_tanh, lstm, gru; two layers;
bidirectional; the LSTMP projection; ``sequence_length`` masking; state
clipping; inter-layer dropout) over the reference's flat parameter
vector, with the gradients of the data, the parameters and the states;
``ctc_loss`` (blank first and last, with and without lengths) and its
gradient.

Tolerances (``test_torch_np_common.py``): dtype and shape exactly; the
values and gradients at 1e-5 (``RED``)."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import RED, check, grads, lift, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


T, N, I, H, L = 5, 3, 4, 5, 2
SEQ = onp.array([4, 2, 5], "i4")


def _rnn_case(mode, bidirectional, proj, seed):
    d = 2 if bidirectional else 1
    n = tmx.ops.nn.rnn_param_size(mode, I, H, L, bidirectional, proj)
    prm = values("float32", shape=(n,), lo=-0.4, hi=0.4, seed=seed)
    data = values("float32", shape=(T, N, I), seed=seed + 1)
    st = values("float32", shape=(L * d, N, proj or H), seed=seed + 2)
    args = [data, prm, st]
    if mode == "lstm":
        args.append(values("float32", shape=(L * d, N, H), seed=seed + 3))
    return args


RNN = [("lstm", False, 3), ("gru", True, None), ("rnn_tanh", False, None),
       ("rnn_relu", True, None)]


@pytest.mark.parametrize("mode,bi,proj", RNN, ids=lambda v: str(v))
def test_rnn(mode, bi, proj):
    """Outputs and final states (with ``sequence_length`` but for
    rnn_relu) and, for LSTM (projected, clipped) and GRU (bidirectional),
    the gradients of the data, the flat parameters and the states."""
    args = _rnn_case(mode, bi, proj, 10)
    kw = dict(mode=mode, state_size=H, num_layers=L, bidirectional=bi,
              projection_size=proj)
    if mode == "lstm":
        kw.update(lstm_state_clip_min=-0.6, lstm_state_clip_max=0.6)
    assert tmx.ops.nn.rnn_param_size(mode, I, H, L, bi, proj) \
        == jmx.ops.nn.rnn_param_size(mode, I, H, L, bi, proj)
    if mode in ("lstm", "gru"):
        t, j = grads("npx.rnn", tuple(args) + (SEQ,),
                     dict(kw, use_sequence_length=True),
                     wrt=tuple(range(len(args))), nojit=False)
        same(t, j, RED)
    elif mode == "rnn_tanh":
        check("npx.rnn", tuple(args) + (SEQ,),
              dict(kw, use_sequence_length=True), tol=RED)
    else:
        check("npx.rnn", tuple(args), kw, tol=RED)


def test_rnn_outputs_and_inter_layer_dropout():
    """``state_outputs=False`` gives the output alone; under training a
    dropout between layers changes the output, and p=0 does not."""
    args = _rnn_case("gru", False, None, 20)
    kw = dict(mode="gru", state_size=H, num_layers=L)
    xs = [lift(tmx, a) for a in args]
    base = tmx.npx.rnn(*xs, state_outputs=False, **kw).asnumpy()
    onp.testing.assert_array_equal(base, tmx.npx.rnn(*xs, **kw)[0].asnumpy())
    with tmx.autograd.train_mode():
        same_p0 = tmx.npx.rnn(*xs, state_outputs=False, p=0.0,
                              **kw).asnumpy()
        dropped = tmx.npx.rnn(*xs, state_outputs=False, p=0.5,
                              **kw).asnumpy()
    onp.testing.assert_array_equal(base, same_p0)
    assert not onp.allclose(base, dropped)


CTC = [({}, "first"),
       ({"use_data_lengths": True, "use_label_lengths": True}, "last")]


@pytest.mark.parametrize("kw,blank", CTC, ids=repr)
def test_ctc_loss(kw, blank):
    t_len, n, c = 8, 3, 5
    x = values("float32", shape=(t_len, n, c), seed=40)
    lab = onp.array([[1, 2, 2, 0], [3, 1, 0, 0], [4, 4, 2, 1]], "i4")
    if blank == "last":
        lab = lab - 1
        lab[lab < 0] = 0
    dl = onp.array([8, 6, 7], "i4")
    ll = onp.array([3, 2, 4], "i4")
    args = (x, lab, dl if kw.get("use_data_lengths") else None,
            ll if kw.get("use_label_lengths") else None)
    t, j = grads("npx.ctc_loss", args, dict(kw, blank_label=blank),
                 nojit=False)
    same(t, j, RED)


def test_ctc_loss_refuses_last_without_lengths():
    x = lift(tmx, values("float32", shape=(4, 2, 3), seed=41))
    lab = lift(tmx, onp.array([[1, 0], [1, 1]], "i4"))
    with pytest.raises(ValueError, match="label_lengths"):
        tmx.npx.ctc_loss(x, lab, blank_label="last")
    with pytest.raises(ValueError, match="first"):
        tmx.npx.ctc_loss(x, lab, blank_label="middle")
