"""The port's ``gluon.rnn`` against the JAX package's, on the CPU.

The fused layers (``RNN`` relu/tanh, ``LSTM``, ``GRU``) at hidden 8,
T 5, N 3, input 4: the port layer is built with ``input_size=0`` (its
i2h shapes deferred to a first forward with ``states=None``, which
returns the output alone), then takes the JAX layer's seeded parameters
by name (``load_jax_params``); outputs and states from seeded begin
states, and for two configurations the gradients of a seeded weighting
of the output and the states with respect to the input, the begin
states and every parameter. Together the configurations cover both
layouts, two layers, both directions, ``use_sequence_length``, LSTMP
(``projection_size``) and the state clips; a hybridized port layer
gives the same values. Every cell's ``unroll`` with ``valid_length``
(the modifier cells at p = 0), ``LSTMCell``'s gradients, one conv cell
per dimension, and the port's own properties of the dropout cells
(the locked mask, resampled by ``reset``; the identity outside training)
and the modifier assertion, as ``tests/test_rnn_cell_parity.py`` checks
the reference's.

The JAX blocks start from ``init.Zero()`` (a seeded ``Uniform`` draw
compiles for seconds a shape) and the JAX layers run hybridized (one
program a configuration, about 2 s with its gradient), once each.

Tolerances: forwards within 1e-5 relative and absolute (the same
products in another order, over five steps); gradients within 1e-4
(sums over the batch and the steps); the hybridized forward, and a
tensor forward against an NDArray one, exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.parameter import load_jax_params

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RED = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
H, T, N, I = 8, 5, 3, 4
SEQ_LEN = onp.array([5, 3, 1], "i4")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _u(shape, seed, lo=-0.5, hi=0.5):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype("f4")


def _jax_params(block, seed):
    """Seeded values written into ``block``'s parameters, by name."""
    rs = onp.random.RandomState(seed)
    params = {}
    for name, p in block.collect_params().items():
        params[name] = rs.uniform(-0.5, 0.5, p.shape).astype("f4")
        p.set_data(jmx.np.array(params[name]))
    return params


#: id -> (factory(rnn, input_size), layout, use_sequence_length,
#: cross the gradients)
LAYERS = {
    "lstm_2layer_bidirectional_seqlen_ntc": (
        lambda r, i: r.LSTM(H, num_layers=2, bidirectional=True,
                            layout="NTC", use_sequence_length=True,
                            input_size=i), "NTC", True, True),
    "gru_tnc": (lambda r, i: r.GRU(H, input_size=i), "TNC", False, True),
    "rnn_tanh_2layer_tnc": (
        lambda r, i: r.RNN(H, num_layers=2, activation="tanh",
                           input_size=i), "TNC", False, False),
    "rnn_relu_bidirectional_ntc": (
        lambda r, i: r.RNN(H, bidirectional=True, layout="NTC",
                           input_size=i), "NTC", False, False),
    "lstmp_clip_ntc": (
        lambda r, i: r.LSTM(H, projection_size=5, layout="NTC",
                            state_clip_min=-0.3, state_clip_max=0.3,
                            state_clip_nan=True, input_size=i),
        "NTC", False, False),
}


def _layer_run(pkg, layer, x, states, seq, grads):
    """Output and states (and, with ``grads``, the gradients of a seeded
    weighting of them) as numpy."""
    xa = pkg.np.array(x)
    sa = [pkg.np.array(s) for s in states]
    extra = [pkg.np.array(seq)] if seq is not None else []
    if not grads:
        out, st = layer(xa, sa, *extra)
        return [out.asnumpy()] + [s.asnumpy() for s in st], {}
    xa.attach_grad()
    for s in sa:
        s.attach_grad()
    with pkg.autograd.record():
        out, st = layer(xa, sa, *extra)
        total = (out * pkg.np.array(_u(out.shape, 31))).sum()
        for k, s in enumerate(st):
            total = total + (s * pkg.np.array(_u(s.shape, 32 + k))).sum()
    total.backward()
    g = {"x": xa.grad.asnumpy(),
         **{f"state{k}": s.grad.asnumpy() for k, s in enumerate(sa)},
         **{n: p.grad().asnumpy()
            for n, p in layer.collect_params().items()}}
    return [out.asnumpy()] + [s.asnumpy() for s in st], g


@pytest.mark.parametrize("case", list(LAYERS))
def test_layer_matches_reference(case):
    factory, layout, use_seq, grads = LAYERS[case]
    x = _u((N, T, I) if layout == "NTC" else (T, N, I), 1, -1.0, 1.0)
    seq = SEQ_LEN if use_seq else None
    jl = factory(jrnn, I)
    jl.initialize(jmx.init.Zero())
    jl.hybridize()
    params = _jax_params(jl, 11)
    states = [_u(info["shape"], 20 + k)
              for k, info in enumerate(jl.state_info(N))]
    # the port layer: input_size deferred to its first forward
    tl = factory(trnn, 0)
    tl.initialize()
    assert not tl.l0_i2h_weight._shape_known()
    first = tl(torch.from_numpy(x), None,
               torch.from_numpy(seq) if use_seq else None)
    assert torch.is_tensor(first)           # states=None: the output alone
    assert tl.l0_i2h_weight.shape[1] == I
    assert list(tl.collect_params()) == list(jl.collect_params())
    load_jax_params(tl, params)
    ref, ref_g = _layer_run(jmx, jl, x, states, seq, grads)
    got, got_g = _layer_run(tmx, tl, x, states, seq, grads)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g, r, **RED)
    assert got_g.keys() == ref_g.keys()
    for k, r in ref_g.items():
        onp.testing.assert_allclose(got_g[k], r, err_msg=k, **GRAD)
    # a hybridized layer, and tensors in, give the same values
    plain = _layer_run(tmx, tl, x, states, seq, False)[0]
    tl.hybridize()
    hyb = _layer_run(tmx, tl, x, states, seq, False)[0]
    for g, r in zip(hyb, plain):
        onp.testing.assert_array_equal(g, r)
    extra = [torch.from_numpy(seq)] if use_seq else []
    out, st = tl(torch.from_numpy(x), [torch.from_numpy(s) for s in states],
                 *extra)
    onp.testing.assert_array_equal(out.detach().numpy(), plain[0])


def test_layer_names_flat_order_and_begin_state():
    """The flat vector has ``rnn_param_size``'s length in the reference's
    order; ``begin_state`` makes zeros on the parameters' context;
    ``repr`` and the state shape check are the reference's."""
    from mxnet_tpu_torch.ops import nn as ops_nn
    tl = trnn.LSTM(H, num_layers=2, bidirectional=True, projection_size=5,
                   input_size=I)
    jl = jrnn.LSTM(H, num_layers=2, bidirectional=True, projection_size=5,
                   input_size=I)
    tl.initialize()
    assert list(tl.collect_params()) == list(jl.collect_params())
    size = sum(int(onp.prod(getattr(tl, n).shape)) for n in tl._flat_names)
    assert size == ops_nn.rnn_param_size("lstm", I, H, 2, True, 5)
    assert tl._flat_names[:3] == ["l0_i2h_weight", "l0_h2h_weight",
                                  "l0_h2r_weight"]
    assert tl._flat_names[-1] == "r1_h2h_bias"
    assert repr(tl) == repr(jl)
    states = tl.begin_state(N)
    assert [s.shape for s in states] == [(4, N, 5), (4, N, H)]
    assert all(s.ctx == tmx.cpu() and not s.asnumpy().any() for s in states)
    custom = tl.begin_state(N, func=tmx.np.ones)
    assert all(s.asnumpy().all() for s in custom)
    with pytest.raises(ValueError, match="Invalid recurrent state shape"):
        tl(tmx.np.zeros((T, N, I)), [tmx.np.zeros((4, N + 1, 5)),
                                     tmx.np.zeros((4, N + 1, H))])
    with pytest.raises(ValueError, match="projection_size"):
        trnn.GRU(H, projection_size=3)


def test_layer_dropout_between_layers_in_training_only():
    """Dropout after each layer but the last, only in training mode,
    repeated by ``mx.random.seed``."""
    tl = trnn.LSTM(H, num_layers=2, dropout=0.5, input_size=I)
    tl.initialize()
    x = tmx.np.array(_u((T, N, I), 3))
    plain = tl(x).asnumpy()
    onp.testing.assert_array_equal(tl(x).asnumpy(), plain)
    runs = []
    for _ in range(2):
        tmx.random.seed(4)
        with tmx.autograd.train_mode():
            runs.append(tl(x).asnumpy())
    onp.testing.assert_array_equal(runs[0], runs[1])
    assert not onp.allclose(runs[0], plain)


def _cells(r, i):
    """id -> cell built in package ``r`` (input size ``i``)."""
    def seq():
        c = r.SequentialRNNCell()
        c.add(r.LSTMCell(H, input_size=i))
        c.add(r.DropoutCell(0.0))
        c.add(r.ResidualCell(r.GRUCell(H, input_size=H)))
        return c
    return {
        "RNNCell": lambda: r.RNNCell(H, activation="relu", input_size=i),
        "LSTMCell": lambda: r.LSTMCell(H, input_size=i),
        "LSTMPCell": lambda: r.LSTMPCell(H, 5, input_size=i),
        "GRUCell": lambda: r.GRUCell(H, input_size=i),
        "SequentialRNNCell": seq,
        "ZoneoutCell": lambda: r.ZoneoutCell(r.RNNCell(H, input_size=i),
                                             0.0, 0.0),
        "VariationalDropoutCell": lambda: r.VariationalDropoutCell(
            r.LSTMPCell(H, 5, input_size=i), 0.0, 0.0, 0.0),
        "BidirectionalCell": lambda: r.BidirectionalCell(
            r.LSTMCell(H, input_size=i), r.GRUCell(H, input_size=i)),
    }


@pytest.mark.parametrize("name", list(_cells(trnn, I)))
def test_cell_unroll_matches_reference(name):
    x = _u((N, T, I), 2, -1.0, 1.0)
    vl = onp.array([5, 3, 1], "f4")
    jc = _cells(jrnn, I)[name]()
    jc.initialize(jmx.init.Zero())
    params = _jax_params(jc, 12)
    tc = _cells(trnn, I)[name]()
    tc.initialize()
    load_jax_params(tc, params)
    assert list(tc.collect_params()) == list(jc.collect_params())
    res = {}
    for pkg, cell in ((jmx, jc), (tmx, tc)):
        out, st = cell.unroll(T, pkg.np.array(x), layout="NTC",
                              valid_length=pkg.np.array(vl))
        res[pkg] = [out.asnumpy()] + [s.asnumpy() for s in st]
    assert [a.shape for a in res[tmx]] == [a.shape for a in res[jmx]]
    for g, r in zip(res[tmx], res[jmx]):
        onp.testing.assert_allclose(g, r, **RED)
    # tensors in: tensors out, the same values; steps as a list, TNC
    out, st = tc.unroll(T, torch.from_numpy(x), layout="NTC",
                        valid_length=torch.from_numpy(vl))
    assert torch.is_tensor(out)
    onp.testing.assert_array_equal(out.numpy(), res[tmx][0])
    steps = [tmx.np.array(x[:, t]) for t in range(T)]
    outs, _ = tc.unroll(T, steps, layout="TNC", merge_outputs=False,
                        valid_length=tmx.np.array(vl))
    assert len(outs) == T
    onp.testing.assert_array_equal(outs[2].asnumpy(), res[tmx][0][:, 2])


def test_lstm_cell_gradients_match_reference():
    x = _u((N, T, I), 5, -1.0, 1.0)
    vl = onp.array([5, 3, 1], "f4")
    cells = {jmx: jrnn.LSTMCell(H, input_size=I),
             tmx: trnn.LSTMCell(H, input_size=I)}
    cells[jmx].initialize(jmx.init.Zero())
    cells[tmx].initialize()
    load_jax_params(cells[tmx], _jax_params(cells[jmx], 13))
    res = {}
    for pkg, cell in cells.items():
        xa = pkg.np.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            out, st = cell.unroll(T, xa, layout="NTC",
                                  valid_length=pkg.np.array(vl))
            total = (out * pkg.np.array(_u(out.shape, 41))).sum() \
                + (st[1] * pkg.np.array(_u(st[1].shape, 42))).sum()
        total.backward()
        res[pkg] = {"x": xa.grad.asnumpy(),
                    **{n: p.grad().asnumpy()
                       for n, p in cell.collect_params().items()}}
    for k, r in res[jmx].items():
        onp.testing.assert_allclose(res[tmx][k], r, err_msg=k, **GRAD)


CONV = [("Conv1DRNNCell", (2, 6)), ("Conv2DLSTMCell", (2, 5, 5)),
        ("Conv3DGRUCell", (2, 3, 3, 3))]


@pytest.mark.parametrize("cls,shape", CONV, ids=[c[0] for c in CONV])
def test_conv_cell_matches_reference(cls, shape):
    x = _u((2, 2) + shape, 6, -1.0, 1.0)
    jc = getattr(jrnn, cls)(shape, 3, 3, 3, i2h_pad=1)
    jc.initialize(jmx.init.Zero())
    params = _jax_params(jc, 14)
    tc = getattr(trnn, cls)(shape, 3, 3, 3, i2h_pad=1)
    tc.initialize()
    load_jax_params(tc, params)
    res = {}
    for pkg, cell in ((jmx, jc), (tmx, tc)):
        out, st = cell.unroll(2, pkg.np.array(x), layout="NTC")
        res[pkg] = [out.asnumpy()] + [s.asnumpy() for s in st]
    assert res[tmx][0].shape == (2, 2, 3) + shape[1:]
    for g, r in zip(res[tmx], res[jmx]):
        onp.testing.assert_allclose(g, r, **RED)


def test_conv_cell_rejects_even_h2h_kernel():
    with pytest.raises(ValueError, match="h2h_kernel must be odd"):
        trnn.Conv2DRNNCell((2, 5, 5), 3, 3, 2)


def test_variational_dropout_locked_and_resampled():
    """One mask for every step of an unroll; ``reset`` (and so each
    ``unroll``) draws anew; inverted scaling; the identity outside
    training."""
    cell = trnn.VariationalDropoutCell(trnn.RNNCell(16, input_size=16),
                                       drop_inputs=0.5)
    cell.initialize()
    ones = tmx.np.array(onp.ones((1, 16), "f4"))
    states = cell.begin_state(batch_size=1)
    with tmx.autograd.train_mode():
        cell(ones, states)
        m1 = cell._input_mask.numpy().copy()
        cell(ones, states)
        onp.testing.assert_array_equal(cell._input_mask.numpy(), m1)
        cell.reset()
        assert cell._input_mask is None
        cell(ones, states)
        m3 = cell._input_mask.numpy()
    assert (m1 != m3).any()
    assert set(onp.unique(m1)) <= {0.0, 2.0}
    x = tmx.np.array(onp.ones((1, 6, 16), "f4"))
    plain = trnn.RNNCell(16, input_size=16)
    plain.initialize()
    load_jax_params(cell.base_cell, {k: v.data().asnumpy() for k, v in
                                     plain.collect_params().items()})
    onp.testing.assert_allclose(
        cell.unroll(6, x)[0].asnumpy(), plain.unroll(6, x)[0].asnumpy(),
        **RED)
    with tmx.autograd.train_mode():
        a = cell.unroll(6, x, merge_outputs=True)[0].asnumpy()
        b = cell.unroll(6, x, merge_outputs=True)[0].asnumpy()
    assert not onp.array_equal(a, b)


def test_zoneout_and_dropout_cells_in_training():
    zc = trnn.ZoneoutCell(trnn.RNNCell(32, input_size=8), 0.5, 0.5)
    zc.initialize()
    x = tmx.np.array(_u((2, 4, 8), 7, 0.5, 1.0))
    with tmx.autograd.train_mode():
        out, _ = zc.unroll(4, x, merge_outputs=False)
    prev = onp.zeros((2, 32), "f4")
    kept = 0
    for o in out:
        o = o.asnumpy()
        kept += int((o == prev).sum())
        prev = o
    assert 0 < kept < 4 * 64
    dc = trnn.DropoutCell(0.5)
    with tmx.autograd.train_mode():
        d, _ = dc(tmx.np.array(onp.ones((64, 64), "f4")), [])
    assert abs((d.asnumpy() != 0).mean() - 0.5) < 0.05


def test_modifier_assertion_and_counters():
    base = trnn.LSTMCell(H, input_size=I)
    res = trnn.ResidualCell(base)
    with pytest.raises(AssertionError, match="modifier cell"):
        base.begin_state(2)
    with pytest.raises(AssertionError, match="already modified"):
        trnn.ZoneoutCell(base)
    res = trnn.ResidualCell(trnn.LSTMCell(I, input_size=I))
    base = res.base_cell
    res.initialize()
    states = res.begin_state(2)
    assert base._init_counter == 1 and base._modified
    res.unroll(3, tmx.np.array(_u((2, 3, I), 8)), begin_state=states)
    assert res._counter == 2 and base._counter == 2
    bi = trnn.BidirectionalCell(trnn.RNNCell(H), trnn.RNNCell(H))
    with pytest.raises(NotImplementedError, match="unroll"):
        bi(tmx.np.zeros((2, I)), [])


def test_rnn_names_match_reference():
    names = {n for n in dir(jrnn) if not n.startswith("_")
             and isinstance(getattr(jrnn, n), type)}
    assert len(names) == 3 + 14 + 9
    assert names == {n for n in dir(trnn) if not n.startswith("_")
                     and isinstance(getattr(trnn, n), type)}
    assert trnn.HybridRecurrentCell is trnn.RecurrentCell
    assert trnn.HybridSequentialRNNCell is trnn.SequentialRNNCell
