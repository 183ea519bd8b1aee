"""The port's ``gluon.nn`` against the JAX package's, on the CPU: the
basic layers, the activations and the attention layers (the
convolution, pooling and pixel layers are ``test_torch_gluon_conv.py``'s,
on this file's helpers).

Each case builds the layer in both packages with the same arguments
(deferred shapes where the reference allows them), runs the JAX layer
once to settle its shapes, writes the same seeded numpy values into
its parameters, carries them across by name
(``gluon.parameter.load_jax_params``, which finishes the port layer's
deferred initialization), and runs both forwards on the same seeded
input, the JAX one unhybridized. The inputs are NDArrays; a second
port forward on the tensors must give the same result as a tensor.
``MultiHeadAttention`` runs the port's plain flash route (K1's plain
version) against the JAX layer's flash route, and the masked route
with ``valid_length``. Gradients (under ``autograd.record()``, of a
seeded weighting of the output) are crossed for the layers with a
distinct backward: ``MultiHeadAttention`` (K1-bwd's plain version)
here; Dense's are ``test_torch_gluon_trainer.py``'s, Conv2D's and
BatchNorm's (in training mode) the conv file's.

Tolerances: elementwise layers and pooling at 2e-6 (``TR``); products,
norms and attention at 1e-5 relative and absolute (``RED``), 1e-4 for
their gradients (a sum over the batch of products); shapes and dtypes
exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.base import NotPortedError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import load_jax_params

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TR = dict(rtol=2e-6, atol=2e-6)
RED = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _x(shape, seed=0, lo=-1.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype("f4")


INPUTS = {
    "d": _x((2, 5), 1),
    "s": _x((2, 6, 8), 2),
    "c1": _x((2, 4, 8), 3),
    "c2": _x((2, 4, 6, 6), 4),
    "c2l": _x((2, 6, 6, 4), 5),
    "c3": _x((2, 4, 4, 4, 4), 6),
    "ps1": _x((2, 8, 3), 7),
    "ps3": _x((1, 8, 2, 2, 2), 8),
    "tok": onp.array([[0, 3, 9], [7, 7, 1]], "i4"),
}


def _seq(nn, hybrid, *blocks):
    net = nn.HybridSequential() if hybrid else nn.Sequential()
    net.add(*blocks)
    return net


def _concat(nn, kind):
    net = getattr(nn, kind)(axis=1)
    net.add(nn.Dense(3), nn.Dense(2))
    return net


# (id, factory(nn) -> layer, input, tolerance)
CASES = [
    ("Sequential", lambda nn: _seq(nn, False, nn.Dense(4), nn.Dense(3)),
     "d", RED),
    ("HybridSequential",
     lambda nn: _seq(nn, True, nn.Dense(4, activation="relu"), nn.Dense(3)),
     "d", RED),
    ("Dense", lambda nn: nn.Dense(4, activation="tanh"), "c2", RED),
    ("Dense_no_flatten", lambda nn: nn.Dense(3, flatten=False,
                                             use_bias=False), "s", RED),
    ("Activation", lambda nn: nn.Activation("softrelu"), "d", TR),
    ("Dropout", lambda nn: nn.Dropout(0.5), "d", TR),
    ("BatchNorm", lambda nn: nn.BatchNorm(), "c2", RED),
    ("BatchNormReLU", lambda nn: nn.BatchNormReLU(), "c2", RED),
    ("SyncBatchNorm", lambda nn: nn.SyncBatchNorm(), "c2", RED),
    ("LayerNorm", lambda nn: nn.LayerNorm(), "s", RED),
    ("GroupNorm", lambda nn: nn.GroupNorm(num_groups=2), "c2", RED),
    ("InstanceNorm", lambda nn: nn.InstanceNorm(), "c2", RED),
    ("Embedding", lambda nn: nn.Embedding(10, 4), "tok", TR),
    ("Flatten", lambda nn: nn.Flatten(), "c2", TR),
    ("Identity", lambda nn: nn.Identity(), "d", TR),
    ("Lambda", lambda nn: nn.Lambda("tanh"), "d", TR),
    ("HybridLambda", lambda nn: nn.HybridLambda("relu"), "d", TR),
    ("Concatenate", lambda nn: _concat(nn, "Concatenate"), "d", RED),
    ("HybridConcatenate", lambda nn: _concat(nn, "HybridConcatenate"), "d",
     RED),
    ("Concurrent", lambda nn: _concat(nn, "Concurrent"), "d", RED),
    ("HybridConcurrent", lambda nn: _concat(nn, "HybridConcurrent"), "d",
     RED),
    ("LeakyReLU", lambda nn: nn.LeakyReLU(0.1), "d", TR),
    ("PReLU", lambda nn: nn.PReLU(in_channels=4), "c2", TR),
    ("ELU", lambda nn: nn.ELU(0.5), "d", TR),
    ("SELU", lambda nn: nn.SELU(), "d", TR),
    ("GELU", lambda nn: nn.GELU(), "d", TR),
    ("GELU_tanh", lambda nn: nn.GELU(approximation="tanh"), "d", TR),
    ("SiLU", lambda nn: nn.SiLU(), "d", TR),
    ("Swish", lambda nn: nn.Swish(2.0), "d", TR),
    ("Mish", lambda nn: nn.Mish(), "d", TR),
    ("MultiHeadAttention", lambda nn: nn.MultiHeadAttention(8, 2), "s", RED),
    ("MultiHeadAttention_causal",
     lambda nn: nn.MultiHeadAttention(8, 2, causal=True), "s", RED),
    ("TransformerEncoderCell",
     lambda nn: nn.TransformerEncoderCell(8, 2, hidden_dim=12, causal=True,
                                          activation="gelu"), "s", RED),
    ("TransformerEncoderCell_post_norm",
     lambda nn: nn.TransformerEncoderCell(8, 2, pre_norm=False), "s", RED),
]


def _pair(factory, x, seed=11):
    """The JAX layer and its port on the same seeded parameters (shapes
    settled by one JAX forward of ``x``)."""
    jl = factory(jnn)
    jl.initialize(jmx.init.Zero())
    jl(jmx.np.array(x))
    rs = onp.random.RandomState(seed)
    params = {}
    for name, p in jl.collect_params().items():
        v = rs.uniform(0.5, 1.5, p.shape) if "var" in name \
            else rs.uniform(-0.5, 0.5, p.shape)
        params[name] = v.astype("f4")
        p.set_data(jmx.np.array(params[name]))
    tl = factory(tnn)
    tl.initialize()
    load_jax_params(tl, params)
    return jl, tl


def check_layer(factory, inp, tol):
    """The layer's forward on NDArrays against the reference's, and the
    same layer on tensors returning the same values as a tensor."""
    x = INPUTS[inp]
    jl, tl = _pair(factory, x)
    assert list(tl.collect_params()) == list(jl.collect_params())
    ref = jl(jmx.np.array(x)).asnumpy()
    got = tl(tmx.np.array(x))
    assert isinstance(got, tmx.NDArray)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    onp.testing.assert_allclose(got.asnumpy(), ref, **tol)
    as_tensor = tl(torch.from_numpy(x))
    assert torch.is_tensor(as_tensor)
    onp.testing.assert_array_equal(as_tensor.numpy(), got.asnumpy())


def check_gradients(factory, inp):
    """The gradients of a seeded weighting of the output, with respect
    to the input and every parameter, against the reference's."""
    x = INPUTS[inp]
    jl, tl = _pair(factory, x)
    res = {}
    for pkg, layer in ((jmx, jl), (tmx, tl)):
        xa = pkg.np.array(x)
        xa.attach_grad()
        with pkg.autograd.record():
            y = layer(xa)
            w = pkg.np.array(_x(y.shape, 21))
            s = (y * w).sum()
        s.backward()
        res[pkg] = {"x": xa.grad.asnumpy(),
                    **{k: p.grad().asnumpy()
                       for k, p in layer.collect_params().items()
                       if p.grad_req != "null"}}
    assert res[tmx].keys() == res[jmx].keys()
    for k, ref in res[jmx].items():
        onp.testing.assert_allclose(res[tmx][k], ref, err_msg=k, **GRAD)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_reference(case):
    check_layer(*case[1:])


def test_every_reference_layer_has_a_case():
    from test_torch_gluon_conv import CASES as CONV_CASES
    names = {c[0].split("_")[0] for c in CASES + CONV_CASES}
    layers = {n for n in jnn.__dict__ if isinstance(getattr(jnn, n), type)
              and n not in ("Block", "HybridBlock")}
    assert len(layers) == 54 and layers <= names
    assert layers <= set(tnn.__all__)


def test_batch_norm_training_running_stats():
    """In training mode the batch's statistics normalize and the running
    ones move by the reference's momentum rule, on both packages."""
    x = INPUTS["c2"]
    for axis, xx in ((1, x), (3, INPUTS["c2l"])):
        def factory(nn):
            return nn.BatchNorm(axis=axis, momentum=0.8)
        jl, tl = _pair(factory, xx)
        with jmx.autograd.train_mode():
            ref = jl(jmx.np.array(xx)).asnumpy()
        with tmx.autograd.train_mode():
            got = tl(tmx.np.array(xx)).asnumpy()
        onp.testing.assert_allclose(got, ref, **RED)
        for name in ("running_mean", "running_var"):
            onp.testing.assert_allclose(
                getattr(tl, name).data().asnumpy(),
                getattr(jl, name).data().asnumpy(), **RED)
    # use_global_stats reads the running statistics even in training
    tl = tnn.BatchNorm(use_global_stats=True, in_channels=4)
    tl.initialize()
    with tmx.autograd.train_mode():
        out = tl(tmx.np.array(x)).asnumpy()
    onp.testing.assert_allclose(out, x / onp.sqrt(1 + 1e-5), **RED)
    onp.testing.assert_array_equal(tl.running_mean.data().asnumpy(),
                                   onp.zeros(4, "f4"))


def test_dropout_training_mode():
    x = onp.ones((64, 64), "f4")
    layer = tnn.Dropout(0.25)
    outs = []
    for _ in range(2):
        tmx.random.seed(5)
        with tmx.autograd.train_mode():
            outs.append(layer(tmx.np.array(x)).asnumpy())
    onp.testing.assert_array_equal(outs[0], outs[1])
    kept = outs[0] != 0
    assert abs(kept.mean() - 0.75) < 0.03
    onp.testing.assert_allclose(outs[0][kept], 1 / 0.75, rtol=1e-6)
    # spatial dropout: one draw along the shared axis
    with tmx.autograd.train_mode():
        sp = tnn.Dropout(0.5, axes=(1,))(tmx.np.array(x)).asnumpy()
    assert all(len(set(row)) == 1 for row in sp)


def test_multi_head_attention_valid_length():
    x = INPUTS["s"]
    vl = onp.array([3, 6], "i4")
    for causal in (False, True):
        def factory(nn):
            return nn.MultiHeadAttention(8, 2, causal=causal)
        jl, tl = _pair(factory, x)
        ref = jl(jmx.np.array(x), valid_length=jmx.np.array(vl)).asnumpy()
        got = tl(tmx.np.array(x), valid_length=tmx.np.array(vl)).asnumpy()
        onp.testing.assert_allclose(got, ref, **RED)
    cell = tnn.MultiHeadAttention(8, 2, sequence_parallel=True)
    cell.initialize()
    with pytest.raises(NotPortedError, match="item 20"):
        cell(tmx.np.array(x))


GRAD_CASES = [
    ("MultiHeadAttention",
     lambda nn: nn.MultiHeadAttention(8, 2, causal=True), "s"),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_layer_gradients_match_reference(case):
    check_gradients(*case[1:])
