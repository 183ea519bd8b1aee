"""The port's nn ops and basic Gluon layers against mxnet_tpu.ops.nn on
the same numpy inputs (atol=1e-6: small fp32 reductions, two
libraries)."""
import numpy as onp
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.gluon import nn as gnn

ATOL = dict(rtol=0, atol=1e-6)


def _mk(seed, *shape, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale).astype("f4")


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


def test_layer_norm_matches():
    x = _mk(0, 3, 5, 32, scale=2.0) + 0.5
    g, b = _mk(1, 32) + 1.0, _mk(2, 32)
    onp.testing.assert_allclose(
        tnn.layer_norm(_t(x), _t(g), _t(b)).numpy(),
        onp.asarray(jnn.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b))), **ATOL)


def test_gelu_is_exact_erf():
    x = _mk(3, 1000, scale=3.0)
    onp.testing.assert_allclose(
        tnn.gelu(_t(x)).numpy(),
        onp.asarray(jnn.activation(jnp.asarray(x), "gelu")), **ATOL)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_dense_matches_fully_connected(act):
    x = _mk(4, 2, 7, 32, scale=0.5)
    w, bias = _mk(5, 48, 32, scale=0.2), _mk(6, 48)
    layer = gnn.Dense(48, activation=act, flatten=False, in_units=32)
    layer.weight.set_data(w)
    layer.bias.set_data(bias)
    ref = jnn.fully_connected(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias), flatten=False)
    if act:
        ref = jnn.activation(ref, act)
    onp.testing.assert_allclose(layer(_t(x)).numpy(), onp.asarray(ref),
                                **ATOL)


def test_embedding_matches():
    w = _mk(7, 50, 16)
    idx = onp.random.RandomState(8).randint(0, 50, size=(3, 9)).astype("i4")
    layer = gnn.Embedding(50, 16)
    layer.weight.set_data(w)
    onp.testing.assert_allclose(
        layer(_t(idx)).numpy(),
        onp.asarray(jnn.embedding(jnp.asarray(idx), jnp.asarray(w))),
        **ATOL)


def test_layers_need_static_shapes_and_initialization():
    with pytest.raises(ValueError, match="in_units"):
        gnn.Dense(4)
    layer = gnn.LayerNorm(in_channels=4)
    with pytest.raises(RuntimeError, match="not been initialized"):
        layer(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="shape"):
        layer.gamma.set_data(onp.ones(5, "f4"))
    assert [n for n in layer.collect_params()] == ["gamma", "beta"]
    drop = gnn.Dropout(0.5)
    x = torch.ones(3)
    assert drop(x) is x   # inference-only port: identity
