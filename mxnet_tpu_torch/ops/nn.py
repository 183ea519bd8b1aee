"""Neural-network ops the GPT path uses, as plain PyTorch.

The subset of ``mxnet_tpu/ops/nn.py`` that ``gluon/model_zoo/gpt.py``
reaches: the fully-connected layer with the reference's ``(out, in)``
weight layout, layer normalization (biased variance, eps 1e-5, the
``accum_dtype`` policy), the exact erf GELU, the embedding lookup and
inverted dropout.
These are large products or elementwise passes that the reference left
to XLA outside any Pallas kernel, so here they stay library calls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import not_ported

__all__ = ["fully_connected", "accum_dtype", "layer_norm", "gelu",
           "activation", "embedding", "dropout"]


def fully_connected(x, weight, bias=None, flatten=True):
    """y = x @ W^T + b, weight layout (out_units, in_units). Operands of
    two float types promote as jnp promotes them (an fp32 activation
    against a bf16 weight computes in fp32)."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    dt = torch.promote_types(x.dtype, weight.dtype)
    if bias is not None:
        dt = torch.promote_types(dt, bias.dtype)
        bias = bias.to(dt)
    return F.linear(x.to(dt), weight.to(dt), bias)


def accum_dtype(dtype):
    """Normalization statistics accumulate in fp32 for 16-bit inputs
    and in the input's own dtype otherwise (fp32 stays put)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Biased-variance layer norm over ``axis``; the output returns in
    ``x``'s dtype."""
    cd = accum_dtype(x.dtype)
    xc = x.to(cd)
    mean = xc.mean(dim=axis, keepdim=True)
    var = xc.var(dim=axis, unbiased=False, keepdim=True)
    out = (xc - mean) * torch.rsqrt(var + eps)
    if axis < 0:
        axis += x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    out = out * gamma.to(cd).reshape(shape) + beta.to(cd).reshape(shape)
    return out.to(x.dtype)


def gelu(x):
    """Exact (erf) GELU: x * Phi(x)."""
    return F.gelu(x, approximate="none")


def activation(x, act_type):
    """The activations the GPT path uses (only ``"gelu"``)."""
    if act_type == "gelu":
        return gelu(x)
    raise not_ported(f"activation {act_type!r}", "15 (the gluon surface)")


def embedding(tokens, weight):
    """Row gather: ``weight[tokens]``."""
    return F.embedding(tokens.long(), weight)


def dropout(x, p, axes=(), generator=None):
    """Inverted dropout (the reference's ``ops.nn.dropout``): keep each
    element with probability ``1 - p`` (a uniform draw below it, as
    ``jax.random.bernoulli`` draws), scaled by ``1 / (1 - p)``, else 0;
    ``axes`` broadcast one draw along them. The draws come from
    ``generator`` and differ from JAX's for the same seed."""
    shape = list(x.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = 1.0 - p
    u = torch.rand(shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))
