"""The port's losses against the JAX package's.

``mxnet_tpu_torch.gluon.loss``'s ``SoftmaxCrossEntropyLoss`` (sparse
and dense labels, ``from_logits``, ``weight``, ``sample_weight``, another
``axis``, a float label), ``L2Loss`` and ``L1Loss`` (with ``weight`` and
``sample_weight``, and a label of another shape that ``_reshape_like``
reshapes) on the same seeded numpy inputs as
``mxnet_tpu.gluon.loss``'s, in float32 and bfloat16 predictions.

Tolerance: float32 within 1e-6 relative (the same operations; the
log-softmax and the per-sample means sum in another order); bfloat16
within 2^-7 relative and 2^-7 absolute (the two frameworks round the
log-softmax and the means to bf16 at different points).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon

from mxnet_tpu_torch.gluon import loss as tloss

TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2.0 ** -7, 2.0 ** -7)}

B, C = 6, 5


def _rng(seed):
    return onp.random.RandomState(seed)


def _sparse(seed):
    r = _rng(seed)
    return (r.standard_normal((B, C)).astype("f4"),
            r.randint(0, C, (B,)).astype("i4"), None)


#: name -> (class, constructor kwargs, seed -> (pred, label,
#: sample_weight))
CASES = {
    "ce_sparse": ("SoftmaxCrossEntropyLoss", {}, _sparse),
    "ce_sparse_float_label": (
        "SoftmaxCrossEntropyLoss", {},
        lambda s: (_sparse(s)[0], _sparse(s)[1].astype("f4"), None)),
    "ce_dense": (
        "SoftmaxCrossEntropyLoss", {"sparse_label": False},
        lambda s: (_rng(s).standard_normal((B, C)).astype("f4"),
                   onp.eye(C, dtype="f4")[_rng(s + 1).randint(0, C, B)],
                   None)),
    "ce_from_logits": (
        "SoftmaxCrossEntropyLoss", {"from_logits": True},
        lambda s: (onp.log(onp.full((B, C), 1.0 / C, "f4")
                           * _rng(s).uniform(0.5, 1.5, (B, C))
                           .astype("f4")),
                   _rng(s).randint(0, C, (B,)).astype("i4"), None)),
    "ce_weight_sample_weight": (
        "SoftmaxCrossEntropyLoss", {"weight": 0.7},
        lambda s: (*_sparse(s)[:2],
                   _rng(s + 2).uniform(0, 2, (B,)).astype("f4"))),
    "ce_sequence_axis1": (
        "SoftmaxCrossEntropyLoss", {"axis": 1},
        lambda s: (_rng(s).standard_normal((B, C, 3)).astype("f4"),
                   _rng(s).randint(0, C, (B, 3)).astype("i4"), None)),
    "l2": ("L2Loss", {},
           lambda s: (_rng(s).standard_normal((B, 4)).astype("f4"),
                      _rng(s + 1).standard_normal((B, 4)).astype("f4"),
                      None)),
    "l2_weight_sample_weight_reshape": (
        "L2Loss", {"weight": 3.0},
        lambda s: (_rng(s).standard_normal((B, 4, 1)).astype("f4"),
                   _rng(s + 1).standard_normal((B, 4)).astype("f4"),
                   _rng(s + 2).uniform(0, 2, (B, 1, 1)).astype("f4"))),
    "l1": ("L1Loss", {},
           lambda s: (_rng(s).standard_normal((B, 4)).astype("f4"),
                      _rng(s + 1).standard_normal((B, 4)).astype("f4"),
                      None)),
    "l1_weight_sample_weight": (
        "L1Loss", {"weight": 0.5},
        lambda s: (_rng(s).standard_normal((B, 2, 3)).astype("f4"),
                   _rng(s + 1).standard_normal((B, 2, 3)).astype("f4"),
                   _rng(s + 2).uniform(0, 2, (B, 1, 1)).astype("f4"))),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(case, dtype):
    cls, kw, build = CASES[case]
    pred, label, sw = build(len(case))
    j = getattr(jgluon.loss, cls)(**kw)
    t = getattr(tloss, cls)(**kw)
    jargs = [jmx.np.array(pred).astype(dtype), jmx.np.array(label)]
    targs = [torch.from_numpy(pred).to(getattr(torch, dtype)),
             torch.from_numpy(label)]
    if sw is not None:
        jargs.append(jmx.np.array(sw))
        targs.append(torch.from_numpy(sw))
    ref = onp.asarray(j(*jargs).asnumpy(), "f4")
    got = t(*targs)
    assert got.shape == ref.shape == (B,)
    rtol, atol = TOL[dtype]
    onp.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                atol=atol)


def test_alias_and_repr():
    assert tloss.SoftmaxCELoss is tloss.SoftmaxCrossEntropyLoss
    assert repr(tloss.L1Loss(weight=2.0)) == repr(jgluon.loss.L1Loss(
        weight=2.0))


def test_loss_is_differentiable():
    pred = torch.randn(B, C, requires_grad=True)
    label = torch.randint(0, C, (B,))
    tloss.SoftmaxCrossEntropyLoss()(pred, label).sum().backward()
    want = torch.softmax(pred.detach(), -1)
    want[torch.arange(B), label] -= 1
    assert torch.allclose(pred.grad, want, atol=1e-6)
