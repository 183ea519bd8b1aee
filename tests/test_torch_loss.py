"""The port's losses against the JAX package's.

``mxnet_tpu_torch.gluon.loss``'s ``SoftmaxCrossEntropyLoss`` (sparse
and dense labels, ``from_logits``, ``weight``, ``sample_weight``, another
``axis``, a float label), ``L2Loss`` and ``L1Loss`` (with ``weight`` and
``sample_weight``, and a label of another shape that ``_reshape_like``
reshapes), and the other twelve names: ``SigmoidBinaryCrossEntropyLoss``
(``SigmoidBCELoss``; logits or ``from_sigmoid``, with and without
``pos_weight``), ``KLDivLoss`` (log-probabilities or logits),
``CTCLoss`` (``NTC``/``NT`` with 0 as padding, ``TNC``/``TN`` with
``pred_lengths`` and ``label_lengths``), ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss`` (signed and binary labels),
``TripletLoss``, ``PoissonNLLLoss`` (``from_logits``, and rates with
Stirling's term), ``CosineEmbeddingLoss`` and ``SDMLLoss``, on the same
seeded numpy inputs as ``mxnet_tpu.gluon.loss``'s, in float32 and
bfloat16 predictions.

Tolerance: float32 within 1e-6 relative (the same operations; the
log-softmax and the per-sample means sum in another order), 1e-5 for
``CTCLoss`` (ATen's forward recursion against optax's, in another
order over eight frames); bfloat16 within 2^-7 relative and 2^-7
absolute (the two frameworks round the log-softmax and the means to
bf16 at different points). An alignment that cannot fit its frames
costs ``inf`` in the port and a large finite value in the reference
(ROADMAP.md queue 3, "not queued"): a case holds each to its own.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon

from mxnet_tpu_torch.gluon import loss as tloss

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
#: per-case float32 tolerance where the recursion differs
F32_TOL = {"ctc_ntc_padding": (1e-5, 1e-5), "ctc_tnc_lengths": (1e-5, 1e-5)}

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


class Call:
    """A case's forward arguments (the first one the prediction, cast to
    the case's dtype) and keyword arguments."""

    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw


def _normal(s, *shape):
    return _rng(s).standard_normal(shape).astype("f4")


def _bits(s, *shape):
    return _rng(s).randint(0, 2, shape).astype("f4")


def _signs(s, *shape):
    return 2 * _bits(s, *shape) - 1


def _probs(s, *shape):
    return _rng(s).uniform(0.05, 0.95, shape).astype("f4")


def _log_probs(s):
    x = _normal(s, B, 5)
    return (x - onp.log(onp.exp(x).sum(-1, keepdims=True))).astype("f4")


def _ctc_labels(s, n, lo=1, hi=4):
    """``n`` rows of ``hi`` classes in 1..4, each row 0-padded after
    ``lo``..``hi`` labels."""
    r = _rng(s)
    lab = r.randint(1, 5, (n, hi)).astype("i4")
    lens = r.randint(lo, hi + 1, n).astype("i4")
    lab[onp.arange(hi)[None, :] >= lens[:, None]] = 0
    return lab, lens


CTC_T, CTC_C = 8, 5

CASES.update({
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {},
                    lambda s: Call(_normal(s, B, 4), _bits(s + 1, B, 4))),
    "sigmoid_bce_pos_weight": (
        "SigmoidBCELoss", {},
        lambda s: Call(_normal(s, B, 4), _bits(s + 1, B, 4),
                       pos_weight=_rng(s + 2).uniform(0.5, 3, 4)
                       .astype("f4"))),
    "sigmoid_bce_from_sigmoid": (
        "SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
        lambda s: Call(_probs(s, B, 4), _bits(s + 1, B, 4),
                       _rng(s + 2).uniform(0, 2, (B, 1)).astype("f4"))),
    "sigmoid_bce_from_sigmoid_pos_weight": (
        "SigmoidBCELoss", {"from_sigmoid": True, "weight": 0.5},
        lambda s: Call(_probs(s, B, 4), _bits(s + 1, B, 4),
                       pos_weight=_rng(s + 2).uniform(0.5, 3, 4)
                       .astype("f4"))),
    "kldiv": ("KLDivLoss", {},
              lambda s: Call(_log_probs(s), onp.exp(_log_probs(s + 1)))),
    "kldiv_logits_axis0": (
        "KLDivLoss", {"from_logits": False, "axis": 0},
        lambda s: Call(_normal(s, B, 5),
                       _probs(s + 1, B, 5) / _probs(s + 1, B, 5).sum(0))),
    "ctc_ntc_padding": (
        "CTCLoss", {},
        lambda s: Call(_normal(s, B, CTC_T, CTC_C), _ctc_labels(s, B)[0])),
    "ctc_tnc_lengths": (
        "CTCLoss", {"layout": "TNC", "label_layout": "TN", "weight": 2.0},
        lambda s: Call(_normal(s, CTC_T, B, CTC_C),
                       _ctc_labels(s, B)[0].T.copy(),
                       _rng(s + 1).randint(5, CTC_T + 1, B).astype("i4"),
                       _ctc_labels(s, B)[1])),
    "huber": ("HuberLoss", {"rho": 0.5},
              lambda s: Call(_normal(s, B, 4), _normal(s + 1, B, 4))),
    "hinge": ("HingeLoss", {"margin": 0.5},
              lambda s: Call(_normal(s, B, 3), _signs(s + 1, B, 3))),
    "squared_hinge": ("SquaredHingeLoss", {},
                      lambda s: Call(_normal(s, B, 3), _signs(s + 1, B, 3))),
    "logistic_signed": ("LogisticLoss", {},
                        lambda s: Call(_normal(s, B, 3),
                                       _signs(s + 1, B, 3))),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        lambda s: Call(_normal(s, B, 3),
                                       _bits(s + 1, B, 3))),
    "triplet": ("TripletLoss", {"margin": 0.5},
                lambda s: Call(_normal(s, B, 2, 2), _normal(s + 1, B, 4),
                               _normal(s + 2, B, 2, 2))),
    "poisson_nll": ("PoissonNLLLoss", {},
                    lambda s: Call(_normal(s, B, 3) * 0.5,
                                   _rng(s + 1).poisson(1.5, (B, 3))
                                   .astype("f4"))),
    "poisson_nll_rates_full": (
        "PoissonNLLLoss", {"from_logits": False, "compute_full": True},
        lambda s: Call(_rng(s).uniform(0.2, 3, (B, 3)).astype("f4"),
                       _rng(s + 1).poisson(2.0, (B, 3)).astype("f4"))),
    "cosine_embedding": (
        "CosineEmbeddingLoss", {"margin": 0.2},
        lambda s: Call(_normal(s, B, 4), _normal(s + 1, B, 4),
                       _signs(s + 2, B))),
    "sdml": ("SDMLLoss", {},
             lambda s: Call(_normal(s, B, 4),
                            _normal(s, B, 4) + 0.1 * _normal(s + 1, B, 4))),
})


def _call(built):
    """A case's arguments: a (pred, label, sample_weight) triple or a
    ``Call``."""
    if isinstance(built, Call):
        return list(built.args), built.kw
    pred, label, sw = built
    return [pred, label] + ([sw] if sw is not None else []), {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(case, dtype):
    cls, kw, build = CASES[case]
    args, call_kw = _call(build(len(case)))
    j = getattr(jgluon.loss, cls)(**kw)
    t = getattr(tloss, cls)(**kw)
    jargs = [jmx.np.array(args[0]).astype(dtype)] + \
        [jmx.np.array(a) for a in args[1:]]
    targs = [torch.from_numpy(args[0]).to(getattr(torch, dtype))] + \
        [torch.from_numpy(a) for a in args[1:]]
    ref = onp.asarray(j(*jargs, **{k: jmx.np.array(v) for k, v in
                                   call_kw.items()}).asnumpy(), "f4")
    got = t(*targs, **{k: torch.from_numpy(v) for k, v in call_kw.items()})
    assert got.shape == ref.shape == (B,)
    rtol, atol = F32_TOL.get(case, TOL[dtype]) if dtype == "float32" \
        else TOL[dtype]
    onp.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                atol=atol)


def test_alias_and_repr():
    assert tloss.SoftmaxCELoss is tloss.SoftmaxCrossEntropyLoss
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss
    assert set(tloss.__all__) == {
        n for n in dir(jgluon.loss) if isinstance(getattr(jgluon.loss, n),
                                                  type)
        and issubclass(getattr(jgluon.loss, n), jgluon.loss.Loss)}
    assert repr(tloss.L1Loss(weight=2.0)) == repr(jgluon.loss.L1Loss(
        weight=2.0))


def test_loss_is_differentiable():
    pred = torch.randn(B, C, requires_grad=True)
    label = torch.randint(0, C, (B,))
    tloss.SoftmaxCrossEntropyLoss()(pred, label).sum().backward()
    want = torch.softmax(pred.detach(), -1)
    want[torch.arange(B), label] -= 1
    assert torch.allclose(pred.grad, want, atol=1e-6)


def test_ctc_infeasible_alignment():
    """A label longer than its frames (row 0: 4 labels in 2 frames):
    ``inf`` in the port (ATen), a large finite value in the reference
    (optax); the feasible rows beside it agree. The shapes are the
    ``ctc_tnc_lengths`` case's."""
    pred = _normal(3, CTC_T, B, CTC_C)
    label, _ = _ctc_labels(3, B, lo=4)
    plen = onp.full(B, CTC_T, "i4")
    plen[0] = 2
    lens = onp.full(B, 4, "i4")
    kw = {"layout": "TNC", "label_layout": "TN"}
    ref = jgluon.loss.CTCLoss(**kw)(
        jmx.np.array(pred), jmx.np.array(label.T.copy()),
        jmx.np.array(plen), jmx.np.array(lens)).asnumpy()
    got = tloss.CTCLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label.T.copy()),
        torch.from_numpy(plen), torch.from_numpy(lens)).numpy()
    assert got[0] == onp.inf and onp.isfinite(ref[0]) and ref[0] > 1e3
    onp.testing.assert_allclose(got[1:], ref[1:], rtol=1e-5)
