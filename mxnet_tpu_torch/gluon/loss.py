"""The losses of Gluon (the port of ``mxnet_tpu/gluon/loss.py``).

``Loss`` with its ``weight`` and ``batch_axis``, ``_apply_weighting``,
``_reshape_like`` and the reference's fifteen classes: ``L2Loss``,
``L1Loss``, ``SigmoidBinaryCrossEntropyLoss`` (alias ``SigmoidBCELoss``:
``from_sigmoid``, ``pos_weight``), ``SoftmaxCrossEntropyLoss`` (alias
``SoftmaxCELoss``: ``sparse_label``, ``from_logits``, ``axis``),
``KLDivLoss``, ``CTCLoss``, ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``PoissonNLLLoss``, ``CosineEmbeddingLoss`` and ``SDMLLoss``. Each takes
torch tensors or NDArrays (see ``block.py``) and returns one loss per
sample (the mean over every axis but ``batch_axis``; ``CTCLoss`` and
``TripletLoss`` one value a sequence or triplet), as plain PyTorch, as
the reference's are plain jnp. Under ``amp.init()`` the reference's
named ops keep their casts here (``log_softmax`` and the per-sample
``mean`` in fp32).

``CTCLoss`` is ATen's ``ctc_loss`` (the reference's is
``optax.ctc_loss``), with the reference's conventions: blank 0; without
``label_lengths`` a 0 label is padding; ``pred_lengths`` masks the
frames past each length; ``NTC``/``TNC`` and ``NT``/``TN`` layouts. A
label that cannot be aligned in its frames (longer than its input)
costs ``inf`` here and a large finite value in the reference (ROADMAP.md
queue 3, "not queued").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..amp import cast_args as _amp
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    if pred.shape != label.shape:
        label = label.reshape(pred.shape)
    return label


class Loss(HybridBlock):
    _tensor_forward = True

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def _mean_per_sample(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        if not axes:
            return loss
        (loss,) = _amp("mean", loss)
        return loss.mean(dim=axes)


class L2Loss(Loss):
    """``weight / 2 * (label - pred) ** 2`` per sample."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_per_sample(loss)


class L1Loss(Loss):
    """``|label - pred|`` per sample."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


def _softrelu(x):
    """``log(1 + exp(x))`` (``npx.activation``'s ``softrelu``)."""
    return F.softplus(x)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (or, ``from_sigmoid``, of
    probabilities), ``pos_weight`` scaling the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-torch.abs(pred)) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log_softmax(pred)[label]`` (``sparse_label``, the label an
    index along ``axis``, clipped into range as ``npx.pick`` clips it) or
    ``-sum(log_softmax(pred) * label)`` (a dense label); with
    ``from_logits`` the prediction is already log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            (pred,) = _amp("log_softmax", pred)
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            ax = self._axis % pred.dim()
            idx = label.to(torch.int64).clamp(0, pred.shape[ax] - 1)
            loss = -torch.take_along_dim(pred, idx.unsqueeze(ax),
                                         dim=ax).squeeze(ax)
        else:
            label = _reshape_like(pred, label)
            loss = -torch.sum(pred * label, dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities
    (``from_logits``) or logits given a log-softmax along ``axis``."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            (pred,) = _amp("log_softmax", pred)
            pred = torch.log_softmax(pred, dim=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class CTCLoss(Loss):
    """Connectionist temporal classification loss, one value a
    sequence (see the module docstring)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        assert layout in ("NTC", "TNC")
        assert label_layout in ("NT", "TN")
        super().__init__(weight, 0 if label_layout == "NT" else 1)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)          # ATen takes (T, N, C)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        t, n = pred.shape[0], pred.shape[1]
        label = label.to(torch.int64)
        in_len = torch.full((n,), t, dtype=torch.int64, device=pred.device) \
            if pred_lengths is None else pred_lengths.to(torch.int64)
        lbl_len = (label != 0).sum(1) if label_lengths is None \
            else label_lengths.to(torch.int64)
        logp = torch.log_softmax(pred.float(), dim=-1)
        loss = F.ctc_loss(logp, label, in_len, lbl_len, blank=0,
                          reduction="none").to(pred.dtype)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """Smooth L1: quadratic within ``rho`` of the label, linear
    beyond."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label) ** 2``."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(torch.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))``; ``label_format`` ``"signed"``
    ({-1, 1}) or ``"binary"`` ({0, 1})."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._label_format = label_format
        if label_format not in ("signed", "binary"):
            raise ValueError(f"unexpected label_format {label_format}")

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + \
            _softrelu(-torch.abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)`` a sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = torch.sum(torch.square(positive - pred)
                         - torch.square(negative - pred),
                         dim=tuple(range(1, pred.dim())))
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of a rate (``from_logits``: its
    log), with Stirling's term when ``compute_full``."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = _reshape_like(pred, label)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = label * torch.log(label + 1e-12) - label + \
                0.5 * torch.log(2 * math.pi * (label + 1e-12))
            stirling = torch.where(label <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for similar pairs (label 1), else ``cos - margin``
    clipped into [0, 1 - margin]; ``cos`` kept (N, 1)."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(input2, input1)
        cos = (torch.sum(input1 * input2, dim=-1) / (
            torch.sqrt(torch.sum(torch.square(input1), dim=-1))
            * torch.sqrt(torch.sum(torch.square(input2), dim=-1)) + 1e-12)
        ).reshape(-1, 1)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.clamp(cos - self._margin, 0.0,
                                       1.0 - self._margin))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_per_sample(loss)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss: the KL divergence between a
    smoothed identity and the softmax of the negative pairwise L2
    distances of two batches."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        d = torch.sum(torch.square(x1.unsqueeze(1) - x2.unsqueeze(0)),
                      dim=-1)
        logits = -torch.sqrt(d + 1e-12)
        eye = torch.eye(batch_size, dtype=torch.float32, device=x1.device)
        labels = eye * (1 - self.smoothing_parameter) + (1 - eye) * (
            self.smoothing_parameter / (batch_size - 1))
        log_prob = torch.log_softmax(logits, dim=-1)
        return self.kl_loss(log_prob, labels)
