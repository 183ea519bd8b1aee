"""Losses of the port: the per-sample losses the training step needs.

Counterpart of ``mxnet_tpu/gluon/loss.py:11-118``: ``Loss`` with its
``weight`` and ``batch_axis``, ``_apply_weighting``, ``_reshape_like``,
``L2Loss``, ``L1Loss`` and ``SoftmaxCrossEntropyLoss`` (alias
``SoftmaxCELoss``: ``sparse_label``, ``from_logits``, ``axis``). Each
takes torch tensors or NDArrays (see ``block.py``) and returns one loss
per sample (the mean over every axis but ``batch_axis``), as plain
PyTorch, as the reference's are plain jnp. The other losses wait for
ROADMAP.md queue 1, item 15b.
"""
from __future__ import annotations

import torch

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


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
        return loss.mean(dim=axes) if axes else loss


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
