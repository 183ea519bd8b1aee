"""Evaluation metrics (the port of ``mxnet_tpu/gluon/metric.py``: the
registered classes and their aliases, ``register``/``alias``/``create``,
``CustomMetric``, ``np()``, ``check_label_shapes`` and ``get_config``).

As in the reference (``_to_np``), a metric reads its inputs on the host:
each ``update`` copies every label and prediction to numpy once, from a
port ``NDArray`` or a torch tensor on either device, and accumulates in
Python floats, so the card and the CPU give the same ``get()`` on the
same values.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..ndarray.ndarray import NDArray
from ..utils_io import _host as _to_np

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*names):
    """Register creation-name aliases (parity: the reference's
    @alias decorator, gluon/metric.py:190 — 'acc', 'ce', ...)."""
    def reg(klass):
        for n in names:
            _REGISTRY[n.lower()] = klass
        return klass
    return reg


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REGISTRY[metric.lower()](*args, **kwargs)


#: what counts as one array (not a list of them)
_ARRAY = (NDArray, onp.ndarray, torch.Tensor)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        # the reference's zip(*self.get()) raises for a single metric
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
@alias('composite')
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            values.append(value)
        return names, values


def _flat_pairs(labels, preds):
    if isinstance(labels, _ARRAY):
        labels = [labels]
    if isinstance(preds, _ARRAY):
        preds = [preds]
    assert len(labels) == len(preds), \
        f"Labels and predictions differ in length: {len(labels)} vs {len(preds)}"
    return labels, preds


@register
@alias('acc')
class Accuracy(EvalMetric):
    def __init__(self, axis=-1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            if pred.shape != label.shape:
                # class-probability predictions (reference compares shapes,
                # so (N,1) labels vs (N,C) preds work)
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int32).reshape(-1)
            label = label.astype(onp.int32).reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
@alias('top_k_accuracy', 'top_k_acc')
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k
        assert top_k > 1, "Use Accuracy if top_k is no more than 1"

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            assert pred.ndim == 2
            topk = onp.argpartition(pred, -self.top_k, axis=-1)[:, -self.top_k:]
            label = label.astype(onp.int32).reshape(-1, 1)
            self.sum_metric += float((topk == label).any(axis=1).sum())
            self.num_inst += label.shape[0]


class _BinaryClassificationStats:
    def __init__(self):
        self.reset()

    def reset(self):
        self.tp = self.fp = self.tn = self.fn = 0.0

    def update(self, label, pred):
        label = _to_np(label).reshape(-1).astype(onp.int32)
        pred = _to_np(pred)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            pred = pred.argmax(axis=-1).reshape(-1)
        else:
            pred = (pred.reshape(-1) > 0.5).astype(onp.int32)
        self.tp += float(((pred == 1) & (label == 1)).sum())
        self.fp += float(((pred == 1) & (label == 0)).sum())
        self.tn += float(((pred == 0) & (label == 0)).sum())
        self.fn += float(((pred == 0) & (label == 1)).sum())

    @property
    def precision(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    @property
    def mcc(self):
        denom = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                          (self.tn + self.fp) * (self.tn + self.fn))
        if denom == 0:
            return 0.0
        return (self.tp * self.tn - self.fp * self.fn) / denom

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.stats = _BinaryClassificationStats()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            self.stats.update(label, pred)

    def get(self):
        if self.stats.total == 0:
            return (self.name, float("nan"))
        return (self.name, self.stats.f1)

    def reset(self):
        if hasattr(self, "stats"):
            self.stats.reset()
        super().reset()


@register
class MCC(F1):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average)

    def get(self):
        if self.stats.total == 0:
            return (self.name, float("nan"))
        return (self.name, self.stats.mcc)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(onp.abs(label.reshape(pred.shape) -
                                             pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(
                onp.square(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
@alias('ce')
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(onp.int64)
            pred = _to_np(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += float((-onp.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
@alias('nll_loss')
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, eps=1e-12,
                 name="perplexity", output_names=None, label_names=None):
        super().__init__(eps, name, output_names, label_names)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(onp.int64)
            pred = _to_np(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = prob[~ignore]
            self.sum_metric += float((-onp.log(prob + self.eps)).sum())
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
@alias('pearsonr')
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        self._labels = []
        self._preds = []
        super().reset()

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            self._labels.append(_to_np(label).ravel())
            self._preds.append(_to_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        x = onp.concatenate(self._labels)
        y = onp.concatenate(self._preds)
        return (self.name, float(onp.corrcoef(x, y)[0, 1]))


@register
class Fbeta(F1):
    """F-beta: weighted harmonic mean of precision/recall (parity:
    gluon/metric.py Fbeta)."""

    def __init__(self, name="fbeta", output_names=None, label_names=None,
                 average="macro", beta=1.0):
        self.beta = float(beta)
        super().__init__(name, output_names, label_names, average)
        self._kwargs["beta"] = self.beta

    def get(self):
        if self.stats.total == 0:
            return (self.name, float("nan"))
        prec, rec = self.stats.precision, self.stats.recall
        b2 = self.beta * self.beta
        denom = b2 * prec + rec
        val = (1 + b2) * prec * rec / denom if denom else 0.0
        return (self.name, val)


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy of a thresholded binary prediction (parity:
    gluon/metric.py BinaryAccuracy)."""

    def __init__(self, name="binary_accuracy", output_names=None,
                 label_names=None, threshold=0.5):
        self.threshold = threshold
        super().__init__(name, output_names, label_names,
                         threshold=threshold)

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel()
            pred = (_to_np(pred).ravel() > self.threshold)
            self.sum_metric += float((pred == (label > 0.5)).sum())
            self.num_inst += label.size


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between prediction and label rows (parity:
    gluon/metric.py MeanPairwiseDistance)."""

    def __init__(self, name="mpd", output_names=None, label_names=None,
                 p=2):
        self.p = p
        super().__init__(name, output_names, label_names, p=p)

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            d = onp.linalg.norm(
                (pred - label.reshape(pred.shape)).reshape(
                    pred.shape[0], -1), ord=self.p, axis=1)
            self.sum_metric += float(d.sum())
            self.num_inst += pred.shape[0]


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (parity:
    gluon/metric.py MeanCosineSimilarity)."""

    def __init__(self, name="cos_sim", output_names=None,
                 label_names=None, eps=1e-12):
        self.eps = eps
        super().__init__(name, output_names, label_names, eps=eps)

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_np(pred)
            label = _to_np(label).reshape(pred.shape)
            num = (label * pred).sum(-1)
            den = onp.maximum(onp.linalg.norm(label, axis=-1) *
                              onp.linalg.norm(pred, axis=-1), self.eps)
            sim = num / den
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation via the k x k confusion matrix
    (parity: gluon/metric.py PCC — reduces to MCC for k=2)."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        self._cm = onp.zeros((0, 0), dtype=onp.float64)
        super().reset()

    def _grow(self, k):
        if k > self._cm.shape[0]:
            cm = onp.zeros((k, k), dtype=onp.float64)
            old = self._cm.shape[0]
            cm[:old, :old] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).ravel().astype(onp.int64)
            pred = _to_np(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(-1)
            pred = pred.ravel().astype(onp.int64)
            k = int(max(label.max(), pred.max())) + 1
            self._grow(k)
            onp.add.at(self._cm, (label, pred), 1)
            self.num_inst += label.size

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        c = self._cm
        n = c.sum()
        t = c.sum(axis=1)  # true counts
        p = c.sum(axis=0)  # predicted counts
        cov_tp = (onp.trace(c) * n - (t * p).sum())
        cov_tt = (n * n - (t * t).sum())
        cov_pp = (n * n - (p * p).sum())
        denom = onp.sqrt(cov_tt * cov_pp)
        return (self.name, float(cov_tp / denom) if denom else 0.0)


@register
class Loss(EvalMetric):
    """Running average of a loss output."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, _ARRAY):
            preds = [preds]
        for pred in preds:
            pred = _to_np(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size


@register
class Torch(Loss):
    """Legacy alias kept for parity (gluon/metric.py Torch)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _flat_pairs(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                num, value = reval
                self.sum_metric += value
                self.num_inst += num
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np_metric(**kwargs):
    def decorator(feval):
        return CustomMetric(feval, name=feval.__name__, **kwargs)
    return decorator


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Validate labels/preds agreement (parity: gluon/metric.py:33):
    length check by default, full shape check with shape=True; wrap
    single arrays into lists with wrap=True."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not "
                         f"match shape of predictions {pred_shape}")
    if wrap:
        if isinstance(labels, (NDArray, torch.Tensor)):
            labels = [labels]
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
    return labels, preds


def predict_with_threshold(pred, threshold=0.5):
    """Threshold binary/multilabel predictions (parity:
    gluon/metric.py:524)."""
    if isinstance(threshold, float):
        return pred > threshold
    if isinstance(threshold, _ARRAY):
        num_classes = pred.shape[-1]
        assert threshold.shape[-1] == num_classes, \
            f"shape mismatch: {pred.shape[-1]} vs. {threshold.shape[-1]}"
        return pred > threshold
    raise ValueError(f"{type(threshold)} is a wrong type for threshold!")


def one_hot(idx, num):
    """(parity: gluon/metric.py:546)"""
    idx = _to_np(idx)
    return (onp.arange(num) == idx[:, None]).astype("int32")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy feval (parity:
    gluon/metric.py:1835 — deprecated but load-bearing alias)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name or feval.__name__,
                        allow_extra_outputs)
