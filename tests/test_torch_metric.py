"""The port's ``gluon.metric`` against the JAX package's, on the CPU.

Every registered metric (``create`` by each registered name and alias,
the same constructor arguments) takes the same two batches of seeded
numpy inputs in both packages, as the port's NDArrays in one run and
torch tensors in another (the JAX package's as its NDArrays), and its
``get()`` must agree; so must ``CompositeEvalMetric``, ``CustomMetric``
through ``np()``, ``update_dict``, ``get_config``,
``check_label_shapes``, ``predict_with_threshold`` and ``one_hot``, and
the registry's names.

Tolerance: 1e-12 relative, 0 absolute: both packages copy the inputs
to numpy and accumulate in the same float64 Python arithmetic, so any
difference beyond float64 rounding is a fault.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import metric as jmetric
from mxnet_tpu_torch.gluon import metric as tmetric

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-12, atol=0)
N, C = 8, 4


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rs(seed):
    return onp.random.RandomState(seed)


def _probs(seed, n=N, c=C):
    x = _rs(seed).uniform(0.05, 1.0, (n, c))
    return (x / x.sum(-1, keepdims=True)).astype("f4")


def _labels(seed, n=N, c=C):
    return _rs(seed).randint(0, c, n).astype("f4")


def _reg(seed, *shape):
    return _rs(seed).standard_normal(shape).astype("f4")


def _batches(kind, seed):
    """(labels, preds) of one batch of the kind a metric reads."""
    if kind == "class":
        return _labels(seed), _probs(seed + 1)
    if kind == "binary":
        return _rs(seed).randint(0, 2, N).astype("f4"), \
            _rs(seed + 1).uniform(0, 1, N).astype("f4")
    if kind == "binary2":
        return _rs(seed).randint(0, 2, N).astype("f4"), _probs(seed + 1, c=2)
    if kind == "reg":
        return _reg(seed, N, 3), _reg(seed + 1, N, 3)
    if kind == "seq":
        return _labels(seed, 2 * N).reshape(2, N), \
            _probs(seed + 1, 2 * N).reshape(2, N, C)
    if kind == "loss":
        return None, _rs(seed).uniform(0, 2, N).astype("f4")
    raise ValueError(kind)


#: registered name -> (constructor kwargs, input kind)
METRICS = {
    "accuracy": ({}, "class"), "acc": ({"axis": 1}, "class"),
    "topkaccuracy": ({"top_k": 2}, "class"),
    "top_k_accuracy": ({"top_k": 3}, "class"),
    "top_k_acc": ({"top_k": 2}, "class"),
    "f1": ({}, "binary"), "mcc": ({}, "binary2"),
    "fbeta": ({"beta": 2.0}, "binary"),
    "mae": ({}, "reg"), "mse": ({}, "reg"), "rmse": ({}, "reg"),
    "crossentropy": ({}, "class"), "ce": ({"eps": 1e-6}, "class"),
    "negativeloglikelihood": ({}, "class"), "nll_loss": ({}, "class"),
    "perplexity": ({"ignore_label": 2}, "seq"),
    "pearsoncorrelation": ({}, "reg"), "pearsonr": ({}, "reg"),
    "binaryaccuracy": ({"threshold": 0.4}, "binary"),
    "meanpairwisedistance": ({"p": 1}, "reg"),
    "meancosinesimilarity": ({}, "reg"), "pcc": ({}, "class"),
    "loss": ({}, "loss"), "torch": ({}, "loss"),
}


def _feed(pkg, metric, kind, as_tensor):
    for seed in (1, 5):
        labels, preds = _batches(kind, seed)
        if pkg is jmx:
            conv = jmx.np.array
        elif as_tensor:
            conv = torch.from_numpy
        else:
            conv = tmx.np.array
        lab = conv(labels) if labels is not None else None
        metric.update([lab], [conv(preds)])
    return metric.get()


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_reference(name):
    kw, kind = METRICS[name]
    ref = _feed(jmx, jmetric.create(name, **kw), kind, False)
    for as_tensor in (False, True):
        m = tmetric.create(name, **kw)
        got = _feed(tmx, m, kind, as_tensor)
        assert got[0] == ref[0]
        onp.testing.assert_allclose(got[1], ref[1], **TOL)
        assert type(m).__name__ == type(jmetric.create(name, **kw)).__name__
        m.reset()
        assert math.isnan(m.get()[1])


def test_registry_names_match_reference():
    assert set(tmetric._REGISTRY) == set(jmetric._REGISTRY)
    assert set(METRICS) | {"compositeevalmetric", "composite",
                           "custommetric"} == set(jmetric._REGISTRY)
    for name in jmetric._REGISTRY:
        assert tmetric._REGISTRY[name].__name__ == \
            jmetric._REGISTRY[name].__name__


def test_composite_custom_and_config():
    def feval(label, pred):
        return float(onp.abs(label - pred.argmax(-1)).sum())

    res = {}
    for pkg, mod in ((jmx, jmetric), (tmx, tmetric)):
        comp = mod.create(["acc", mod.np(feval, name="dist"),
                           mod.create("top_k_acc", top_k=2)])
        comp.add(mod.CustomMetric(lambda l, p: (2, float(p.sum())),
                                  name="pair"))
        labels, preds = _batches("class", 3)
        comp.update(pkg.np.array(labels), pkg.np.array(preds))
        one = mod.Accuracy(output_names=["out"], label_names=["lab"])
        one.update_dict({"lab": pkg.np.array(labels)},
                        {"out": pkg.np.array(preds)})
        res[pkg] = (comp.get(), comp.get_metric(1).get_config(),
                    one.get(), one.get_config(),
                    comp.get_name_value(), str(comp))
    assert res[tmx] == res[jmx]
    # a single metric's str() (the reference's raises TypeError)
    one = tmetric.Accuracy()
    one.update([tmx.np.array(_labels(1))], [tmx.np.array(_probs(2))])
    assert str(one) == f"EvalMetric: {{'accuracy': {one.get()[1]}}}"


def test_helpers_match_reference():
    labels, preds = _batches("reg", 4)
    for mod, arr in ((jmetric, jmx.np.array), (tmetric, tmx.np.array)):
        with pytest.raises(ValueError, match="does not match"):
            mod.check_label_shapes([1, 2], [1])
        with pytest.raises(ValueError, match="does not match"):
            mod.check_label_shapes(arr(labels), arr(preds[:4]), shape=True)
        lab, pr = mod.check_label_shapes(arr(labels), arr(preds), wrap=True,
                                         shape=True)
        assert isinstance(lab, list) and isinstance(pr, list)
    lab, pr = tmetric.check_label_shapes(
        torch.from_numpy(labels), torch.from_numpy(preds), wrap=True)
    assert isinstance(lab, list) and torch.is_tensor(pr[0])
    probs = _probs(6)
    onp.testing.assert_array_equal(
        tmetric.predict_with_threshold(probs, 0.3),
        jmetric.predict_with_threshold(probs, 0.3))
    thr = onp.full((C,), 0.25, "f4")
    onp.testing.assert_array_equal(
        tmetric.predict_with_threshold(probs, thr),
        jmetric.predict_with_threshold(probs, thr))
    idx = onp.array([0, 3, 1], "i4")
    onp.testing.assert_array_equal(
        tmetric.one_hot(tmx.np.array(idx), C),
        jmetric.one_hot(jmx.np.array(idx), C))
    onp.testing.assert_array_equal(
        tmetric.one_hot(torch.from_numpy(idx), C),
        jmetric.one_hot(idx, C))
