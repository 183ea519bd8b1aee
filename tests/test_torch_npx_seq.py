"""The port's sequence ops, legacy heads and control flow of ``mx.npx``
against the JAX package's, on the CPU: ``sequence_mask``/``_last``/
``_reverse``; ``softmax_output``, ``make_loss`` and the
regression outputs, whose gradients are the reference's ``custom_vjp``
rules; ``upsampling`` (nearest, bilinear); ``multibox_prior``;
``roi_pooling``; ``foreach``/``while_loop``/``cond`` with the gradient
through ``foreach``.

Tolerances (``test_torch_np_common.py``): dtype and shape exactly;
integers exactly; the rest, gradients included, at 1e-5 (``RED``)."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import RED, check, grads, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


SEQ = onp.array([4, 2, 5], "i4")


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_ops(axis):
    x = values("float32", shape=(5, 3, 2) if axis == 0 else (3, 5, 2),
               seed=30)
    for name, kw in [("npx.sequence_mask", {"value": -1.0}),
                     ("npx.sequence_last", {}),
                     ("npx.sequence_reverse", {})]:
        if name == "npx.sequence_reverse" and axis == 1:
            continue        # the reference reverses along axis 0 only
        check(name, (x, SEQ), dict(kw, use_sequence_length=True,
                                   axis=axis), tol=RED, nojit=True)
        check(name, (x,), dict(kw, axis=axis), tol=RED, nojit=True)
    if axis == 0:
        t, j = grads("npx.sequence_reverse", (x, SEQ),
                     {"use_sequence_length": True})
        same(t, j, RED)


def test_sequence_mask_integer_data():
    x = values("int32", shape=(5, 3), seed=31)
    check("npx.sequence_mask", (x, SEQ), {"use_sequence_length": True},
          nojit=True)
    check("npx.sequence_mask", (x, SEQ),
          {"use_sequence_length": True, "value": 0.5}, nojit=True)


SOFTMAX_OUTPUT = [
    ((4, 5), (4,), {}),
    ((4, 5), (4,), {"grad_scale": 2.0, "normalization": "batch"}),
    ((4, 5), (4,), {"use_ignore": True, "ignore_label": 2,
                    "normalization": "valid"}),
    ((4, 5), (4,), {"smooth_alpha": 0.1}),
    ((2, 3, 4), (2, 4), {"multi_output": True}),
    ((2, 3, 4), (2, 3), {"preserve_shape": True}),
    ((2, 3, 4), (2,), {}),
]


@pytest.mark.parametrize("xs,ls,kw", SOFTMAX_OUTPUT, ids=repr)
def test_softmax_output(xs, ls, kw):
    x = values("float32", shape=xs, seed=50)
    n_class = xs[1] if kw.get("multi_output") else (
        xs[-1] if kw.get("preserve_shape") or len(xs) <= 2
        else int(onp.prod(xs[1:])))
    lab = (values("uint8", shape=ls, seed=51) % n_class).astype("float32")
    t, j = grads("npx.softmax_output", (x, lab), kw)
    same(t, j, RED)


@pytest.mark.parametrize("kw", [{}, {"grad_scale": 3.0,
                                     "normalization": "batch"},
                                {"normalization": "valid",
                                 "valid_thresh": 0.2}], ids=repr)
def test_make_loss(kw):
    x = values("float32", shape=(4, 3), seed=52)
    t, j = grads("npx.make_loss", (x,), kw)
    same(t, j, RED)


@pytest.mark.parametrize("name", ["linear_regression_output",
                                  "mae_regression_output",
                                  "logistic_regression_output"])
def test_regression_outputs(name):
    x = values("float32", shape=(4, 3), seed=53)
    lab = values("float32", shape=(4, 3), lo=0.0, hi=1.0, seed=54)
    t, j = grads("npx." + name, (x, lab), {"grad_scale": 2.0})
    same(t, j, RED)
    # (N, 1) predictions against (N,) labels
    t, j = grads("npx." + name, (x[:, :1], lab[:, 0]), {})
    same(t, j, RED)


def test_upsampling():
    x = values("float32", shape=(1, 2, 3, 3), seed=55)
    y = values("float32", shape=(1, 2, 6, 6), seed=56)
    check("npx.upsampling", (x,), {"scale": 2}, tol=RED, nojit=True)
    check("npx.upsampling", (x, y), {"scale": 2}, tol=RED, nojit=True)
    check("npx.upsampling", (x, y), {"scale": 2, "multi_input_mode": "sum"},
          tol=RED, nojit=True)
    w = values("float32", shape=(2, 1, 4, 4), seed=57)
    check("npx.upsampling", (x, w), {"scale": 2, "sample_type": "bilinear",
                                     "num_filter": 2}, tol=RED, nojit=True)


def test_multibox_prior_and_roi_pooling():
    x = values("float32", shape=(1, 2, 4, 5), seed=58)
    check("npx.multibox_prior", (x,), {"sizes": (0.5, 0.25),
                                       "ratios": (1.0, 2.0, 0.5)},
          tol=RED, nojit=True)
    check("npx.multibox_prior", (x,), {"sizes": (0.9,), "clip": True,
                                       "steps": (0.2, 0.3),
                                       "offsets": (0.4, 0.6)},
          tol=RED, nojit=True)
    feat = values("float32", shape=(2, 3, 8, 8), seed=59)
    rois = onp.array([[0, 0, 0, 7, 7], [1, 2, 1, 5, 6], [0, 3, 3, 3, 4],
                      [1, 4.4, 0.6, 14, 9]], "f4")
    t, j = grads("npx.roi_pooling", (feat, rois),
                 {"pooled_size": (2, 3), "spatial_scale": 0.5}, nojit=False)
    same(t, j, RED)


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------
def _foreach_run(pkg, x, h0, w):
    def body(xt, states):
        h = pkg.np.tanh(pkg.np.dot(xt, w) + states[0])
        return h * 2.0, [h]
    return pkg.npx.foreach(body, x, [h0])


def test_foreach_values_and_gradient():
    x = values("float32", shape=(4, 2, 3), seed=60)
    h0 = values("float32", shape=(2, 3), seed=61)
    w = values("float32", shape=(3, 3), seed=62)
    res = []
    for pkg in (tmx, jmx):
        xs, hs, ws = (pkg.np.array(a) for a in (x, h0, w))
        for a in (xs, hs, ws):
            a.attach_grad()
        with pkg.autograd.record():
            outs, final = _foreach_run(pkg, xs, hs, ws)
            s = outs.sum() + (final[0] * final[0]).sum()
        s.backward()
        res.append([outs, final[0], xs.grad, hs.grad, ws.grad])
    same(res[0], res[1], RED)


def test_foreach_single_state_and_data_list():
    x = values("float32", shape=(3, 2), seed=63)
    res = []
    for pkg in (tmx, jmx):
        a, b = pkg.np.array(x), pkg.np.array(x * 2)
        outs, st = pkg.npx.foreach(
            lambda d, s: ([d[0] + s, d[1] * s], d[0] + s), [a, b],
            pkg.np.zeros((2,)))
        res.append([outs[0], outs[1], st])
    same(res[0], res[1], RED)


def test_while_loop_and_cond():
    res = []
    for pkg in (tmx, jmx):
        i0 = pkg.np.array(onp.array(0, "i4"))
        x = pkg.np.array(onp.array([1.5, -0.5], "f4"))
        x.attach_grad()
        with pkg.autograd.record():
            none, (i, y) = pkg.npx.while_loop(
                lambda vs: vs[0] < 3, lambda vs: ([], [vs[0] + 1, vs[1] * 2.5]),
                [i0, x], max_iterations=10)
            _, (capped,) = pkg.npx.while_loop(
                lambda vs: vs[0] < 100, lambda vs: ([], [vs[0] + 1]), [i0],
                max_iterations=3)
            c1 = pkg.npx.cond(pkg.np.array(onp.array(True)),
                              lambda a: a * 3.0, lambda a: a * a, [y])
            c2 = pkg.npx.cond(0, lambda a, b: a * b, lambda a, b: a - b,
                              [y, x])
            s = (c1 + c2).sum()
        s.backward()
        assert none == []
        res.append([i, y, capped, c1, c2, x.grad])
    same(res[0], res[1], RED)


def test_while_loop_stacks_step_outputs():
    """Array step outputs stack on axis 0, as MXNet's ``while_loop``
    gives them (the reference's compares them with ``[]`` and raises:
    ROADMAP.md, not queued)."""
    i0 = tmx.np.array(onp.array(0, "i4"))
    acc = tmx.np.array(onp.ones(3, "f4"))
    outs, (i, last) = tmx.npx.while_loop(
        lambda vs: vs[0] < 4, lambda vs: (vs[1] * 2.0, [vs[0] + 1,
                                                        vs[1] * 1.5]),
        [i0, acc])
    want = onp.stack([2.0 * 1.5 ** k * onp.ones(3, "f4") for k in range(4)])
    onp.testing.assert_allclose(outs.asnumpy(), want, **RED)
    assert int(i.item()) == 4
    pair, _ = tmx.npx.while_loop(lambda v: v < 2, lambda v: ([v, v * 2], v + 1),
                                 i0)
    onp.testing.assert_array_equal(pair[1].asnumpy(), [0, 2])
