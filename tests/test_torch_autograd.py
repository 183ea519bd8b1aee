"""The port's autograd (mxnet_tpu_torch.autograd, on torch.autograd)
against the JAX package's tape on the same numpy inputs: the cases of
tests/test_autograd.py that need no hybridize, each run through both
packages and compared (gradients rtol=1e-5, atol=1e-5), plus the
semantics torch does not give by default: grad_req 'write' overwrites,
a head off the tape raises ValueError, a second backward without
retain_graph raises the reference's RuntimeError, ``grad(variables=)``
gives zeros for an unused variable, ``create_graph`` gives grad-of-grad,
and nothing is recorded outside ``record()`` or inside ``pause()``.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GT = dict(rtol=1e-5, atol=1e-5)
PKGS = pytest.mark.parametrize("pkg", [tmx, jmx], ids=["port", "jax"])


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(case):
    """Run ``case(pkg)`` (returning numpy arrays) through both packages
    and compare."""
    t, j = case(tmx), case(jmx)
    t = t if isinstance(t, tuple) else (t,)
    j = j if isinstance(j, tuple) else (j,)
    for a, b in zip(t, j):
        onp.testing.assert_allclose(a, b, **GT)
    return t


def _var(pkg, v, grad_req="write"):
    x = pkg.np.array(onp.asarray(v, "f4"))
    x.attach_grad(grad_req)
    return x


def test_simple_backward():
    def case(pkg):
        x = _var(pkg, [1., 2., 3.])
        with pkg.autograd.record():
            y = (x * x + 2 * x).sum()
        y.backward()
        return x.grad.asnumpy()
    g, = _both(case)
    onp.testing.assert_allclose(g, [4., 6., 8.])


def test_chain_and_fanout():
    def case(pkg):
        x = _var(pkg, [2.])
        with pkg.autograd.record():
            a = x * 3
            b = a * a + a
            c = (b + a).sum()
        c.backward()
        return x.grad.asnumpy()
    g, = _both(case)
    onp.testing.assert_allclose(g, [42.0], rtol=1e-5)


def test_write_overwrites_and_add_accumulates():
    def case(pkg):
        w = _var(pkg, [1., 2.])
        a = _var(pkg, [1., 2.], grad_req="add")
        for _ in range(3):
            with pkg.autograd.record():
                y = (w * w).sum() + (a * a).sum()
            y.backward()
        gw, ga = w.grad.asnumpy(), a.grad.asnumpy()
        a.zero_grad()
        return gw, ga, a.grad.asnumpy()
    gw, ga, gz = _both(case)
    onp.testing.assert_allclose(gw, [2., 4.])
    onp.testing.assert_allclose(ga, [6., 12.])
    onp.testing.assert_allclose(gz, [0., 0.])


def test_head_gradient():
    def case(pkg):
        x = _var(pkg, [1., 2., 3.])
        with pkg.autograd.record():
            y = x * 2
        y.backward(pkg.np.array([1., 10., 100.]))
        return x.grad.asnumpy()
    g, = _both(case)
    onp.testing.assert_allclose(g, [2., 20., 200.])


def test_multiple_heads_with_head_grads():
    def case(pkg):
        x = _var(pkg, [1., -2.])
        with pkg.autograd.record():
            y1 = x * x
            y2 = (x * 3).sum()
        pkg.autograd.backward([y1, y2], head_grads=[pkg.np.array([1., 2.]),
                                                    None])
        return x.grad.asnumpy()
    g, = _both(case)
    onp.testing.assert_allclose(g, [5., -5.])


def test_retain_graph_and_second_backward_error():
    def case(pkg):
        x = _var(pkg, [3.])
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy().copy()
        y.backward()
        g2 = x.grad.asnumpy()
        with pytest.raises(RuntimeError, match="already been freed"):
            y.backward()
        return g1, g2
    g1, g2 = _both(case)
    onp.testing.assert_allclose(g1, [6.])
    onp.testing.assert_allclose(g2, [6.])


@PKGS
def test_head_off_the_tape_raises(pkg):
    x = pkg.np.array([1., 2.])
    with pkg.autograd.record():
        y = (x * 2).sum()
    with pytest.raises(ValueError, match="not on the tape"):
        y.backward()


def test_detach_and_pause():
    def case(pkg):
        x = _var(pkg, [2.])
        with pkg.autograd.record():
            y = x * x
            z = y.detach() * x
            with pkg.autograd.pause():
                w = x * 100
                assert not pkg.autograd.is_recording()
            assert not pkg.autograd._on_tape(w)
            out = z.sum()
        out.backward()
        return x.grad.asnumpy()
    g, = _both(case)
    onp.testing.assert_allclose(g, [4.0])


def test_nothing_recorded_outside_record():
    x = _var(tmx, [1., 2.])
    y = x * x
    assert not tmx.autograd._on_tape(y)
    assert y._data.grad_fn is None
    with tmx.autograd.record():
        i = tmx.np.array([1, 2], dtype="int32") * 2
    assert not i._data.requires_grad


def test_autograd_grad_function():
    def case(pkg):
        x = _var(pkg, [1., 2.])
        u = _var(pkg, [5.])
        with pkg.autograd.record():
            y = (x ** 3).sum()
        gx, gu = pkg.autograd.grad(y, [x, u])
        # .grad buffers untouched by autograd.grad
        return gx.asnumpy(), gu.asnumpy(), x.grad.asnumpy()
    gx, gu, buf = _both(case)
    onp.testing.assert_allclose(gx, [3., 12.], rtol=1e-5)
    onp.testing.assert_allclose(gu, [0.])
    onp.testing.assert_allclose(buf, [0., 0.])


def test_mark_variables():
    def case(pkg):
        x = pkg.np.array([5.])
        g = pkg.np.zeros((1,))
        pkg.autograd.mark_variables([x], [g])
        with pkg.autograd.record():
            y = (x * 4).sum()
        y.backward()
        assert x.grad is g
        return x.grad.asnumpy()
    g, = _both(case)
    onp.testing.assert_allclose(g, [4.])


@PKGS
def test_training_modes(pkg):
    ag = pkg.autograd
    assert not ag.is_training() and not ag.is_recording()
    with ag.record():
        assert ag.is_training() and ag.is_recording()
        with ag.predict_mode():
            assert not ag.is_training() and ag.is_recording()
        with ag.pause(train_mode=True):
            assert ag.is_training() and not ag.is_recording()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    with ag.record(train_mode=False):
        assert not ag.is_training()
    prev = ag.set_recording(True)
    assert ag.is_recording() and prev is False
    ag.set_recording(prev)
    prev = ag.set_training(True)
    assert ag.is_training()
    ag.set_training(prev)
    assert not ag.is_training() and not ag.is_recording()


@PKGS
def test_dropout_respects_mode(pkg):
    x = pkg.np.ones((100,))
    onp.testing.assert_allclose(pkg.npx.dropout(x, p=0.5).asnumpy(),
                                onp.ones(100))
    with pkg.autograd.record(train_mode=True):
        a = pkg.npx.dropout(x, p=0.5).asnumpy()
    assert (a == 0).sum() > 10 and (a > 1.5).sum() > 10
    with pkg.autograd.record(train_mode=False):
        b = pkg.npx.dropout(x, p=0.5).asnumpy()
    onp.testing.assert_allclose(b, onp.ones(100))


def test_dropout_gradient_follows_its_mask():
    x = _var(tmx, onp.ones(200))
    with tmx.autograd.record():
        y = tmx.npx.dropout(x, p=0.4)
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), y.asnumpy(), rtol=1e-6)


def _sigmoid_fn(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = pkg.npx.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid()


def test_custom_function():
    def case(pkg):
        x = _var(pkg, [0.5, -1.0, 2.0])
        f = _sigmoid_fn(pkg)
        with pkg.autograd.record():
            y = f(x)
            z = (y * pkg.np.array([1., 2., 3.])).sum()
        z.backward()
        return y.asnumpy(), x.grad.asnumpy()
    y, g = _both(case)
    s = 1 / (1 + onp.exp(-onp.array([0.5, -1.0, 2.0])))
    onp.testing.assert_allclose(g, s * (1 - s) * [1, 2, 3], rtol=1e-5)


def test_custom_function_two_inputs_and_outputs():
    def case(pkg):
        class MulAdd(pkg.autograd.Function):
            def forward(self, a, b):
                self.save_for_backward(a, b)
                return a * b, a + b

            def backward(self, d_prod, d_sum):
                a, b = self.saved_tensors
                return d_prod * b + d_sum, d_prod * a + d_sum

        a, b = _var(pkg, [1., 2.]), _var(pkg, [3., -1.])
        with pkg.autograd.record():
            p, s = MulAdd()(a, b)
            loss = (p * 2 + s).sum()
        loss.backward()
        return p.asnumpy(), s.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()
    _, _, ga, gb = _both(case)
    onp.testing.assert_allclose(ga, [7., -1.])
    onp.testing.assert_allclose(gb, [3., 5.])


def test_function_outside_record_is_plain():
    x = _var(tmx, [0.0])
    y = _sigmoid_fn(tmx)(x)
    onp.testing.assert_allclose(y.asnumpy(), [0.5])
    assert not tmx.autograd._on_tape(y)


def test_higher_order_create_graph():
    def case(pkg):
        x = _var(pkg, [2.0, -1.0])
        with pkg.autograd.record():
            y = (x ** 3).sum()
            (gx,) = pkg.autograd.grad(y, [x], create_graph=True,
                                      retain_graph=True)
            z = (gx * gx).sum()
        z.backward()
        return gx.asnumpy(), x.grad.asnumpy()
    gx, g2 = _both(case)
    onp.testing.assert_allclose(gx, [12., 3.], rtol=1e-5)
    # z = sum (3x^2)^2 -> dz/dx = 36 x^3
    onp.testing.assert_allclose(g2, [288., -36.], rtol=1e-5)


def test_gradients_of_ported_ops():
    """Gradients through every differentiable family this slice ports:
    elementwise, broadcasting, reductions, shape ops, matmul, indexing,
    softmax, where/clip."""
    rng = onp.random.RandomState(0)
    xa = rng.uniform(0.5, 2.0, (3, 4)).astype("f4")
    wa = rng.uniform(-1, 1, (4, 2)).astype("f4")
    ba = rng.uniform(-1, 1, (4,)).astype("f4")

    def case(pkg):
        np, npx = pkg.np, pkg.npx
        x, w, b = _var(pkg, xa), _var(pkg, wa), _var(pkg, ba)
        with pkg.autograd.record():
            h = np.tanh(x * 0.5 + b) / (1 + np.exp(-x))
            h = np.sqrt(np.abs(h) + 1) - np.log(x) + np.maximum(h, 0.1)
            m = np.matmul(h, w) + np.dot(x.T[:2], w[:3, :]).sum()
            s = npx.log_softmax(m, axis=-1) + npx.softmax(m, axis=0)
            t = np.concatenate([s, np.transpose(s)[:, :3].T], axis=1)
            u = np.where(t > 0, t, t * 0.1).reshape(2, 6)
            v = np.clip(u, -1.5, 1.5)[np.array([1, 0, 1])]
            loss = (np.stack([v, v * 2]).mean(axis=0) ** 2).sum() \
                + np.expand_dims(x, 0).max(axis=2).sum() \
                + (np.flip(x, 1)[:, 0] * np.tile(b[:3], 1)).prod()
        loss.backward()
        return (loss.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy(),
                b.grad.asnumpy())
    _both(case)


@pytest.mark.parametrize("op", ["abs", "clip_both", "clip_low",
                                "clip_high"])
def test_subgradients_at_ties(op):
    """The reference's subgradients where the function has a kink: abs
    passes the gradient at 0 (JAX: where x >= 0), clip splits it in
    halves at a bound (JAX's min/max split ties)."""
    xa = [-1.0, 0.0, 0.5, 2.0, 3.0, -0.0]

    def case(pkg):
        np = pkg.np
        x = _var(pkg, xa)
        with pkg.autograd.record():
            y = {"abs": lambda: np.abs(x),
                 "clip_both": lambda: np.clip(x, 0.0, 2.0),
                 "clip_low": lambda: np.clip(x, 0.5, None),
                 "clip_high": lambda: np.clip(x, None, 2.0)}[op]()
            loss = (y * np.arange(1, 1 + y.shape[0])).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()
    (y, g) = _both(case)
    if op == "abs":
        onp.testing.assert_array_equal(g, [-1, 2, 3, 4, 5, 6])
        assert not onp.signbit(y).any()      # |-0.0| is +0.0


def test_negative_step_slice_gradient():
    def case(pkg):
        x = _var(pkg, [[1.0, -2.0, 3.0], [4.0, 5.0, -6.0]])
        with pkg.autograd.record():
            y = (x[::-1, ::-2] * pkg.np.array([[1.0, 2.0], [3.0, 4.0]]))
            loss = (y * y).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()
    _both(case)
