"""The port's CustomOp bridge (mxnet_tpu_torch.operator) against the
JAX package's on the same numpy inputs, both on the CPU: the custom-op
cases of tests/test_operator_custom.py and the flow of
examples/custom_op.py without its rtc part (the softsign CustomOp
through ``npx.custom``, then ``ClipGrad``, an ``autograd.Function``
with an identity forward and a clipped backward). Outputs and ``x.grad``
must agree with the JAX package's (rtol=1e-5, atol=1e-5) and with the
closed forms. The ops are registered in both packages under names of
their own (``cmp_*``), so this file leaves the JAX package's tests'
registrations alone.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

GT = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _register(pkg):
    """The ops of tests/test_operator_custom.py and
    examples/custom_op.py, registered in ``pkg``'s registry."""
    op = pkg.operator

    @op.register("cmp_sigmoid_x2")
    class SigmoidX2Prop(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["out"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return SigmoidX2()

    class SigmoidX2(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = 2.0 / (1.0 + onp.exp(-x))
            self.assign(out_data[0], req[0], pkg.np.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            s = out_data[0].asnumpy() / 2.0
            g = out_grad[0].asnumpy() * 2.0 * s * (1.0 - s)
            self.assign(in_grad[0], req[0], pkg.np.array(g))

    @op.register("cmp_softsign_x")
    class SoftsignProp(op.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Softsign()

    class Softsign(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            self.assign(out_data[0], req[0], x / (1 + abs(x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] / (1 + abs(x)) ** 2)

    @op.register("cmp_ident_nograd")
    class IdentProp(op.CustomOpProp):
        def create_operator(self, ctx, s, t):
            class Ident(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0])
            return Ident()

    @op.register("cmp_scaled_sum")
    class ScaledSumProp(op.CustomOpProp):
        """Two inputs, two outputs, an aux state and 'add' in forward."""

        def __init__(self, scale="1.0"):
            super().__init__()
            self.scale = float(scale)

        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "prod"]

        def list_auxiliary_states(self):
            return ["bias"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], [in_shape[0]]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaledSum(self.scale)

    class ScaledSum(op.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = in_data
            self.assign(out_data[0], req[0], a * self.scale)
            self.assign(out_data[0], "add", b + aux[0])
            self.assign(out_data[1], req[1], a * b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = in_data
            gs, gp = out_grad
            self.assign(in_grad[0], req[0], gs * self.scale + gp * b)
            self.assign(in_grad[1], req[1], gs + gp * a)


_register(tmx)
_register(jmx)


def _clipgrad(pkg, returns_input):
    """The example's ClipGrad. ``returns_input=True`` is the example's
    own forward (``return x``). The JAX package loses the gradient
    there: its Function rebinds the returned input's tape node to the
    Function's own node, so the cotangent never reaches what came before
    (``python examples/custom_op.py`` prints zero clipped grads). Its
    reference values are therefore taken with ``returns_input=False``
    (``return x * 1.0``, the same function)."""
    class ClipGrad(pkg.autograd.Function):
        """Identity forward, clipped gradient backward."""

        def forward(self, x):
            return x if returns_input else x * 1.0

        def backward(self, dy):
            return pkg.np.clip(dy, -0.1, 0.1)
    return ClipGrad()


def _both(case, **kw):
    t, j = case(tmx, **kw), case(jmx, **kw)
    for a, b in zip(t, j):
        onp.testing.assert_allclose(a, b, **GT)
    return t


def test_custom_op_forward_and_grad():
    """tests/test_operator_custom.py::test_custom_op_forward_and_grad."""
    def case(pkg):
        x = pkg.np.array(onp.linspace(-2, 2, 12, dtype="float32")
                         .reshape(3, 4))
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.operator.custom(x, op_type="cmp_sigmoid_x2")
            loss = (y * y).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()
    y, g = _both(case)
    xs = onp.linspace(-2, 2, 12, dtype="float32").reshape(3, 4)
    sig = 1.0 / (1.0 + onp.exp(-xs))
    onp.testing.assert_allclose(y, 2 * sig, rtol=1e-5)
    onp.testing.assert_allclose(g, 2 * y * 2 * sig * (1 - sig), rtol=1e-5)


def test_custom_op_via_npx_and_registry_introspection():
    for pkg in (tmx, jmx):
        y = pkg.npx.custom(pkg.np.ones((2, 2)), op_type="cmp_sigmoid_x2")
        assert y.shape == (2, 2)
        assert not pkg.autograd._on_tape(y)
    ops = tmx.operator.get_all_registered_operators()
    assert {"cmp_sigmoid_x2", "cmp_softsign_x"} <= set(ops)
    assert tmx.operator.get_all_registered_operators_grouped()[
        "cmp_sigmoid_x2"] == ["cmp_sigmoid_x2"]
    assert tmx.operator.get_operator_arguments("cmp_sigmoid_x2") == \
        jmx.operator.get_operator_arguments("cmp_sigmoid_x2")
    assert tmx.operator.get_operator_arguments("cmp_scaled_sum")["names"] == \
        ["a", "b"]


def test_custom_op_default_backward_zero_grad():
    def case(pkg):
        x = pkg.np.ones((3,))
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.operator.custom(x, op_type="cmp_ident_nograd")
        y.backward()
        return y.asnumpy(), x.grad.asnumpy()
    y, g = _both(case)
    onp.testing.assert_allclose(y, onp.ones(3))
    onp.testing.assert_allclose(g, onp.zeros(3))


def test_custom_op_two_outputs_aux_and_kwargs():
    rng = onp.random.RandomState(0)
    aa, ba, bias = (rng.uniform(-1, 1, (5,)).astype("f4") for _ in range(3))

    def case(pkg):
        a, b = pkg.np.array(aa), pkg.np.array(ba)
        a.attach_grad()
        b.attach_grad()
        with pkg.autograd.record():
            s, p = pkg.npx.custom(a, b, pkg.np.array(bias),
                                  op_type="cmp_scaled_sum", scale="3.0")
            loss = (s * 2 + p).sum()
        loss.backward()
        return s.asnumpy(), p.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()
    s, p, ga, gb = _both(case)
    onp.testing.assert_allclose(s, aa * 3 + ba + bias, **GT)
    onp.testing.assert_allclose(ga, 6 + ba, **GT)
    onp.testing.assert_allclose(gb, 2 + aa, **GT)


def test_custom_op_errors():
    for pkg in (tmx, jmx):
        with pytest.raises(KeyError, match="not registered"):
            pkg.operator.custom(pkg.np.ones((2,)), op_type="nope")
        with pytest.raises(ValueError, match="declares 2 arguments"):
            pkg.operator.custom(pkg.np.ones((2,)), op_type="cmp_scaled_sum")
        with pytest.raises(TypeError):
            pkg.operator.register("bad")(object)
        with pytest.raises(NotImplementedError):
            pkg.operator.NumpyOp()


@pytest.mark.parametrize("returns_input", [True, False],
                         ids=["example_forward", "copying_forward"])
def test_example_custom_op_flow(returns_input):
    """examples/custom_op.py without its rtc part: softsign through
    npx.custom, then ClipGrad on 4*y. ClipGrad receives the head grad 1
    and clips it to 0.1, so x.grad = 4 * 0.1 / (1+|x|)^2. The port gives
    it with either forward; the JAX package with the copying one."""
    xs = onp.linspace(-3, 3, 8, dtype="float32")

    def case(pkg, returns_input):
        x = pkg.np.array(xs)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.npx.custom(x, op_type="cmp_softsign_x")
            z = _clipgrad(pkg, returns_input)(y * 4.0)
            loss = z.sum()
        loss.backward()
        return y.asnumpy(), z.asnumpy(), x.grad.asnumpy()
    y, z, g = case(tmx, returns_input)
    for a, b in zip((y, z, g), case(jmx, returns_input=False)):
        onp.testing.assert_allclose(a, b, **GT)
    onp.testing.assert_allclose(y, xs / (1 + onp.abs(xs)), **GT)
    onp.testing.assert_allclose(z, 4 * y, **GT)
    onp.testing.assert_allclose(g, 0.4 / (1 + onp.abs(xs)) ** 2, **GT)


def test_example_flow_with_large_head_grad_clips():
    """A head gradient above the clip bound: ClipGrad sends +-0.1."""
    xs = onp.linspace(-3, 3, 8, dtype="float32")
    hg = onp.linspace(-2, 2, 8, dtype="float32")

    def case(pkg, returns_input):
        x = pkg.np.array(xs)
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.npx.custom(x, op_type="cmp_softsign_x")
            z = _clipgrad(pkg, returns_input)(y)
        z.backward(pkg.np.array(hg))
        return (x.grad.asnumpy(),)
    g, = _both(case, returns_input=False)
    onp.testing.assert_allclose(
        g, onp.clip(hg, -0.1, 0.1) / (1 + onp.abs(xs)) ** 2, **GT)
    onp.testing.assert_allclose(case(tmx, returns_input=True)[0], g, **GT)
