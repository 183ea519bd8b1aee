"""The port's ``initializer`` (and ``mx.init``) against the JAX
package's, on the CPU.

The deterministic initializers (``Zero``, ``One``, ``Constant``,
``Bilinear``, ``LSTMBias``, ``InitWithArray``, ``Mixed``) and the name
dispatch (``weight``/``bias``/``gamma``/``beta``/``running_*``) are
held to the reference exactly. The random ones draw from torch's
generators, whose numbers differ from JAX's for one seed, so they are
held to their distributions: ``Uniform`` and ``Xavier``-uniform within
their bound and spreading over it (the extremes within 2 % of it, the
variance within 10 % of bound^2 / 3), ``Normal``, ``Xavier``-gaussian
and ``MSRAPrelu`` at their standard deviation within 10 %,
``Orthogonal``'s Gram matrix ``scale^2 I`` to 1e-5 (as the reference's),
and a seed repeating them bitwise.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(init_of, name, shape):
    """``name``'s array of ``shape`` filled by each package's
    initializer (``init_of(pkg)``), as numpy: the port's on a tensor and
    on an NDArray (which must agree), the reference's on an NDArray."""
    t = torch.zeros(shape)
    init_of(tmx)(name, t)
    nd = tmx.np.zeros(shape)
    init_of(tmx)(name, nd)
    onp.testing.assert_array_equal(nd.asnumpy(), t.numpy())
    j = jmx.np.zeros(shape)
    init_of(jmx)(name, j)
    return t.numpy(), j.asnumpy()


EXACT = [
    ("zero", lambda m: m.init.Zero(), "w.weight", (3, 4)),
    ("one", lambda m: m.init.One(), "w.weight", (3, 4)),
    ("constant", lambda m: m.init.Constant(0.5), "w.weight", (3, 4)),
    ("constant_array",
     lambda m: m.init.Constant(onp.arange(4, dtype="f4")), "w.weight",
     (3, 4)),
    ("bilinear", lambda m: m.init.Bilinear(), "up.weight", (2, 1, 4, 4)),
    ("lstm_bias", lambda m: m.init.LSTMBias(2.0), "rnn.bias", (8,)),
    ("init_with_array",
     lambda m: m.init.InitWithArray(onp.arange(12, dtype="f4")
                                    .reshape(3, 4)), "w.weight", (3, 4)),
    ("mixed", lambda m: m.init.Mixed(["a.*", ".*"],
                                     [m.init.One(), m.init.Constant(3.0)]),
     "b.weight", (2, 3)),
    ("dispatch_bias", lambda m: m.init.Xavier(), "fc.bias", (4,)),
    ("dispatch_gamma", lambda m: m.init.Uniform(), "bn.gamma", (4,)),
    ("dispatch_beta", lambda m: m.init.Normal(), "bn.beta", (4,)),
    ("dispatch_running_mean", lambda m: m.init.Xavier(), "bn.running_mean",
     (4,)),
    ("dispatch_running_var", lambda m: m.init.Xavier(), "bn.running_var",
     (4,)),
]


@pytest.mark.parametrize("case", EXACT, ids=[c[0] for c in EXACT])
def test_deterministic_initializers_match(case):
    _, init_of, name, shape = case
    got, ref = _both(init_of, name, shape)
    onp.testing.assert_array_equal(got, ref)


def test_mixed_without_match_raises_and_init_desc_override():
    for m in (tmx, jmx):
        mixed = m.init.Mixed(["conv.*"], [m.init.One()])
        with pytest.raises(ValueError, match="did not match"):
            mixed("fc.weight", m.np.zeros((2, 2)))
    # attrs["__init__"] names an initializer that overrides the dispatch
    got, ref = _both(lambda m: m.init.Xavier(),
                     tmx.init.InitDesc("fc.bias", attrs={"__init__": "one"}),
                     (3,))
    onp.testing.assert_array_equal(got, onp.ones(3, "f4"))
    desc = jmx.init.InitDesc("fc.bias", attrs={"__init__": "one"})
    j = jmx.np.zeros((3,))
    jmx.init.Xavier()(desc, j)
    onp.testing.assert_array_equal(j.asnumpy(), got)


def _spread(a, bound):
    """Values within ``bound``, reaching it, with U(-b, b)'s variance."""
    assert onp.abs(a).max() <= bound * (1 + 1e-6)
    assert onp.abs(a).max() >= 0.98 * bound
    assert abs(a.var() - bound ** 2 / 3) <= 0.1 * bound ** 2 / 3


def test_uniform_and_xavier_uniform_bounds():
    t = torch.empty(64, 128)
    tmx.init.Uniform(0.3)("w.weight", t)
    _spread(t.numpy(), 0.3)
    tmx.init.Xavier()("w.weight", t)
    _spread(t.numpy(), math.sqrt(3.0 / ((64 + 128) / 2)))
    # a conv kernel's fans count the receptive field
    k = torch.empty(32, 16, 3, 3)
    tmx.init.Xavier(factor_type="in", magnitude=2)("c.weight", k)
    _spread(k.numpy(), math.sqrt(2.0 / (16 * 9)))
    with pytest.raises(ValueError, match="2D"):
        tmx.init.Xavier()("w.weight", torch.empty(5))


@pytest.mark.parametrize("kind", ["normal", "xavier_gaussian", "msra"])
def test_gaussian_initializers_std(kind):
    t = torch.empty(128, 256)
    if kind == "normal":
        tmx.init.Normal(0.02)("w.weight", t)
        sigma = 0.02
    elif kind == "xavier_gaussian":
        tmx.init.Xavier(rnd_type="gaussian", factor_type="out",
                        magnitude=2)("w.weight", t)
        sigma = math.sqrt(2.0 / 128)
    else:
        tmx.init.MSRAPrelu(slope=0.1)("w.weight", t)
        sigma = math.sqrt(2.0 / (1 + 0.01) / ((128 + 256) / 2))
    a = t.numpy()
    assert abs(a.std() - sigma) <= 0.1 * sigma
    assert abs(a.mean()) <= 0.1 * sigma


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_gram(rand_type):
    w = torch.empty(6, 2, 5)
    tmx.init.Orthogonal(scale=1.5, rand_type=rand_type)("w.weight", w)
    flat = w.numpy().reshape(6, 10)
    onp.testing.assert_allclose(flat @ flat.T, 2.25 * onp.eye(6),
                                atol=1e-5)
    j = jmx.np.zeros((6, 2, 5))
    jmx.init.Orthogonal(scale=1.5, rand_type=rand_type)("w.weight", j)
    jf = j.asnumpy().reshape(6, 10)
    onp.testing.assert_allclose(jf @ jf.T, flat @ flat.T, atol=1e-5)


def test_seed_repeats_random_initializers():
    out = []
    for _ in range(2):
        tmx.random.seed(3)
        t = torch.empty(4, 5)
        tmx.init.Xavier()("w.weight", t)
        out.append(t.clone())
    assert torch.equal(out[0], out[1])


def test_create_register_and_names():
    for m in (tmx, jmx):
        assert type(m.init.create("zeros")) is m.init.Zero
        assert type(m.init.create("ones")) is m.init.One
        x = m.init.create("xavier", magnitude=2)
        assert isinstance(x, m.init.Xavier) and x.magnitude == 2.0
        inst = m.init.Normal()
        assert m.init.create(inst) is inst
        fn = lambda desc, arr: None  # noqa: E731
        assert m.init.create(fn) is fn
    assert tmx.init.create('{"name": "constant", "value": 2}').value == 2
    assert repr(tmx.init.Xavier()) == repr(jmx.init.Xavier())
    assert tmx.init.Load is tmx.init.InitWithArray
    assert tmx.init.Zeros is tmx.init.Zero

    @tmx.init.register
    class MyInit(tmx.init.Initializer):
        def _init_weight(self, desc, t):
            self._set(t, 7.0)
    t = torch.empty(2)
    tmx.init.create("myinit")("a.weight", t)
    assert t.tolist() == [7.0, 7.0]
    assert tmx.initializer.InitDesc("x", attrs={"a": 1}).attrs == {"a": 1}
