"""The port's ``mx.npx`` batch norm, activations and softmaxes against
the JAX package's, on the CPU: ``batch_norm`` (training with its
running statistics, inference, ``fix_gamma``, ``use_global_stats``,
``output_mean_var``, float16), ``fully_connected``, ``embedding``, the
activation table and the softmax family crossed over bool, uint8,
uint16, uint32, int8, int32, float16 and float32, and the gradients of
batch norm, the activations, the softmaxes and ``fully_connected``
under ``autograd.record()``.

Tolerances (``test_torch_np_common.py``): dtype and shape exactly;
elementwise fp32 at 2e-6 (``TR``); batch norm, products and gradients
at 1e-5 (``RED``); a float16 batch norm within two float16 steps (the
port accumulates a 16-bit norm's statistics in fp32,
``ops.nn.accum_dtype``)."""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import (DTYPES, RED, TR, check, grads, same,
                                  values)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

F16_NORM = dict(rtol=2.0 ** -9, atol=2.0 ** -9)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _bn_args(dtype="float32"):
    x = values(dtype, shape=(4, 3, 5, 2), seed=50)
    g = values("float32", shape=(3,), lo=0.5, hi=1.5, seed=51)
    b = values("float32", shape=(3,), seed=52)
    rm = values("float32", shape=(3,), seed=53)
    rv = values("float32", shape=(3,), lo=0.5, hi=2.0, seed=54)
    return x, g, b, rm, rv


@pytest.mark.parametrize("kw", [{}, {"fix_gamma": True},
                                {"use_global_stats": True},
                                {"output_mean_var": True, "momentum": 0.7},
                                {"axis": 3}], ids=repr)
def test_batch_norm_training_updates_running_stats(kw):
    x, g, b, rm, rv = _bn_args()
    if kw.get("axis") == 3:
        x = x.transpose(0, 2, 3, 1).copy()
    res = []
    for pkg in (tmx, jmx):
        arrs = [pkg.np.array(a) for a in (x, g, b, rm, rv)]
        for a in arrs[:3]:
            a.attach_grad()
        with pkg.autograd.record():
            out = pkg.npx.batch_norm(*arrs, **kw)
            y = out[0] if isinstance(out, (list, tuple)) else out
            w = pkg.np.array(values("float32", shape=y.shape, seed=55))
            s = (y * w).sum()
        s.backward()
        res.append((out, arrs[3], arrs[4], [a.grad for a in arrs[:3]]))
    same(res[0], res[1], RED)


def test_batch_norm_inference_and_float16():
    x, g, b, rm, rv = _bn_args()
    check("npx.batch_norm", (x, g, b, rm, rv), {}, tol=RED, nojit=True)
    x16 = x.astype("float16")
    for train in (False, True):
        outs = []
        for pkg in (tmx, jmx):
            rms = [pkg.np.array(rm), pkg.np.array(rv)]
            with pkg.autograd.record(train_mode=train):
                out = pkg.npx.batch_norm(pkg.np.array(x16), pkg.np.array(g),
                                         pkg.np.array(b), *rms)
            outs.append((out, *rms))
        same(outs[0], outs[1], F16_NORM)


#: the activation table (``npx.activation``, ``npx.leaky_relu``) is
#: crossed over the dtypes; the named activations are aliases of its
#: entries, each crossed once
TABLE = [("npx.activation", {"act_type": a})
         for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign",
                   "mish", "relu6", "gelu", "silu")]
TABLE += [("npx.leaky_relu", {"act_type": a, "slope": 0.3})
          for a in ("leaky", "elu", "selu", "gelu_tanh")]
ALIASES = [("npx." + n, {}) for n in (
    "relu", "sigmoid", "softsign", "softplus", "mish", "gelu", "silu",
    "hard_sigmoid", "hard_swish")]
ALIASES += [("npx.gelu", {"approximate": True}),
            ("npx.activation", {"act_type": "swish"})]
ALIASES += [("npx.leaky_relu", {"act_type": a}) for a in ("gelu", "silu")]


@pytest.mark.parametrize("dtype", DTYPES)
def test_activations(dtype):
    """The activation table crossed over the dtypes; an integer input of
    a float activation, which the reference refuses, computes in
    float32 in the port (``wider``)."""
    x = values(dtype, seed=70)
    for name, kw in TABLE + (ALIASES if dtype == "float32" else []):
        check(name, (x,), kw, tol=TR, nojit=True,
              wider=not dtype.startswith("float"))


@pytest.mark.parametrize("dtype", ["bool", "int8", "int32", "float16",
                                   "float32"])
def test_negating_activations(dtype):
    """``log_sigmoid`` and ``softmin`` negate their input; of an unsigned
    one the reference's negation wraps (ROADMAP.md, not queued), so
    these two are crossed over the other dtypes."""
    x = values(dtype, seed=70)
    for name, kw in [("npx.log_sigmoid", {}), ("npx.softmin", {"axis": 0})]:
        check(name, (x,), kw, tol=TR, nojit=True,
              wider=not dtype.startswith("float"))


def test_prelu_and_activation_gradients():
    x = values("float32", seed=70)
    g = values("float32", shape=(4,), lo=0.1, hi=0.5, seed=73)
    t, j = grads("npx.leaky_relu", (x.reshape(1, 4, 3), g),
                 {"act_type": "prelu"}, wrt=(0, 1))
    same(t, j, RED)
    for name, kw in TABLE:
        t, j = grads(name, (x,), kw)
        same(t, j, RED)


def test_softmax_family():
    x = values("float32", seed=74)
    m = values("bool", seed=75)
    m[:, 0] = True
    t, j = grads("npx.masked_softmax", (x, m), {"temperature": 2.0})
    same(t, j, RED)
    t, j = grads("npx.masked_log_softmax", (x, m), {"axis": -1})
    same(t, j, RED)
    check("npx.masked_softmax", (x,), {"temperature": 0.5}, tol=TR,
          nojit=True)
    check("npx.masked_log_softmax", (x.astype("float16"), m), {}, tol=TR,
          nojit=True)


def test_fully_connected_and_embedding():
    x = values("float32", shape=(4, 2, 3), seed=76)
    w = values("float32", shape=(5, 6), seed=77)
    b = values("float32", shape=(5,), seed=78)
    check("npx.fully_connected", (x, w[:, :3]),
          {"no_bias": True, "flatten": False}, tol=RED, nojit=True)
    t, j = grads("npx.fully_connected", (x, w, b), {}, wrt=(0, 1, 2))
    same(t, j, RED)
    idx = values("int32", shape=(2, 3), seed=79) + 5
    tab = values("float32", shape=(10, 4), seed=80)
    check("npx.embedding", (idx.astype("float32"), tab), {}, tol=RED,
          nojit=True)
    t, j = grads("npx.embedding", (idx, tab), {}, wrt=(1,))
    same(t, j, RED)
