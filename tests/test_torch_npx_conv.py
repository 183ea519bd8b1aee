"""The port's ``mx.npx`` convolutions, pooling and norms against the
JAX package's, on the CPU: ``convolution`` and ``deconvolution`` (1-3
spatial dims, ``NC*`` and ``N*C`` layouts, groups, dilation, padding,
``adj``; float32 and float16) and ``pooling`` (max, avg, sum, lp;
``valid``/``full``/``same``; ``count_include_pad``; global; integer and
float16 inputs), ``layer_norm``, ``group_norm``, ``instance_norm``,
``rms_norm`` and ``l2_normalization`` (three modes; float32 and
float16), with their gradients under ``autograd.record()`` (the
convolutions' in one layout of each family).

Tolerances (``test_torch_np_common.py``): dtype and shape exactly; the
values and gradients at 1e-5 (``RED``), a float16 result within one
float16 step, a float16 norm within two (the port accumulates a 16-bit
norm's statistics in fp32, ``ops.nn.accum_dtype``; the reference's
group and instance norms stay in float16)."""
import threading
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx

from test_torch_np_common import RED, check, grads, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

F16_NORM = dict(rtol=2.0 ** -9, atol=2.0 ** -9)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _conv_case(layout, nsp, rs_seed, deconv=False):
    cl = not layout.startswith("NC")
    sp = (5, 6, 4)[:nsp]
    cin, cout, g = 4, 6, 2
    x = values("float32", shape=(2,) + ((sp + (cin,)) if cl
                                        else ((cin,) + sp)), seed=rs_seed)
    if deconv:
        # (I, O/g, *k) / (I, *k, O/g)
        wshape = (cin,) + ((3,) * nsp + (cout // g,) if cl
                           else (cout // g,) + (3,) * nsp)
    else:
        wshape = (cout,) + ((3,) * nsp + (cin // g,) if cl
                            else (cin // g,) + (3,) * nsp)
    w = values("float32", shape=wshape, lo=-0.5, hi=0.5, seed=rs_seed + 1)
    b = values("float32", shape=(cout,), seed=rs_seed + 2)
    return x, w, b


LAYOUTS = [("NCW", 1), ("NCHW", 2), ("NCDHW", 3), ("NWC", 1), ("NHWC", 2),
           ("NDHWC", 3)]
#: the layouts whose gradients are crossed (one of each family)
GRAD_LAYOUTS = ("NCHW", "NDHWC")


@pytest.mark.parametrize("layout,nsp", LAYOUTS, ids=lambda v: str(v))
def test_convolution(layout, nsp):
    x, w, b = _conv_case(layout, nsp, 10)
    kw = dict(kernel=(3,) * nsp, num_group=2, layout=layout)
    check("npx.convolution", (x, w), dict(kw, dilate=2, pad=2, no_bias=True),
          tol=RED, nojit=True)
    if layout in GRAD_LAYOUTS:
        t, j = grads("npx.convolution", (x, w, b), dict(kw, stride=2, pad=1),
                     wrt=(0, 1, 2))
        same(t, j, RED)
    else:
        check("npx.convolution", (x, w, b), dict(kw, stride=2, pad=1),
              tol=RED, nojit=True)


@pytest.mark.parametrize("layout,nsp", LAYOUTS, ids=lambda v: str(v))
def test_deconvolution(layout, nsp):
    x, w, b = _conv_case(layout, nsp, 20, deconv=True)
    kw = dict(kernel=(3,) * nsp, num_group=2, layout=layout, stride=2,
              pad=1)
    check("npx.deconvolution", (x, w), dict(kw, adj=1), tol=RED, nojit=True)
    if layout in GRAD_LAYOUTS:
        t, j = grads("npx.deconvolution", (x, w, b),
                     dict(kw, dilate=2, no_bias=False), wrt=(0, 1, 2))
        same(t, j, RED)


def test_convolution_float16():
    x, w, b = _conv_case("NCHW", 2, 30)
    args = tuple(a.astype("float16") for a in (x, w, b))
    check("npx.convolution", args, dict(kernel=(3, 3), num_group=2, pad=1),
          tol=RED, nojit=True)


@pytest.mark.parametrize("layout", ["NCHW", "NWC", "NCDHW"])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
def test_pooling(pool_type, layout):
    nsp = len(layout) - 2
    cl = not layout.startswith("NC")
    sp = (7, 6, 5)[:nsp]
    x = values("float32", shape=(2,) + ((sp + (3,)) if cl else ((3,) + sp)),
               seed=40)
    if pool_type == "lp" and layout != "NCHW":
        return
    kw = dict(kernel=3, pool_type=pool_type, stride=2, pad=1, layout=layout)
    for conv in ("valid", "same"):
        check("npx.pooling", (x,), dict(kw, pooling_convention=conv),
              tol=RED, nojit=True)
    if pool_type == "avg":
        check("npx.pooling", (x,), dict(kw, count_include_pad=False),
              tol=RED, nojit=True)
    if pool_type != "sum":
        check("npx.pooling", (x,), dict(kernel=3, pool_type=pool_type,
                                        global_pool=True, layout=layout),
              tol=RED, nojit=True)
    t, j = grads("npx.pooling", (x,), dict(
        kw, pooling_convention="full", count_include_pad=False))
    same(t, j, RED)


@pytest.mark.parametrize("dtype", ["int8", "int32", "uint8", "float16"])
def test_pooling_other_types(dtype):
    x = values(dtype, shape=(2, 3, 7, 6), seed=41)
    for pool_type in ("max", "avg"):
        # the reference's integer max pooling starts from a weak int32
        # minimum and refuses int8/uint8 (``wider``)
        check("npx.pooling", (x,), dict(kernel=2, pool_type=pool_type,
                                        stride=2, pad=1), tol=RED,
              nojit=True, wider=not dtype.startswith("float"))


def test_global_sum_pooling_sums():
    """Global ``sum`` pooling is the sum in the port (MXNet's); the
    reference gives the lp norm there (ROADMAP.md, not queued)."""
    x = values("float32", shape=(2, 3, 4, 5), seed=42)
    y = tmx.npx.pooling(tmx.np.array(x), pool_type="sum", global_pool=True)
    onp.testing.assert_allclose(y.asnumpy(), x.sum((2, 3), keepdims=True),
                                **RED)


NORMS = [
    ("npx.layer_norm", "x gc bc", {"axis": 1}),
    ("npx.group_norm", "x gc bc", {"num_groups": 2}),
    ("npx.instance_norm", "x gc bc", {}),
    ("npx.rms_norm", "x g", {}),
    ("npx.l2_normalization", "x", {"mode": "instance"}),
    ("npx.l2_normalization", "x", {"mode": "channel"}),
    ("npx.l2_normalization", "x", {"mode": "spatial"}),
]


@pytest.mark.parametrize("name,argspec,kw", NORMS, ids=lambda v: repr(v))
def test_norms(name, argspec, kw):
    arrs = {"x": values("float32", shape=(3, 4, 5), seed=60),
            "g": values("float32", shape=(5,), lo=0.5, hi=1.5, seed=61),
            "gc": values("float32", shape=(4,), lo=0.5, hi=1.5, seed=63),
            "bc": values("float32", shape=(4,), seed=64)}
    args = tuple(arrs[k] for k in argspec.split())
    check(name, tuple(a.astype("float16") if i == 0 else a
                      for i, a in enumerate(args)), kw, tol=F16_NORM,
          nojit=True)
    t, j = grads(name, args, kw, wrt=tuple(range(len(args))))
    same(t, j, RED)


def test_tf32_switch_survives_threads():
    """The convolutions turn cuDNN's process-wide TF32 switch off and
    back under one lock: scopes of several threads never see it on and
    leave the process's setting as it was."""
    from mxnet_tpu_torch.ops import nn as tnn
    prev = torch.backends.cudnn.allow_tf32
    seen = []

    def work():
        for _ in range(200):
            with tnn._fp32_products(True):
                seen.append(torch.backends.cudnn.allow_tf32)
                time.sleep(0)
    try:
        torch.backends.cudnn.allow_tf32 = True
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(seen) == 800 and not any(seen)
        assert torch.backends.cudnn.allow_tf32 is True
        with tnn._fp32_products(False):        # the CPU leaves it alone
            assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
