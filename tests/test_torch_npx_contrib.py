"""The rest of the port's contrib operators (``numpy_extension/
contrib_ops.py``) against the JAX package's, on the CPU: the
interleaved attention products and ``div_sqrt_dim``, ``lrn``,
``adaptive_avg_pool2d``, ``bilinear_resize2d``,
``depth_to_space``/``space_to_depth``, ``im2col``/``col2im``,
``moments``, ``khatri_rao``, ``index_copy``, ``quadratic``,
``stop_gradient``, ``constraint_check``, the sliding-window attention,
``hawkesll`` and ``identity_attach_kl_sparse_reg``, crossed over the
dtypes of ``DTYPES`` (where the reference raises for a dtype the port
must raise too), with the gradients of the differentiable ones.

Tolerances (``test_torch_np_common.py``): dtype and shape exactly;
integers and bools exactly; fp32 within 1e-5 (``RED``), a float16
result within one float16 step."""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_np_common import DTYPES, RED, check, grads, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _qkv(dtype, seed):
    return values(dtype, (4, 2, 2 * 3 * 3), seed=seed)


@pytest.mark.parametrize("dtype", DTYPES)
def test_interleaved_products(dtype):
    """The four products; in float32 with the gradients of the
    self-attention pair."""
    qkv = _qkv(dtype, 1)
    att = values(dtype, (4, 4, 4), seed=2)
    if dtype == "float32":
        t, j = grads("npx.interleaved_matmul_selfatt_qk", (qkv,),
                     {"heads": 2})
        same(t, j, RED)
        t, j = grads("npx.interleaved_matmul_selfatt_valatt", (qkv, att),
                     {"heads": 2}, wrt=(0, 1))
        same(t, j, RED)
    else:
        check("npx.interleaved_matmul_selfatt_qk", (qkv,), {"heads": 2},
              tol=RED, nojit=True)
        check("npx.interleaved_matmul_selfatt_valatt", (qkv, att),
              {"heads": 2}, tol=RED, nojit=True)
    q = values(dtype, (3, 2, 6), seed=3)
    kv = values(dtype, (4, 2, 12), seed=4)
    check("npx.interleaved_matmul_encdec_qk", (q, kv), {"heads": 2},
          tol=RED, nojit=True)
    check("npx.interleaved_matmul_encdec_valatt",
          (kv, values(dtype, (4, 3, 4), seed=5)), {"heads": 2}, tol=RED,
          nojit=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_elementwise_and_moves(dtype):
    x = values(dtype, (2, 8, 3, 4), seed=8)
    check("npx.div_sqrt_dim", (x,), tol=RED, nojit=True)
    check("npx.quadratic", (x,), {"a": 0.5, "b": -1.5, "c": 2.0}, tol=RED,
          nojit=True)
    check("npx.stop_gradient", (x,), nojit=True)
    check("npx.depth_to_space", (x, 2), nojit=True)
    check("npx.space_to_depth", (values(dtype, (2, 2, 4, 6), seed=9), 2),
          nojit=True)
    check("npx.moments", (x,), {"axes": (0, 2)}, tol=RED, nojit=True)
    check("npx.moments", (x,), {"axes": (1,), "keepdims": True}, tol=RED,
          nojit=True)
    check("npx.khatri_rao", (values(dtype, (2, 3), seed=10),
                             values(dtype, (4, 3), seed=11),
                             values(dtype, (2, 3), seed=12)), nojit=True)
    old = values(dtype, (5, 3), seed=13)
    new = values(dtype, (2, 3), seed=14)
    check("npx.index_copy", (old, onp.array([3, 0], "i4"), new), nojit=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spatial(dtype):
    x = values(dtype, (2, 6, 5, 7), seed=15)
    check("npx.lrn", (x,), {"nsize": 3}, tol=RED, nojit=False)
    check("npx.adaptive_avg_pool2d", (x,), {"output_size": (2, 3)},
          tol=RED, nojit=False)
    check("npx.bilinear_resize2d", (x,), {"height": 9, "width": 4}, tol=RED)
    kw = dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1))
    check("npx.im2col", (x,), kw, nojit=False)
    cols = values(dtype, (2, 6 * 6, 3 * 7), seed=16)
    check("npx.col2im", (cols, (5, 7)), kw, tol=RED, nojit=False)


def test_spatial_gradients():
    """The resize weights (shrinking by scale, so antialiased) and
    col2im's strided sums."""
    x = values("float32", (2, 6, 5, 7), seed=17)
    kw = dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1))
    for path, args, k in (
            ("npx.bilinear_resize2d", (x,), {"scale_height": 0.6,
                                             "scale_width": 2.0}),
            ("npx.col2im", (values("float32", (2, 36, 21), seed=18),
                            (5, 7)), kw)):
        t, j = grads(path, args, k)
        same(t, j, RED)


def test_constraint_check():
    ok = onp.array([True, True])
    check("npx.constraint_check", (ok,), nojit=True)
    for pkg in (tmx, jmx):
        with pytest.raises(ValueError, match="too big"):
            pkg.npx.constraint_check(pkg.np.array([True, False]),
                                     msg="too big")


def _sldwin(dtype, seed):
    q = values(dtype, (2, 7, 3, 4), seed=seed)
    k = values(dtype, (2, 7, 3, 4), seed=seed + 1)
    dil = onp.array([1, 2, 1], "i4")
    return q, k, dil


@pytest.mark.parametrize("dtype", DTYPES)
def test_sliding_window_attention(dtype):
    q, k, dil = _sldwin(dtype, 19)
    check("npx.sldwin_atten_score", (q, k, dil), {"w": 2}, tol=RED,
          nojit=True)
    score = values(dtype, (2, 7, 3, 2), seed=21)
    check("npx.sldwin_atten_context", (score, k, dil),
          {"w": 1, "symmetric": False}, tol=RED, nojit=True)


def test_sliding_window_mask():
    score = values("float32", (2, 7, 3, 5), seed=21)
    dil = onp.array([1, 2, 1], "i4")
    for kw in ({"w": 2}, {"w": 1, "symmetric": False}):
        check("npx.sldwin_atten_mask_like",
              (score[..., :5 if kw["w"] == 2 else 2], dil,
               onp.array([5, 7], "i4")), kw, nojit=True)


def test_sliding_window_gradients():
    q, k, dil = _sldwin("float32", 22)
    kw = {"w": 2, "symmetric": True}
    t, j = grads("npx.sldwin_atten_score", (q, k, dil), kw, wrt=(0, 1))
    same(t, j, RED)
    score = values("float32", (2, 7, 3, 5), seed=24)
    t, j = grads("npx.sldwin_atten_context", (score, k, dil), kw,
                 wrt=(0, 1))
    same(t, j, RED)


def _hawkes(seed):
    rs = onp.random.RandomState(seed)
    N, K, T = 3, 2, 6
    lda = rs.uniform(0.5, 1.5, (N, K)).astype("f4")
    alpha = rs.uniform(0.1, 0.5, (K,)).astype("f4")
    beta = rs.uniform(0.5, 2.0, (K,)).astype("f4")
    state = rs.uniform(0, 1, (N, K)).astype("f4")
    lags = rs.uniform(0.1, 1.0, (N, T)).astype("f4")
    marks = rs.randint(0, K, (N, T)).astype("i4")
    vl = onp.array([6, 3, 0], "f4")
    mt = (lags.sum(1) + 0.5).astype("f4")
    return lda, alpha, beta, state, lags, marks, vl, mt


def test_hawkesll_values_and_gradients():
    args = _hawkes(25)
    check("npx.hawkesll", args, tol=RED)
    t, j = grads("npx.hawkesll", args, wrt=(0, 1, 2, 3), nojit=False)
    same(t, j, RED)


def test_identity_attach_kl_sparse_reg():
    x = values("float32", (4, 3, 2), lo=0.1, hi=0.9, seed=26)
    avg = values("float32", (6,), lo=0.2, hi=0.8, seed=27)
    for args, kw in (((x,), {}), ((x,), {"moving_avg": avg,
                                         "momentum": 0.8,
                                         "penalty": 0.01})):
        check("npx.identity_attach_kl_sparse_reg", args, kw, tol=RED,
              nojit=True)
        t, j = grads("npx.identity_attach_kl_sparse_reg", args, kw)
        same(t, j, RED)
