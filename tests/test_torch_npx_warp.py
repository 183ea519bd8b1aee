"""The port's warping ops (``ops/warp.py`` through ``mx.npx``:
``grid_generator``, ``bilinear_sampler``, ``spatial_transformer``,
``correlation``, ``count_sketch``) and the deformable convolutions
(``deformable_convolution``, ``modulated_deformable_convolution``)
against the JAX package's, on the CPU: values and the gradients of a
weighted sum, the same seeded inputs through both.

Tolerance: fp32 at rtol 1e-5, atol 1e-6 (``WARP``); the sampler's grid
gradient is checked where the sample points sit exactly on pixel
coordinates, where ``floor`` decides which two taps the gradient
differences."""
import numpy as onp
import pytest

import mxnet_tpu_torch as tmx

from test_torch_np_common import check, grads, same, values
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

WARP = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _theta(n, seed):
    rs = onp.random.RandomState(seed)
    base = onp.tile(onp.array([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], "f4"), (n, 1))
    return (base + rs.uniform(-0.3, 0.3, (n, 6))).astype("f4")


@pytest.mark.parametrize("transform", ["affine", "warp"])
def test_grid_generator(transform):
    if transform == "affine":
        args, kw = (_theta(2, 1),), {"target_shape": (5, 7)}
    else:
        args, kw = (values("float32", (2, 2, 5, 7), seed=2),), {}
    check("npx.grid_generator", args, dict(kw, transform_type=transform),
          tol=WARP, nojit=True)
    t, j = grads("npx.grid_generator", args, dict(kw,
                                                  transform_type=transform))
    same(t, j, WARP)


def test_bilinear_sampler_values_and_gradients():
    """Points inside, on the border and outside the image (each tap
    reads 0 outside)."""
    data = values("float32", (2, 3, 5, 6), seed=3)
    grid = values("float32", (2, 2, 4, 5), lo=-1.3, hi=1.3, seed=4)
    check("npx.bilinear_sampler", (data, grid), tol=WARP, nojit=True)
    t, j = grads("npx.bilinear_sampler", (data, grid), wrt=(0, 1))
    same(t, j, WARP)


def test_bilinear_sampler_grid_gradient_at_integer_coordinates():
    """Sample points exactly on pixels (x = i * 2 / (W - 1) - 1): the
    reference's gradient takes the tap to the right (below)."""
    data = values("float32", (1, 2, 5, 5), seed=5)
    ax = onp.array([-1.0, -0.5, 0.0, 0.5, 1.0], "f4")
    gx, gy = onp.meshgrid(ax, ax[::-1])
    grid = onp.stack([gx, gy])[None].astype("f4")
    t, j = grads("npx.bilinear_sampler", (data, grid), wrt=(0, 1))
    same(t, j, WARP)


def test_spatial_transformer():
    data = values("float32", (2, 3, 6, 5), seed=6)
    loc = _theta(2, 7)
    kw = {"target_shape": (4, 5)}
    check("npx.spatial_transformer", (data, loc), kw, tol=WARP, nojit=True)
    t, j = grads("npx.spatial_transformer", (data, loc), kw, wrt=(0, 1))
    same(t, j, WARP)


def test_correlation():
    """A 3 x 3 patch, strided and padded, as absolute differences; then
    the product form at 1 x 1."""
    a = values("float32", (2, 3, 7, 6), seed=8)
    b = values("float32", (2, 3, 7, 6), seed=9)
    kw = dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
              pad_size=2, is_multiply=False)
    t, j = grads("npx.correlation", (a, b), kw, wrt=(0, 1))
    same(t, j, WARP)
    check("npx.correlation", (a, b), dict(max_displacement=1), tol=WARP,
          nojit=True)


def test_count_sketch():
    data = values("float32", (3, 8), seed=10)
    h = onp.array([0, 2, 2, 4, 1, 0, 3, 2], "f4")
    s = onp.array([1, -1, 1, 1, -1, 1, -1, 1], "f4")
    check("npx.count_sketch", (data, h, s, 5), tol=WARP, nojit=True)
    t, j = grads("npx.count_sketch", (data, h, s, 5))
    same(t, j, WARP)


def _deform_inputs(G, k, seed, out=(6, 5)):
    """Data (2, 4, 6, 5), offsets and masks over the ``out`` map, the
    weights of k x k taps and a bias."""
    x = values("float32", (2, 4, 6, 5), seed=seed)
    off = values("float32", (2, 2 * G * k * k) + out, lo=-1.5, hi=1.5,
                 seed=seed + 1)
    w = values("float32", (3, 4, k, k), seed=seed + 2)
    b = values("float32", (3,), seed=seed + 3)
    m = values("float32", (2, G * k * k) + out, lo=0.0, hi=1.0,
               seed=seed + 4)
    return x, off, w, b, m


def test_deformable_convolution():
    """3 x 3 taps, strided, without a bias (the modulated case below
    has one)."""
    x, off, w, _, _ = _deform_inputs(1, 3, 11)
    check("npx.deformable_convolution", (x, off[:, :, ::2, ::2], w),
          dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)), tol=WARP)


def test_modulated_deformable_convolution_gradients():
    """Two deformable groups of 2 x 2 taps, modulated, with the
    gradients of the data, the offsets, the masks and the weights (the
    unmodulated form is this code without the mask)."""
    x, off, w, b, m = _deform_inputs(2, 2, 21, out=(7, 6))
    kw = dict(kernel=(2, 2), pad=(1, 1), num_deformable_group=2, bias=b)
    t, j = grads("npx.modulated_deformable_convolution", (x, off, m, w), kw,
                 wrt=(0, 1, 2, 3), nojit=False)
    same(t, j, WARP)
