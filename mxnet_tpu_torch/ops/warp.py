"""Spatial warping ops over plain tensors (the port of
``mxnet_tpu/ops/warp.py``): grid generation, bilinear sampling, the
spatial transformer, FlowNet correlation and the count sketch.

The reference computes all of them with ``jnp`` outside any Pallas
kernel, so here they are ATen calls. ``bilinear_sampler`` keeps the
reference's own four taps rather than ``F.grid_sample``: it maps
``[-1, 1]`` to ``[0, size - 1]`` (align-corners) with the reference's
arithmetic, reads 0 outside the image at each tap, and takes its
gradient through ``floor`` as the reference's autodiff does, so
values and gradients (the grid's at integer coordinates included) are
the reference's. ``count_sketch`` is an ``index_add``: on the card its
float sums use atomics, in no fixed order.
"""
from __future__ import annotations

import torch

from ..base import default_float
from .nn import fp32_matmul

__all__ = ["grid_generator", "bilinear_sampler", "spatial_transformer",
           "correlation", "count_sketch"]


def _linspace(n, device):
    """``jnp.linspace(-1.0, 1.0, n)`` with its arithmetic: in the default
    float, ``-1 * (1 - t) + 1 * t`` at ``t = i / (n - 1)``, the last
    point exactly 1."""
    dt = default_float()
    if n == 1:
        return torch.full((1,), -1.0, dtype=dt, device=device)
    t = torch.arange(n - 1, dtype=dt, device=device) / (n - 1)
    out = -1.0 * (1 - t) + 1.0 * t
    return torch.cat([out, torch.ones(1, dtype=dt, device=device)])


def _grid(H, W, device):
    ys, xs = _linspace(H, device), _linspace(W, device)
    return torch.meshgrid(ys, xs, indexing="ij")


def grid_generator(data, transform_type="affine", target_shape=None):
    """GridGenerator: ``'affine'`` takes (B, 6) affine parameters to a
    (B, 2, H, W) grid of normalized (x, y) over ``target_shape``;
    ``'warp'`` takes a (B, 2, H, W) pixel flow to the identity grid plus
    the normalized flow."""
    if transform_type == "affine":
        H, W = target_shape
        gy, gx = _grid(H, W, data.device)
        base = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
        dt = torch.promote_types(data.dtype, base.dtype)
        theta = data.reshape(-1, 2, 3).to(dt)
        return fp32_matmul(theta, base.to(dt)).reshape(-1, 2, H, W)
    if transform_type == "warp":
        _, _, H, W = data.shape
        gy, gx = _grid(H, W, data.device)
        fx = data[:, 0] * 2.0 / max(W - 1, 1)
        fy = data[:, 1] * 2.0 / max(H - 1, 1)
        return torch.stack([gx[None] + fx, gy[None] + fy], 1)
    raise ValueError(f"unknown transform_type {transform_type!r}")


def _taps(data, yi, xi):
    """``data`` (B, C, H, W) read at integer coordinates ``yi``/``xi``
    (B, ...) given as floats, 0 where a coordinate falls outside the
    image: (B, C, ...)."""
    B, C, H, W = data.shape
    inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    yc = yi.clamp(0, H - 1).to(torch.int64)
    xc = xi.clamp(0, W - 1).to(torch.int64)
    idx = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
    v = data.reshape(B, C, H * W).gather(2, idx)
    v = v.reshape((B, C) + tuple(yi.shape[1:]))
    return v * inside.to(data.dtype)[:, None]


def bilinear_sampler(data, grid):
    """BilinearSampler: ``data`` (B, C, H, W) sampled at ``grid``
    (B, 2, H', W') of normalized (x, y) in [-1, 1]; each of the four
    taps reads 0 outside the image."""
    _, _, H, W = data.shape
    x = (grid[:, 0] + 1.0) * (W - 1) / 2.0
    y = (grid[:, 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    g00 = _taps(data, y0, x0)
    g01 = _taps(data, y0, x0 + 1)
    g10 = _taps(data, y0 + 1, x0)
    g11 = _taps(data, y0 + 1, x0 + 1)
    return (g00 * (1 - wy) * (1 - wx) + g01 * (1 - wy) * wx +
            g10 * wy * (1 - wx) + g11 * wy * wx)


def spatial_transformer(data, loc, target_shape, transform_type="affine",
                        sampler_type="bilinear"):
    """SpatialTransformer: the affine grid generator, then the bilinear
    sampler."""
    assert transform_type == "affine" and sampler_type == "bilinear"
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


def correlation(data1, data2, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation: (B, D*D, outH, outW) with
    D = 2 * (max_displacement // stride2) + 1, each channel the
    kernel_size^2 patch correlation at one displacement, normalized by
    kernel_size^2 * C; channels row-major over (dy, dx)."""
    _, C, H, W = data1.shape
    dev = data1.device
    kr = kernel_size // 2
    border = max_displacement + kr
    pw = W + 2 * pad_size
    ph = H + 2 * pad_size
    out_w = -(-(pw - border * 2) // stride1)
    out_h = -(-(ph - border * 2) // stride1)
    rad = max_displacement // stride2
    sumelems = kernel_size * kernel_size * C
    pads = (pad_size,) * 4
    p1 = torch.nn.functional.pad(data1, pads)
    p2 = torch.nn.functional.pad(data2, pads)
    ys = torch.arange(out_h, device=dev) * stride1 + max_displacement
    xs = torch.arange(out_w, device=dev) * stride1 + max_displacement
    kk = torch.arange(-kr, kr + 1, device=dev)

    def at(img, dy, dx):
        yy = (ys[:, None] + kk[None, :] + dy).clamp(0, ph - 1)
        xx = (xs[:, None] + kk[None, :] + dx).clamp(0, pw - 1)
        return img[:, :, yy[:, None, :, None], xx[None, :, None, :]]

    a = at(p1, 0, 0)
    outs = []
    for dyi in range(-rad, rad + 1):
        for dxi in range(-rad, rad + 1):
            b = at(p2, dyi * stride2, dxi * stride2)
            v = a * b if is_multiply else (a - b).abs()
            outs.append(v.sum(dim=(1, 4, 5)) / sumelems)
    return torch.stack(outs, 1)


def count_sketch(data, h, s, out_dim):
    """Count sketch: ``data`` (N, D), ``h`` (D,) buckets in
    [0, out_dim), ``s`` (D,) signs -> (N, out_dim) with
    ``out[n, h[i]] += s[i] * data[n, i]``."""
    hi = h.reshape(-1).to(torch.int64)
    contrib = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hi, contrib)
