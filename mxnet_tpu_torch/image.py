"""Image helpers (the start of the port of ``mxnet_tpu/image.py``):
``imresize``, ``fixed_crop``, ``center_crop``, ``rotate_bilinear``
and the HSV round trip of ``RandomHue`` (``rgb_to_hsv``,
``hsv_to_rgb``).

The reference resizes, rotates and converts through PIL. The card's
machine has no PIL, so these reproduce PIL's arithmetic in torch, on
the image's own device, and never import it:

- ``imresize`` is PIL's two-pass resampling of 8-bit images
  (``Resample.c``): per output pixel a filter window (the triangle for
  bilinear, Keys' cubic with a = -0.5, Lanczos-3, widened by the scale
  when shrinking, so a shrink is antialiased), its weights normalized
  and turned into 22-bit fixed point, the horizontal pass first, each
  pass rounding to uint8. The weights are built on the host in float64
  as PIL builds them; a pass is one float64 product, whose sums of
  integer products are exact. Nearest neighbour is PIL's scale-affine
  index walk.
- ``rotate_bilinear`` is ``Image.rotate(deg, BILINEAR)``: the affine
  map about the centre with PIL's rounded matrix, bilinear taps with
  clamped edges, 0 outside, truncation to uint8; the quarter and half
  turns PIL makes exact transposes are exact here too.
- ``rgb_to_hsv``/``hsv_to_rgb`` follow ``Convert.c`` (float and double
  steps where it has them, rounding half away from zero).

Every other name of the reference's ``image`` module (``imread``,
``imdecode``, the augmenters, ``ImageIter``) is ROADMAP.md queue 1,
item 17b.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import not_ported

__all__ = ["imresize", "fixed_crop", "center_crop", "rotate_bilinear",
           "rgb_to_hsv", "hsv_to_rgb"]

_PRECISION_BITS = 32 - 8 - 2
_NEAREST, _BILINEAR, _BICUBIC, _LANCZOS = 0, 2, 3, 1


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise not_ported(f"image.{name}", "17b")


def _split(src):
    """(tensor, context or None) of an NDArray, a tensor or an array."""
    if torch.is_tensor(src):
        return src, None
    if hasattr(src, "_data") and hasattr(src, "ctx"):
        return src._data, src.ctx
    return torch.from_numpy(onp.ascontiguousarray(onp.asarray(src))), None


def _wrap(t, ctx):
    """An NDArray of ``t`` on ``ctx`` (the current context for an input
    that had none)."""
    from .context import current_context
    from .ndarray.ndarray import NDArray
    ctx = ctx or current_context()
    return NDArray(t.to(ctx.torch_device), ctx=ctx)


def _as_uint8(t):
    """``astype(uint8)`` as numpy does it (floats truncate)."""
    if t.dtype == torch.uint8:
        return t
    if t.is_floating_point():
        t = torch.trunc(t)
    return t.to(torch.int64).remainder(256).to(torch.uint8)


def _bilinear_filter(x):
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic_filter(x):
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x):
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_filter(x):
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3.0)
    return 0.0


_FILTERS = {_BILINEAR: (_bilinear_filter, 1.0),
            _BICUBIC: (_bicubic_filter, 2.0),
            _LANCZOS: (_lanczos_filter, 3.0)}


def _coeffs(in_size, out_size, filt):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: the
    (out_size, in_size) matrix of 22-bit fixed-point weights."""
    fn, support = _FILTERS[filt]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ss = 1.0 / filterscale
    k = onp.zeros((out_size, in_size), onp.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            k[xx, xmin + x] = w / ww if ww != 0.0 else w
    k = k * (1 << _PRECISION_BITS)
    return onp.where(k < 0, onp.trunc(k - 0.5), onp.trunc(k + 0.5))


def _pass(x, k, dim):
    """One 8-bit resampling pass along ``dim`` (0: rows, 1: columns) of
    an (H, W, C) uint8 tensor."""
    kt = torch.from_numpy(k).to(x.device)
    xd = x.to(torch.float64)
    acc = torch.einsum("oh,hwc->owc", kt, xd) if dim == 0 else \
        torch.einsum("ow,hwc->hoc", kt, xd)
    acc = acc + float(1 << (_PRECISION_BITS - 1))
    return torch.clamp(torch.floor(acc / float(1 << _PRECISION_BITS)),
                       0, 255).to(torch.uint8)


def _nearest_index(in_size, out_size):
    """PIL's ``ImagingScaleAffine`` walk: the source index of each
    output pixel (``xo`` accumulated step by step, as there)."""
    a0 = in_size / out_size
    xo = a0 * 0.5
    idx = []
    for _ in range(out_size):
        idx.append(-1 if xo < 0.0 else int(xo))
        xo += a0
    return idx


def _resize_u8(x, w, h, filt):
    """(H, W, C) uint8 -> (h, w, C) uint8 as PIL's ``Image.resize``."""
    H, W = x.shape[0], x.shape[1]
    if (H, W) == (h, w):
        return x.clone()
    if filt == _NEAREST:
        yi = torch.tensor(_nearest_index(H, h), device=x.device)
        xi = torch.tensor(_nearest_index(W, w), device=x.device)
        return x[yi][:, xi]
    if w != W:
        x = _pass(x, _coeffs(W, w, filt), 1)
    if h != H:
        x = _pass(x, _coeffs(H, h, filt), 0)
    return x


def imresize(src, w, h, interp=1):
    """Resize an HWC (or HW) image to ``w`` x ``h`` (parity:
    mx.image.imresize): interp 0 nearest, 1 bilinear, 2 bicubic, 3
    nearest, 4 Lanczos; computed in uint8 and cast back to the input's
    dtype, as the reference's PIL round trip does."""
    t, ctx = _split(src)
    dtype = t.dtype
    filt = {0: _NEAREST, 1: _BILINEAR, 2: _BICUBIC, 3: _NEAREST,
            4: _LANCZOS}.get(interp, _BILINEAR)
    x = _as_uint8(t)
    flat = x.dim() == 2
    if flat:
        x = x.unsqueeze(-1)
    out = _resize_u8(x, int(w), int(h), filt)
    if flat:
        out = out.squeeze(-1)
    return _wrap(out.to(dtype), ctx)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop ``w`` x ``h`` at (``x0``, ``y0``), then resize to ``size``
    when given and different."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    """Crop ``size`` = (w, h) at the centre (resized up when the image
    is smaller); returns (image, (x0, y0, w, h))."""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h),
                      size if (new_w > w or new_h > h) else None, interp), \
        (x0, y0, new_w, new_h)


def _rotate_u8(x, degrees):
    """(H, W, C) uint8 rotated ``degrees`` counter-clockwise about the
    centre, as PIL's ``Image.rotate(degrees, BILINEAR)``."""
    angle = degrees % 360.0
    H, W = x.shape[0], x.shape[1]
    if angle == 0:
        return x.clone()
    if angle == 180:
        return torch.flip(x, (0, 1))
    if angle in (90, 270) and W == H:
        return torch.rot90(x, 1 if angle == 90 else 3, (0, 1)).contiguous()
    cx, cy = W / 2, H / 2
    rad = -math.radians(angle)
    a, b, d, e = (round(math.cos(rad), 15), round(math.sin(rad), 15),
                  round(-math.sin(rad), 15), round(math.cos(rad), 15))
    c = a * (-cx) + b * (-cy)
    f = d * (-cx) + e * (-cy)
    c += cx
    f += cy
    dev = x.device
    xs = torch.arange(W, dtype=torch.float64, device=dev) + 0.5
    ys = torch.arange(H, dtype=torch.float64, device=dev) + 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    xin = a * xx + b * yy + c
    yin = d * xx + e * yy + f
    inside = (xin >= 0.0) & (xin < W) & (yin >= 0.0) & (yin < H)
    xin, yin = xin - 0.5, yin - 0.5
    x0f, y0f = torch.floor(xin), torch.floor(yin)
    dx, dy = (xin - x0f).unsqueeze(-1), (yin - y0f).unsqueeze(-1)
    xi, yi = x0f.to(torch.int64), y0f.to(torch.int64)
    xa, xb = xi.clamp(0, W - 1), (xi + 1).clamp(0, W - 1)
    ya, yb = yi.clamp(0, H - 1), (yi + 1).clamp(0, H - 1)
    src = x.to(torch.float64)
    top = src[ya, xa] + (src[ya, xb] - src[ya, xa]) * dx
    bot = src[yb, xa] + (src[yb, xb] - src[yb, xa]) * dx
    has_next = ((yi + 1 >= 0) & (yi + 1 < H)).unsqueeze(-1)
    v = torch.where(has_next, top + (bot - top) * dy, top)
    v = torch.where(inside.unsqueeze(-1), v, torch.zeros_like(v))
    return torch.trunc(v).to(torch.uint8)


def rotate_bilinear(src, degrees):
    """Rotate an HWC image ``degrees`` counter-clockwise (the
    reference's ``transforms.Rotate``: PIL's bilinear rotation in uint8,
    cast back to the input's dtype)."""
    t, ctx = _split(src)
    dtype = t.dtype
    x = _as_uint8(t)
    flat = x.dim() == 2
    if flat:
        x = x.unsqueeze(-1)
    out = _rotate_u8(x, float(degrees))
    if flat:
        out = out.squeeze(-1)
    return _wrap(out.to(dtype), ctx)


def _f32(t):
    return t.to(torch.float32)


def _round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _clip8(t):
    return torch.clamp(t, 0, 255).to(torch.uint8)


def rgb_to_hsv(rgb):
    """(..., 3) uint8 RGB -> uint8 HSV as PIL's ``convert("HSV")``."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    cr = _f32(maxc - minc)
    safe_cr = torch.where(cr == 0, torch.ones_like(cr), cr)
    s = cr / torch.where(maxc == 0, torch.ones_like(cr), _f32(maxc))
    rc, gc, bc = (_f32(maxc - c) / safe_cr for c in (r, g, b))
    h_r = bc - gc
    h_g = _f32((2.0 + rc.double()) - bc.double())
    h_b = _f32((4.0 + gc.double()) - rc.double())
    h = torch.where(r == maxc, h_r, torch.where(g == maxc, h_g, h_b))
    h = _f32(torch.fmod(h.double() / 6.0 + 1.0, 1.0))
    uh = _clip8(torch.trunc(h.double() * 255.0))
    us = _clip8(torch.trunc(s.double() * 255.0))
    same = minc == maxc
    uh = torch.where(same, torch.zeros_like(uh), uh)
    us = torch.where(same, torch.zeros_like(us), us)
    return torch.stack([uh, us, maxc.to(torch.uint8)], dim=-1)


def hsv_to_rgb(hsv):
    """(..., 3) uint8 HSV -> uint8 RGB as PIL's ``convert("RGB")``."""
    h, s, v = (hsv[..., i].to(torch.float64) for i in range(3))
    hd = h * 6.0 / 255.0
    i = torch.floor(hd)
    f = _f32(hd - i)
    fs = _f32(s / 255.0)
    p = _clip8(_round_half_away(v * (1.0 - fs.double())))
    q = _clip8(_round_half_away(v * (1.0 - (fs * f).double())))
    t = _clip8(_round_half_away(
        v * (1.0 - fs.double() * (1.0 - f.double()))))
    vv = hsv[..., 2]
    sector = i.to(torch.int64).remainder(6)
    table = [(vv, t, p), (q, vv, p), (p, vv, t), (p, q, vv), (t, p, vv),
             (vv, p, q)]
    out = torch.zeros(hsv.shape, dtype=torch.uint8, device=hsv.device)
    for k, chans in enumerate(table):
        m = sector == k
        for c in range(3):
            out[..., c] = torch.where(m, chans[c], out[..., c])
    grey = (hsv[..., 1] == 0).unsqueeze(-1)
    return torch.where(grey, vv.unsqueeze(-1).expand_as(out), out)
