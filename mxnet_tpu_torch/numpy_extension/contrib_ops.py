"""The contrib operators of ``mx.npx`` (the port of
``mxnet_tpu/numpy_extension/contrib_ops.py``): the interleaved
multi-head attention products, the bounding-box family, the spatial
ops (LRN, adaptive average pooling, bilinear resize, depth/space moves,
im2col/col2im), the sliding-window attention, ROIAlign, the Hawkes log
likelihood, the warping ops, the RPN proposal, the deformable
convolutions and PS-ROI pooling, and the small helpers (``moments``,
``khatri_rao``, ``index_copy``, ``quadratic``, ``stop_gradient``,
``constraint_check``, ``identity_attach_kl_sparse_reg``).

The reference computes every one of them with ``jnp``/``lax`` outside
any Pallas kernel, so here they are ATen calls over ``ops/detection.py``
and ``ops/warp.py``, each through ``ops.apply_op`` on the device of its
inputs. Float products (``einsum`` in the reference) run as fp32
products with TF32 off on the card in both passes (``ops.nn.fp32_matmul``);
integer and bool products take the exact int64 route of ``mx.np``.
Moves of uint16/uint32 data run on the signed type of their width and
their arithmetic in int64, as the rest of ``npx`` does: the card's
kernels refuse those types.
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F

from ..base import UNSIGNED, WIDE_UNSIGNED, default_float, float_input
from ..ndarray.ndarray import _SIGNED_VIEW, _signed_view
from ..ops import apply_op
from ..ops import detection as _det
from ..ops import warp as _warp
from ..ops.nn import fp32_matmul

__all__ = [
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "div_sqrt_dim", "box_iou", "box_nms", "box_encode", "box_decode",
    "bipartite_matching", "multibox_target", "multibox_detection", "lrn",
    "adaptive_avg_pool2d", "bilinear_resize2d", "depth_to_space",
    "space_to_depth", "im2col", "col2im", "moments", "khatri_rao",
    "index_copy", "quadratic", "stop_gradient", "constraint_check",
    "sldwin_atten_score", "sldwin_atten_mask_like", "sldwin_atten_context",
    "roi_align", "hawkesll", "rroi_align", "identity_attach_kl_sparse_reg",
    "grid_generator", "bilinear_sampler", "spatial_transformer",
    "correlation", "count_sketch", "proposal", "multi_proposal",
    "deformable_convolution", "deformable_psroi_pooling",
    "modulated_deformable_convolution"]


def _c(x):
    from ..numpy import _lift
    return None if x is None else _lift(x)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _product(a, b):
    """``a @ b`` in the operands' promoted type: floats as an fp32 (or
    wider) product without TF32, integers and bools exactly."""
    res = torch.promote_types(a.dtype, b.dtype)
    if res.is_floating_point:
        return fp32_matmul(a.to(res), b.to(res))
    from ..numpy import _matmul
    return _matmul(a, b)


def _wide(tfn):
    """``tfn`` of one tensor computed in int64 for a uint16/32 input
    (the card refuses their arithmetic), cast back."""
    def f(x, *args):
        if x.dtype not in WIDE_UNSIGNED:
            return tfn(x, *args)
        return tfn(x.to(torch.int64), *args).to(x.dtype)
    return f


# ---------------------------------------------------------------------------
# transformer interleaved-projection attention products
# ---------------------------------------------------------------------------
def _scaled(q, dh):
    return float_input(q) / math.sqrt(dh)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads, **kwargs):
    """Scaled Q K^T over interleaved QKV projections: (L, B, H*Dh*3) ->
    (B*H, L, L); Q is scaled by 1/sqrt(Dh) first."""
    def fn(qkv):
        L, B, _ = qkv.shape
        t = qkv.reshape(L, B, heads, 3, -1)
        dh = t.shape[-1]
        q = t[:, :, :, 0, :].permute(1, 2, 0, 3)
        k = t[:, :, :, 1, :].permute(1, 2, 0, 3)
        s = _product(_scaled(q, dh), k.transpose(-1, -2))
        return s.reshape(B * heads, L, L)
    return apply_op(fn, _c(queries_keys_values),
                    name="interleaved_matmul_selfatt_qk")


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads,
                                      **kwargs):
    """attention V over interleaved QKV: (L, B, H*Dh*3) and (B*H, L, L)
    -> (L, B, H*Dh)."""
    def fn(qkv, att):
        L, B, _ = qkv.shape
        t = qkv.reshape(L, B, heads, 3, -1)
        dh = t.shape[-1]
        v = t[:, :, :, 2, :].permute(1, 2, 0, 3)
        o = _product(att.reshape(B, heads, L, L), v)
        return o.permute(2, 0, 1, 3).reshape(L, B, heads * dh)
    return apply_op(fn, _c(queries_keys_values), _c(attention),
                    name="interleaved_matmul_selfatt_valatt")


def interleaved_matmul_encdec_qk(queries, keys_values, heads, **kwargs):
    """Encoder-decoder scores: queries (Lq, B, H*Dh), keys_values
    (Lk, B, H*Dh*2) -> (B*H, Lq, Lk)."""
    def fn(q, kv):
        Lq, B, E = q.shape
        Lk = kv.shape[0]
        dh = E // heads
        qh = q.reshape(Lq, B, heads, dh).permute(1, 2, 0, 3)
        kh = kv.reshape(Lk, B, heads, 2, dh)[:, :, :, 0, :] \
            .permute(1, 2, 0, 3)
        s = _product(_scaled(qh, dh), kh.transpose(-1, -2))
        return s.reshape(B * heads, Lq, Lk)
    return apply_op(fn, _c(queries), _c(keys_values),
                    name="interleaved_matmul_encdec_qk")


def interleaved_matmul_encdec_valatt(keys_values, attention, heads,
                                     **kwargs):
    """Encoder-decoder attention V: keys_values (Lk, B, H*Dh*2),
    attention (B*H, Lq, Lk) -> (Lq, B, H*Dh)."""
    def fn(kv, att):
        Lk, B, _ = kv.shape
        t = kv.reshape(Lk, B, heads, 2, -1)
        dh = t.shape[-1]
        v = t[:, :, :, 1, :].permute(1, 2, 0, 3)
        o = _product(att.reshape(B, heads, -1, Lk), v)
        return o.permute(2, 0, 1, 3).reshape(-1, B, heads * dh)
    return apply_op(fn, _c(keys_values), _c(attention),
                    name="interleaved_matmul_encdec_valatt")


def div_sqrt_dim(data, **kwargs):
    """x / sqrt(x.shape[-1])."""
    return apply_op(lambda x: float_input(x) / math.sqrt(x.shape[-1]),
                    _c(data), name="div_sqrt_dim")


# ---------------------------------------------------------------------------
# bounding-box family
# ---------------------------------------------------------------------------
def box_iou(lhs, rhs, format="corner", **kwargs):
    return apply_op(lambda a, b: _det.box_iou(a, b, fmt=format),
                    _c(lhs), _c(rhs), name="box_iou")


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner",
            **kwargs):
    return apply_op(
        lambda x: _det.box_nms(
            x, overlap_thresh=overlap_thresh, valid_thresh=valid_thresh,
            topk=topk, coord_start=coord_start, score_index=score_index,
            id_index=id_index, background_id=background_id,
            force_suppress=force_suppress, in_format=in_format),
        _c(data), name="box_nms")


def box_encode(samples, matches, anchors, refs, means=(0.0, 0.0, 0.0, 0.0),
               stds=(0.1, 0.1, 0.2, 0.2), **kwargs):
    return apply_op(
        lambda s, m, a, r: _det.box_encode(s, m, a, r, means, stds),
        _c(samples), _c(matches), _c(anchors), _c(refs), name="box_encode")


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner", **kwargs):
    return apply_op(
        lambda d, a: _det.box_decode(d, a, stds=(std0, std1, std2, std3),
                                     clip=clip, fmt=format),
        _c(data), _c(anchors), name="box_decode")


def bipartite_matching(data, threshold, is_ascend=False, topk=-1, **kwargs):
    return apply_op(
        lambda s: _det.bipartite_matching(s, threshold, is_ascend=is_ascend,
                                          topk=topk),
        _c(data), name="bipartite_matching")


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2), **kwargs):
    return apply_op(
        lambda a, l, c: _det.multibox_target(
            a, l, c, overlap_threshold=overlap_threshold,
            ignore_label=ignore_label,
            negative_mining_ratio=negative_mining_ratio,
            negative_mining_thresh=negative_mining_thresh,
            minimum_negative_samples=minimum_negative_samples,
            variances=variances),
        _c(anchor), _c(label), _c(cls_pred), name="multibox_target")


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1, **kwargs):
    return apply_op(
        lambda c, l, a: _det.multibox_detection(
            c, l, a, clip=clip, threshold=threshold,
            background_id=background_id, nms_threshold=nms_threshold,
            force_suppress=force_suppress, variances=variances,
            nms_topk=nms_topk),
        _c(cls_prob), _c(loc_pred), _c(anchor), name="multibox_detection")


# ---------------------------------------------------------------------------
# spatial ops
# ---------------------------------------------------------------------------
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kwargs):
    """Cross-channel local response normalization over NCHW:
    x / (k + alpha / n * sum of the window's x^2)^beta."""
    def fn(x):
        x = float_input(x)
        sq = x * x
        pad = nsize // 2
        padded = F.pad(sq, (0, 0, 0, 0, pad, pad))
        win = padded[:, 0:x.shape[1]]
        for i in range(1, nsize):
            win = win + padded[:, i:i + x.shape[1]]
        return x / torch.pow(knorm + alpha / nsize * win, beta)
    return apply_op(fn, _c(data), name="lrn")


def adaptive_avg_pool2d(data, output_size=1, **kwargs):
    """NCHW adaptive average pooling: each output cell averages its
    [floor(i H / h), ceil((i + 1) H / h)) window, through an integral
    image."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else (output_size[0], output_size[-1])

    def edges(n_in, n_out, dev):
        i = torch.arange(n_out, device=dev)
        return (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)

    def fn(x):
        _, _, H, W = x.shape
        dt = x.dtype
        if not dt.is_floating_point:
            x = x.to(torch.int64)
        ii = torch.cumsum(torch.cumsum(x, dim=2), dim=3)
        ii = F.pad(ii, (1, 0, 1, 0))
        ylo, yhi = edges(H, oh, x.device)
        xlo, xhi = edges(W, ow, x.device)
        a = ii[:, :, yhi[:, None], xhi[None, :]]
        b = ii[:, :, ylo[:, None], xhi[None, :]]
        c = ii[:, :, yhi[:, None], xlo[None, :]]
        d = ii[:, :, ylo[:, None], xlo[None, :]]
        counts = ((yhi - ylo)[:, None] * (xhi - xlo)[None, :]).to(
            torch.int64 if dt in WIDE_UNSIGNED else dt)
        return (a - b - c + d) / counts
    return apply_op(fn, _c(data), name="adaptive_avg_pool2d")


def _resize_weights(n_in, n_out, device):
    """``jax.image.resize``'s linear weights of one axis, (n_in, n_out):
    the triangle kernel at half-pixel sample points, widened by the
    downscale factor (antialiasing), normalized, 0 for a sample outside
    the input."""
    f32 = torch.float32
    inv_scale = float(onp.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = (1.0 - x.abs()).clamp(min=0.0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(onp.finfo(onp.float32).eps),
                    w / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def bilinear_resize2d(data, height=None, width=None, scale_height=None,
                      scale_width=None, mode="size", **kwargs):
    """NCHW bilinear resize, as ``jax.image.resize(..., "linear")``:
    half-pixel centres, antialiased when shrinking; an integer or bool
    input resizes in the default float."""
    def fn(x):
        _, _, H, W = x.shape
        h = int(height) if height else int(round(H * scale_height))
        w = int(width) if width else int(round(W * scale_width))
        if not x.dtype.is_floating_point:
            x = x.to(default_float())
        out = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        if w != W:
            out = fp32_matmul(out, _resize_weights(W, w, x.device)
                              .to(out.dtype))
        if h != H:
            out = fp32_matmul(_resize_weights(H, h, x.device).T
                              .to(out.dtype), out)
        return out.to(x.dtype)
    return apply_op(fn, _c(data), name="bilinear_resize2d")


def depth_to_space(data, block_size, **kwargs):
    """(N, C b^2, H, W) -> (N, C, H b, W b), DCR order."""
    b = int(block_size)

    @_signed_view
    def fn(x):
        N, C, H, W = x.shape
        c = C // (b * b)
        y = x.reshape(N, b, b, c, H, W).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(N, c, H * b, W * b)
    return apply_op(fn, _c(data), name="depth_to_space")


def space_to_depth(data, block_size, **kwargs):
    """(N, C, H b, W b) -> (N, C b^2, H, W), the inverse of
    ``depth_to_space``."""
    b = int(block_size)

    @_signed_view
    def fn(x):
        N, C, Hb, Wb = x.shape
        h, w = Hb // b, Wb // b
        y = x.reshape(N, C, h, b, w, b).permute(0, 3, 5, 1, 2, 4)
        return y.reshape(N, C * b * b, h, w)
    return apply_op(fn, _c(data), name="space_to_depth")


def _conv_geometry(kernel, stride, dilate, pad):
    return _pair(kernel), _pair(stride), _pair(dilate), _pair(pad)


def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0),
           **kwargs):
    """Sliding-window patches, NCHW -> (N, C kh kw, L) with channels in
    (C, kh, kw) order and L = out_h out_w."""
    (kh, kw), (sh, sw), (dh, dw), (ph, pw) = _conv_geometry(
        kernel, stride, dilate, pad)

    @_signed_view
    def fn(x):
        N, C, H, W = x.shape
        xp = x.new_zeros((N, C, H + 2 * ph, W + 2 * pw))
        xp[:, :, ph:ph + H, pw:pw + W] = x
        p = xp.unfold(2, dh * (kh - 1) + 1, sh) \
            .unfold(3, dw * (kw - 1) + 1, sw)[..., ::dh, ::dw]
        return p.permute(0, 1, 4, 5, 2, 3).reshape(N, C * kh * kw, -1)
    return apply_op(fn, _c(data), name="im2col")


def col2im(data, output_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0), **kwargs):
    """The sum-inverse of ``im2col``: (N, C kh kw, L) -> (N, C, H, W);
    each kernel offset's columns add onto one strided view of the
    output, in order, so sums are exact for integers and in a fixed
    order for floats. Bool data raises, as in the reference."""
    (kh, kw), (sh, sw), (dh, dw), (ph, pw) = _conv_geometry(
        kernel, stride, dilate, pad)
    H, W = _pair(output_size)

    @_wide
    def fn(x):
        if x.dtype == torch.bool:
            raise TypeError("col2im sums its columns: bool data has no add "
                            "(as in the reference)")
        N = x.shape[0]
        C = x.shape[1] // (kh * kw)
        oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        cols = x.reshape(N, C, kh, kw, oh, ow)
        out = x.new_zeros((N, C, H + 2 * ph, W + 2 * pw))
        for iy in range(kh):
            for ix in range(kw):
                y0, x0 = iy * dh, ix * dw
                view = out[:, :, y0:y0 + (oh - 1) * sh + 1:sh,
                           x0:x0 + (ow - 1) * sw + 1:sw]
                view += cols[:, :, iy, ix]
        return out[:, :, ph:ph + H, pw:pw + W]
    return apply_op(fn, _c(data), name="col2im")


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------
def moments(data, axes=None, keepdims=False, **kwargs):
    """(mean, variance) over ``axes`` in one op."""
    ax = tuple(axes) if axes is not None else None

    def fn(x):
        xf = float_input(x)
        mean = xf.mean(dim=ax, keepdim=keepdims)
        mk = mean if keepdims or ax is None else mean.reshape(
            [1 if i in [a % x.dim() for a in ax] else s
             for i, s in enumerate(x.shape)])
        var = ((xf - mk) ** 2).mean(dim=ax, keepdim=keepdims)
        return mean, var
    return apply_op(fn, _c(data), name="moments")


def khatri_rao(*matrices, **kwargs):
    """Column-wise Kronecker product: inputs (r_i, k) -> (prod r_i, k)."""
    def fn(*ms):
        res = ms[0].dtype
        for m in ms[1:]:
            res = torch.promote_types(res, m.dtype)
        wide = res in UNSIGNED or res == torch.bool
        out = ms[0].to(torch.int64 if wide else res)
        for m in ms[1:]:
            m = m.to(out.dtype)
            out = (out[:, None, :] * m[None, :, :]).reshape(
                -1, out.shape[-1])
        return out.to(res) if res != torch.bool else out.to(torch.bool)
    return apply_op(fn, *[_c(m) for m in matrices], name="khatri_rao")


def index_copy(old, index_vector, new_tensor, **kwargs):
    """``old`` with rows ``index_vector`` replaced by ``new_tensor``'s
    (cast to ``old``'s dtype; a negative index counts from the end)."""
    def fn(o, i, n):
        idx = i.to(torch.int64)
        idx = torch.where(idx < 0, idx + o.shape[0], idx)
        n = n if n.dtype == o.dtype else n.to(o.dtype)
        sv = _SIGNED_VIEW.get(o.dtype)
        if sv is None:
            return o.index_copy(0, idx, n)
        return o.view(sv).index_copy(0, idx, n.view(sv)).view(o.dtype)
    return apply_op(fn, _c(old), _c(index_vector), _c(new_tensor),
                    name="index_copy")


def quadratic(data, a=0.0, b=0.0, c=0.0, **kwargs):
    """a x^2 + b x + c."""
    return apply_op(lambda x: a * float_input(x) * float_input(x)
                    + b * float_input(x) + c, _c(data), name="quadratic")


def stop_gradient(data, **kwargs):
    """Identity forward, zero gradient (BlockGrad)."""
    return apply_op(lambda x: x.detach(), _c(data), name="stop_gradient")


def constraint_check(condition, msg="Constraint violated!", **kwargs):
    """Raise ``ValueError(msg)`` when any element of ``condition`` is
    false; else an all-true bool array of its shape."""
    def fn(c):
        if not bool(c.all()):
            raise ValueError(msg)
        return torch.ones_like(c, dtype=torch.bool)
    return apply_op(fn, _c(condition), name="constraint_check")


# ---------------------------------------------------------------------------
# sliding-window (Longformer) attention, ROIAlign, Hawkes
# ---------------------------------------------------------------------------
def _sldwin_idx(L, dilation, w, symmetric):
    """idx[i, h, j] = i + (j - w) * dilation[h] over the window's slots."""
    slots = 2 * w + 1 if symmetric else w + 1
    off = torch.arange(slots, device=dilation.device) - w
    idx = (torch.arange(L, device=dilation.device)[:, None, None]
           + off[None, None, :] * dilation[None, :, None])
    return idx, slots


def _window(x, idx):
    """x (B, L, H, D) at the window's rows: (B, L, H, S, D), and which
    slots fall inside the sequence (L, H, S)."""
    B, L, H, D = x.shape
    valid = (idx >= 0) & (idx < L)
    ci = idx.clamp(0, L - 1)
    heads = torch.arange(H, device=x.device)[None, :, None]
    return _signed_view(lambda t: t[:, ci, heads, :])(x), valid


def sldwin_atten_score(query, key, dilation, w=1, symmetric=True, **kwargs):
    """Banded attention scores: query/key (B, L, H, D), dilation (H,)
    -> (B, L, H, S), S = 2w + 1 (symmetric) or w + 1; out-of-range slots
    are 0."""
    def fn(q, k, d):
        idx, _ = _sldwin_idx(q.shape[1], d.to(torch.int64), w, symmetric)
        kg, valid = _window(k, idx)
        s = _product(q[..., None, :], kg.transpose(-1, -2))[..., 0, :]
        return torch.where(valid[None], s, 0.0)
    return apply_op(fn, _c(query), _c(key), _c(dilation),
                    name="sldwin_atten_score")


def sldwin_atten_mask_like(score, dilation, valid_length, w=1,
                           symmetric=True, **kwargs):
    """0/1 mask of the window slots inside [0, valid_length[b]) whose
    row is inside it too."""
    def fn(s, d, vl):
        L = s.shape[1]
        idx, _ = _sldwin_idx(L, d.to(torch.int64), w, symmetric)
        vlb = vl.to(torch.int64)[:, None, None, None]
        ok = (idx[None] >= 0) & (idx[None] < vlb) & \
            (torch.arange(L, device=s.device)[None, :, None, None] < vlb)
        return ok.to(s.dtype)
    return apply_op(fn, _c(score), _c(dilation), _c(valid_length),
                    name="sldwin_atten_mask_like")


def sldwin_atten_context(score, value, dilation, w=1, symmetric=True,
                         **kwargs):
    """Banded attention context: score (B, L, H, S), value (B, L, H, D)
    -> (B, L, H, D)."""
    def fn(s, v, d):
        idx, _ = _sldwin_idx(v.shape[1], d.to(torch.int64), w, symmetric)
        vg, valid = _window(v, idx)
        sm = torch.where(valid[None], s, 0.0)
        return _product(sm[..., None, :], vg)[..., 0, :]
    return apply_op(fn, _c(score), _c(value), _c(dilation),
                    name="sldwin_atten_context")


def _adaptive_ratio(rois, pooled_size, spatial_scale, extent):
    """The reference's grid for ``sample_ratio <= 0``: sized for the
    largest ROI, ceil(extent / pooled) clamped to [1, 16] (2 when there
    is no ROI). Reads the ROIs on the host, as the reference does."""
    r = rois.asnumpy()
    if not r.size:
        return 2
    ph, pw = _pair(pooled_size)
    eh, ew = extent(r)
    return int(min(16, max(1, math.ceil(max(eh * spatial_scale / ph,
                                            ew * spatial_scale / pw)))))


def roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False,
              **kwargs):
    """ROIAlign. ``sample_ratio <= 0`` takes one grid for all ROIs,
    sized for the largest one (the reference's rule)."""
    rois = _c(rois)
    if sample_ratio is None or sample_ratio <= 0:
        sample_ratio = _adaptive_ratio(
            rois, pooled_size, spatial_scale,
            lambda r: (float((r[:, 4] - r[:, 2]).max()),
                       float((r[:, 3] - r[:, 1]).max())))
    return apply_op(
        lambda d, r: _det.roi_align(
            d, r, pooled_size, spatial_scale=spatial_scale,
            sample_ratio=sample_ratio, position_sensitive=position_sensitive,
            aligned=aligned),
        _c(data), rois, name="roi_align")


def hawkesll(lda, alpha, beta, state, lags, marks, valid_length, max_time,
             **kwargs):
    """Log likelihood of a univariate (per-mark) Hawkes process with
    exponential decay: lda (N, K), alpha (K,), beta (K,), state (N, K),
    lags and marks (N, T), valid_length (N,), max_time (N,). Returns
    (loglike (N,), out_state (N, K)); the scan over T runs as a loop
    over T on the whole batch."""
    def fn(mu, a, b, st, lg, mk, vl, mt):
        N, T = lg.shape
        K = mu.shape[1]
        dt = lg.dtype
        ks = torch.arange(K, device=lg.device)
        ll = torch.zeros(N, dtype=dt, device=lg.device)
        t = torch.zeros(N, dtype=dt, device=lg.device)
        last = torch.zeros((N, K), dtype=dt, device=lg.device)
        mk = mk.to(torch.int64)
        for j in range(T):
            ci = mk[:, j]
            hot = ks[None, :] == ci[:, None]
            active = j < vl
            t2 = t + lg[:, j]
            st_c = st.gather(1, ci[:, None])[:, 0]
            mu_c = mu.gather(1, ci[:, None])[:, 0]
            a_c, b_c = a[ci], b[ci]
            d = t2 - last.gather(1, ci[:, None])[:, 0]
            ed = torch.exp(-b_c * d)
            lda_t = mu_c + a_c * b_c * st_c * ed
            comp = mu_c * d + a_c * st_c * (1 - ed)
            ll = torch.where(active, ll + torch.log(lda_t) - comp, ll)
            upd = hot & active[:, None]
            st = torch.where(upd, (1 + st_c * ed)[:, None], st)
            last = torch.where(upd, t2[:, None], last)
            t = torch.where(active, t2, t)
        d = mt[:, None] - last
        ed = torch.exp(-b[None] * d)
        rem = mu * d + a[None] * st * (1 - ed)
        return ll - rem.sum(1), st * ed
    return apply_op(fn, _c(lda), _c(alpha), _c(beta), _c(state), _c(lags),
                    _c(marks), _c(valid_length), _c(max_time),
                    name="hawkesll")


def rroi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sampling_ratio=-1, **kwargs):
    """Rotated ROIAlign; ``sampling_ratio <= 0`` takes one grid sized
    for the largest ROI, as the reference does."""
    rois = _c(rois)
    if sampling_ratio is None or sampling_ratio <= 0:
        sampling_ratio = _adaptive_ratio(
            rois, pooled_size, spatial_scale,
            lambda r: (float(r[:, 4].max()), float(r[:, 3].max())))
    return apply_op(
        lambda d, r: _det.rroi_align(d, r, pooled_size,
                                     spatial_scale=spatial_scale,
                                     sampling_ratio=sampling_ratio),
        _c(data), rois, name="rroi_align")


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL sparsity penalty
    ``penalty * (-t / rho + (1 - t) / (1 - rho))`` of each unit, rho its
    mean activation over the batch, blended with ``moving_avg`` by
    ``momentum`` when one is given."""

    @staticmethod
    def forward(ctx, x, avg, t, pen, mom):
        batch_mean = x.reshape(x.shape[0], -1).mean(0)
        rho = batch_mean if avg is None else \
            mom * avg.reshape(-1) + (1 - mom) * batch_mean
        ctx.save_for_backward(rho)
        ctx.hyper = (t, pen)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        t, pen = ctx.hyper
        kl = pen * (-t / rho + (1 - t) / (1 - rho))
        return (g + kl.reshape((1,) + tuple(g.shape[1:])), None, None, None,
                None)


def identity_attach_kl_sparse_reg(data, sparseness_target=0.1, penalty=0.001,
                                  momentum=0.9, moving_avg=None, **kwargs):
    """Identity forward with a KL sparsity penalty added to the
    gradient (the caller passes the previous ``moving_avg``, or None for
    the batch mean alone)."""
    t, pen, mom = (float(sparseness_target), float(penalty),
                   float(momentum))
    args = [_c(data)] + ([] if moving_avg is None else [_c(moving_avg)])

    def fn(x, avg=None):
        return _KLSparseReg.apply(x, avg, t, pen, mom)
    return apply_op(fn, *args, name="identity_attach_kl_sparse_reg")


# ---------------------------------------------------------------------------
# spatial warping family
# ---------------------------------------------------------------------------
def grid_generator(data, transform_type="affine", target_shape=None,
                   **kwargs):
    return apply_op(
        lambda d: _warp.grid_generator(
            d, transform_type, tuple(target_shape) if target_shape
            else None), _c(data), name="grid_generator")


def bilinear_sampler(data, grid, **kwargs):
    return apply_op(_warp.bilinear_sampler, _c(data), _c(grid),
                    name="bilinear_sampler")


def spatial_transformer(data, loc, target_shape=None,
                        transform_type="affine", sampler_type="bilinear",
                        **kwargs):
    return apply_op(
        lambda d, l: _warp.spatial_transformer(
            d, l, tuple(target_shape), transform_type, sampler_type),
        _c(data), _c(loc), name="spatial_transformer")


def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True, **kwargs):
    return apply_op(
        lambda a, b: _warp.correlation(
            a, b, kernel_size=kernel_size,
            max_displacement=max_displacement, stride1=stride1,
            stride2=stride2, pad_size=pad_size, is_multiply=is_multiply),
        _c(data1), _c(data2), name="correlation")


def count_sketch(data, h, s, out_dim, **kwargs):
    return apply_op(lambda d, hh, ss: _warp.count_sketch(d, hh, ss, out_dim),
                    _c(data), _c(h), _c(s), name="count_sketch")


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16, **kwargs):
    """RPN proposals: (B * post_nms, 5) rows [batch_idx, x1, y1, x2,
    y2]."""
    return apply_op(
        lambda c, b, i: _det.proposal(
            c, b, i, rpn_pre_nms_top_n=rpn_pre_nms_top_n,
            rpn_post_nms_top_n=rpn_post_nms_top_n, threshold=threshold,
            rpn_min_size=rpn_min_size, scales=scales, ratios=ratios,
            feature_stride=feature_stride),
        _c(cls_prob), _c(bbox_pred), _c(im_info), name="proposal")


#: the batched variant is the batch path here, as in the reference
multi_proposal = proposal


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(1, 1), dilate=(1, 1),
                           num_deformable_group=1, mask=None, **kwargs):
    """Deformable ConvNets v1: each kernel tap samples the input
    (bilinearly, ``ops.warp.bilinear_sampler``) at its regular position
    plus a learned offset, and the samples contract with the weights as
    a convolution's patches do (an fp32 product). data (B, C, H, W),
    offset (B, 2 G kh kw, oh, ow) as (dy, dx) per tap per deformable
    group, weight (O, C, kh, kw). With ``mask`` (B, G kh kw, oh, ow),
    the v2 modulated form."""
    kh, kw = kernel
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(pad), _pair(dilate)
    G = num_deformable_group

    def fn(x, off, w, *rest):
        rest = list(rest)
        m = rest.pop(0) if mask is not None else None
        b = rest.pop(0) if rest else None
        B, C, H, W = x.shape
        O = w.shape[0]
        oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        xpad = F.pad(x, (pw, pw, ph, ph))
        Hp, Wp = H + 2 * ph, W + 2 * pw
        base_y = torch.arange(oh, device=x.device) * sh
        base_x = torch.arange(ow, device=x.device) * sw
        off = off.reshape(B, G, kh * kw, 2, oh, ow)
        if m is not None:
            m = m.reshape(B, G, kh * kw, oh, ow)
        xg = xpad.reshape(B * G, C // G, Hp, Wp)
        cols = []
        for t in range(kh * kw):
            iy, ix = divmod(t, kw)
            yy = base_y[:, None] + iy * dh + off[:, :, t, 0]
            xx = base_x[None, :] + ix * dw + off[:, :, t, 1]
            gy = 2.0 * yy / max(Hp - 1, 1) - 1.0
            gx = 2.0 * xx / max(Wp - 1, 1) - 1.0
            grid = torch.stack([gx, gy], 2).reshape(B * G, 2, oh, ow)
            smp = _warp.bilinear_sampler(xg, grid)
            if m is not None:
                smp = smp * m[:, :, t].reshape(B * G, 1, oh, ow)
            cols.append(smp.reshape(B, C, oh, ow))
        col = torch.stack(cols, 2).reshape(B, C * kh * kw, oh * ow)
        wt = w.reshape(O, C * kh * kw)
        out = _product(wt, col).reshape(B, O, oh, ow)
        if b is not None:
            out = out + b.reshape(1, -1, 1, 1)
        return out

    args = [_c(data), _c(offset), _c(weight)]
    if mask is not None:
        args.append(_c(mask))
    if bias is not None:
        args.append(_c(bias))
    return apply_op(fn, *args, name="deformable_convolution")


def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     kernel=(3, 3), stride=(1, 1),
                                     pad=(1, 1), dilate=(1, 1),
                                     num_deformable_group=1, **kwargs):
    """Deformable ConvNets v2: ``deformable_convolution`` with each
    sampled patch scaled by its modulation scalar."""
    return deformable_convolution(
        data, offset, weight, bias=bias, kernel=kernel, stride=stride,
        pad=pad, dilate=dilate, num_deformable_group=num_deformable_group,
        mask=mask)


def deformable_psroi_pooling(data, rois, trans, spatial_scale=1.0,
                             output_dim=1, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False, **kwargs):
    return apply_op(
        lambda d, r, t: _det.deformable_psroi_pooling(
            d, r, t, spatial_scale, output_dim, group_size, pooled_size,
            part_size=part_size, sample_per_part=sample_per_part,
            trans_std=trans_std, no_trans=no_trans),
        _c(data), _c(rois), _c(trans), name="deformable_psroi_pooling")
