"""Convolution, pooling and pixel layers (the port of
``mxnet_tpu/gluon/nn/conv_layers.py``), over ``ops.nn``.

Each keeps the reference's constructor and its ``layout`` argument:
``NC*`` (weight ``(O, I/groups, *k)``) or channels-last ``N*C`` (weight
``(O, *k, I/groups)``); the transposed convolutions' weight is
``(I, O/groups, *k)`` (``(I, *k, O/groups)`` channels-last). A
channels-last 2-d convolution's weight carries the reference's
``_kernel_layout = "OHWI"`` tag. ``in_channels`` 0 is inferred at the
first forward. The products run in full fp32 on the card (cuDNN with
TF32 off, ``ops.nn``); the deformable convolutions sample and contract
as ``npx.deformable_convolution`` does.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ...ops import nn as _nn
from ..block import HybridBlock
from ..parameter import Parameter
from .basic_layers import Activation, _call_np

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D", "DeformableConvolution",
           "ModulatedDeformableConvolution"]


def _pair(v, n):
    if isinstance(v, (int, onp.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


class _Conv(HybridBlock):
    _tensor_forward = True

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="convolution", adj=None, dtype="float32"):
        super().__init__()
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._stride = strides
        self._pad = padding
        self._dilate = dilation
        self._groups = groups
        self._layout = layout
        self._op_name = op_name
        self._adj = adj
        if op_name == "convolution":
            i = in_channels // groups if in_channels else 0
            wshape = (channels, i) + kernel_size if layout.startswith("NC") \
                else (channels,) + kernel_size + (i,)
        else:
            o = channels // groups
            wshape = (in_channels, o) + kernel_size \
                if layout.startswith("NC") \
                else (in_channels,) + kernel_size + (o,)
        self.weight = Parameter("weight", shape=wshape, dtype=dtype,
                                init=weight_initializer,
                                allow_deferred_init=True)
        if op_name == "convolution" and len(kernel_size) == 2 \
                and not layout.startswith("NC"):
            self.weight._kernel_layout = "OHWI"
            self.weight._kernel_hw = tuple(kernel_size)
        self.bias = Parameter("bias", shape=(channels,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def _infer_weight(self, x):
        if self.weight._shape_known():
            return
        in_ch = x.shape[1 if self._layout.startswith("NC") else x.dim() - 1]
        shape = list(self.weight.shape)
        if self._op_name == "convolution":
            shape[1 if self._layout.startswith("NC") else -1] = \
                in_ch // self._groups
        else:
            shape[0] = in_ch
        self.weight._infer_shape(tuple(shape))
        self._in_channels = in_ch

    def forward(self, x):
        self._infer_weight(x)
        bias = None if self.bias is None else self.bias._read()
        if self._op_name == "convolution":
            out = _nn.convolution(x, self.weight._read(), bias, self._kernel,
                                  self._stride, self._dilate, self._pad,
                                  self._groups, self._layout)
        else:
            out = _nn.deconvolution(x, self.weight._read(), bias,
                                    self._stride, self._dilate, self._pad,
                                    self._adj or 0, self._groups, None,
                                    self._layout)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._in_channels or None} -> "
                f"{self._channels}, kernel_size={self._kernel}, "
                f"stride={self._stride}, padding={self._pad})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype=dtype)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype=dtype)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype=dtype)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 1), _pair(strides, 1),
                         _pair(padding, 1), _pair(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="deconvolution",
                         adj=_pair(output_padding, 1), dtype=dtype)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="deconvolution",
                         adj=_pair(output_padding, 2), dtype=dtype)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32"):
        super().__init__(channels, _pair(kernel_size, 3), _pair(strides, 3),
                         _pair(padding, 3), _pair(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="deconvolution",
                         adj=_pair(output_padding, 3), dtype=dtype)


class _Pooling(HybridBlock):
    _tensor_forward = True

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None):
        super().__init__()
        self._pool_size = pool_size
        self._strides = strides if strides is not None else pool_size
        self._padding = padding
        self._ceil_mode = ceil_mode
        self._global_pool = global_pool
        self._pool_type = pool_type
        self._layout = layout
        self._count_include_pad = count_include_pad

    def forward(self, x):
        return _nn.pooling(
            x, self._pool_size, self._pool_type, self._strides,
            self._padding, self._global_pool,
            "full" if self._ceil_mode else "valid",
            True if self._count_include_pad is None
            else self._count_include_pad, 2, self._layout)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._pool_size}, "
                f"stride={self._strides}, padding={self._padding}, "
                f"ceil_mode={self._ceil_mode})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(_pair(pool_size, 1), strides and _pair(strides, 1),
                         _pair(padding, 1), ceil_mode, False, "max", layout)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_pair(pool_size, 2), strides and _pair(strides, 2),
                         _pair(padding, 2), ceil_mode, False, "max", layout)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(_pair(pool_size, 3), strides and _pair(strides, 3),
                         _pair(padding, 3), ceil_mode, False, "max", layout)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(_pair(pool_size, 1), strides and _pair(strides, 1),
                         _pair(padding, 1), ceil_mode, False, "avg", layout,
                         count_include_pad)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_pair(pool_size, 2), strides and _pair(strides, 2),
                         _pair(padding, 2), ceil_mode, False, "avg", layout,
                         count_include_pad)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_pair(pool_size, 3), strides and _pair(strides, 3),
                         _pair(padding, 3), ceil_mode, False, "avg", layout,
                         count_include_pad)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, (0,), False, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, (0, 0), False, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "max",
                         layout)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, (0,), False, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, (0, 0), False, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, "avg",
                         layout)


class ReflectionPad2D(HybridBlock):
    """Reflect-pad the last two dims of an NCHW input by ``padding``
    (one int, or (top, bottom, left, right))."""

    _tensor_forward = True

    def __init__(self, padding=0):
        super().__init__()
        self._padding = (padding,) * 4 if isinstance(padding, int) \
            else _pair(padding, 4)

    def forward(self, x):
        top, bottom, left, right = self._padding
        return F.pad(x, (left, right, top, bottom), mode="reflect")


class _PixelShuffle(HybridBlock):
    """Channel blocks regrouped into spatial blocks (sub-pixel
    upsampling): (N, prod(f) C, *s) -> (N, C, *(s f))."""

    _tensor_forward = True

    def __init__(self, factor, ndim):
        super().__init__()
        self._factors = _pair(factor, ndim)
        self._ndim = ndim

    def forward(self, x):
        f, n = self._factors, self._ndim
        N, spatial = x.shape[0], tuple(x.shape[2:])
        C = x.shape[1] // int(onp.prod(f))
        x = x.reshape((N, C) + f + spatial)
        perm = [0, 1]
        for i in range(n):
            perm.extend([2 + n + i, 2 + i])
        x = x.permute(perm)
        return x.reshape((N, C) + tuple(s * fi for s, fi in zip(spatial, f)))

    def __repr__(self):
        return f"{type(self).__name__}({self._factors})"


class PixelShuffle1D(_PixelShuffle):
    """(N, f C, W) -> (N, C, W f)."""

    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    """(N, f1 f2 C, H, W) -> (N, C, H f1, W f2)."""

    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    """(N, f1 f2 f3 C, D, H, W) -> (N, C, D f1, H f2, W f3)."""

    def __init__(self, factor):
        super().__init__(factor, 3)


class DeformableConvolution(HybridBlock):
    """Deformable convolution v1 (Dai et al. 2017): an ordinary
    convolution (zero-initialized) produces each tap's offsets, and
    ``npx.deformable_convolution`` samples and contracts. NCHW only, no
    grouped main kernel, as in the reference."""

    _tensor_forward = True
    _mask_factor = 0  # v2 adds one modulation scalar per tap

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 dtype="float32"):
        super().__init__()
        if layout != "NCHW":
            raise ValueError("DeformableConvolution supports NCHW")
        if groups != 1:
            raise ValueError("grouped main kernels are not supported")
        self._channels = channels
        self._kernel = _pair(kernel_size, 2)
        self._stride = _pair(strides, 2)
        self._pad = _pair(padding, 2)
        self._dilate = _pair(dilation, 2)
        self._g = num_deformable_group
        kh, kw = self._kernel
        self._n_off = (2 + self._mask_factor) * self._g * kh * kw
        self.offset_weight = Parameter(
            "offset_weight",
            shape=(self._n_off, in_channels or 0) + self._kernel,
            init=offset_weight_initializer, dtype=dtype,
            allow_deferred_init=True)
        self.offset_bias = Parameter(
            "offset_bias", shape=(self._n_off,),
            init=offset_bias_initializer, dtype=dtype,
            allow_deferred_init=True) if offset_use_bias else None
        self.weight = Parameter(
            "weight", shape=(channels, in_channels or 0) + self._kernel,
            init=weight_initializer, dtype=dtype, allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(channels,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True) if use_bias else None
        self.act = Activation(activation) if activation else None

    def forward(self, x):
        for p in (self.offset_weight, self.weight):
            if not p._shape_known():
                shape = list(p.shape)
                shape[1] = x.shape[1]
                p._infer_shape(tuple(shape))
        off = _nn.convolution(
            x, self.offset_weight._read(),
            None if self.offset_bias is None else self.offset_bias._read(),
            self._kernel, self._stride, self._dilate, self._pad)
        out = self._deform(x, off)
        return self.act(out) if self.act is not None else out

    def _sample(self, x, off, mask):
        from ... import numpy_extension as npx
        bias = None if self.bias is None else self.bias._read()

        def fn(xx, oo, ww, *rest):
            mm = rest[0] if mask is not None else None
            bb = rest[-1] if bias is not None else None
            return npx.deformable_convolution(
                xx, oo, ww, bb, kernel=self._kernel, stride=self._stride,
                pad=self._pad, dilate=self._dilate,
                num_deformable_group=self._g, mask=mm)

        args = [x, off, self.weight._read()]
        if mask is not None:
            args.append(mask)
        if bias is not None:
            args.append(bias)
        return _call_np(fn, args)

    def _deform(self, x, off):
        return self._sample(x, off, None)


class ModulatedDeformableConvolution(DeformableConvolution):
    """Deformable convolution v2 (Zhu et al. 2018): the offset
    convolution also gives each tap a sigmoid modulation scalar."""

    _mask_factor = 1

    def _deform(self, x, off):
        n_pos = 2 * self._g * self._kernel[0] * self._kernel[1]
        return self._sample(x, off[:, :n_pos],
                            torch.sigmoid(off[:, n_pos:]))
