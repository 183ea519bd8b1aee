"""mx.np.fft — the FFT family.

The port of ``mxnet_tpu/numpy/fft.py``: each function is the
``torch.fft`` function of the same name (cuFFT on the card) through
``ops.apply_op``. Results are complex64 (real for the inverse real
transforms, float32), as JAX's are with x64 off: integer, bool and
16-bit float inputs transform in float32 first.
"""
from __future__ import annotations

import torch

from ..ops import apply_op

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fft2", "ifft2",
           "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn", "fftshift",
           "ifftshift", "fftfreq", "rfftfreq"]


def _c(x):
    from . import _coerce
    return _coerce(x)


def _in(x):
    """x as torch's FFTs take it: complex64, complex128 and float32/64
    as they are, anything else float32."""
    if x.is_complex() or x.dtype in (torch.float32, torch.float64):
        return x
    return x.to(torch.float32)


def _mk1(tfn, name):
    def f(a, n=None, axis=-1, norm=None):
        # ihfft gives a conjugate view: materialized
        return apply_op(lambda x: tfn(_in(x), n=n, dim=axis,
                                      norm=norm).resolve_conj(),
                        _c(a), name=name)
    f.__name__ = name
    return f


def _mkn(tfn, name, default_axes):
    def f(a, s=None, axes=default_axes, norm=None):
        ax = None if axes is None else tuple(axes)
        sz = None if s is None else tuple(s)
        return apply_op(lambda x: tfn(_in(x), s=sz, dim=ax, norm=norm),
                        _c(a), name=name)
    f.__name__ = name
    return f


fft = _mk1(torch.fft.fft, "fft")
ifft = _mk1(torch.fft.ifft, "ifft")
rfft = _mk1(torch.fft.rfft, "rfft")
irfft = _mk1(torch.fft.irfft, "irfft")
hfft = _mk1(torch.fft.hfft, "hfft")
ihfft = _mk1(torch.fft.ihfft, "ihfft")
fft2 = _mkn(torch.fft.fft2, "fft2", (-2, -1))
ifft2 = _mkn(torch.fft.ifft2, "ifft2", (-2, -1))
rfft2 = _mkn(torch.fft.rfft2, "rfft2", (-2, -1))
irfft2 = _mkn(torch.fft.irfft2, "irfft2", (-2, -1))
fftn = _mkn(torch.fft.fftn, "fftn", None)
ifftn = _mkn(torch.fft.ifftn, "ifftn", None)
rfftn = _mkn(torch.fft.rfftn, "rfftn", None)
irfftn = _mkn(torch.fft.irfftn, "irfftn", None)


def _axes(axes):
    return axes if axes is None or isinstance(axes, int) else tuple(axes)


def fftshift(x, axes=None):
    return apply_op(lambda a: torch.fft.fftshift(a, dim=_axes(axes)), _c(x),
                    name="fftshift")


def ifftshift(x, axes=None):
    return apply_op(lambda a: torch.fft.ifftshift(a, dim=_axes(axes)),
                    _c(x), name="ifftshift")


def _freq(tfn, n, d, ctx):
    from .. import engine
    from ..context import current_context
    from ..ndarray.ndarray import NDArray
    ctx = ctx or current_context()
    t = tfn(int(n), d=float(d), dtype=torch.float64,
            device=ctx.torch_device)
    return NDArray(engine.track(t.to(torch.float32)), ctx=ctx)


def fftfreq(n, d=1.0, ctx=None):
    return _freq(torch.fft.fftfreq, n, d, ctx)


def rfftfreq(n, d=1.0, ctx=None):
    return _freq(torch.fft.rfftfreq, n, d, ctx)
