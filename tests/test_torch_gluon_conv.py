"""The port's convolution, pooling and pixel layers of ``gluon.nn``
against the JAX package's, on the CPU, with ``test_torch_gluon_nn.py``'s
helpers: the same seeded parameters carried across by name, the same
seeded inputs (NCW, NCHW, NHWC and NCDHW), the JAX layers unhybridized.
Conv2D's and BatchNorm's gradients under ``autograd.record()`` are
crossed too.

Tolerances: pooling, padding and pixel shuffles at 2e-6 (``TR``);
convolutions and the deformable convolutions at 1e-5 (``RED``), 1e-4
for gradients (``GRAD``).
"""
import pytest

from test_torch_gluon_nn import (RED, TR, _on_cpu,  # noqa: F401
                                 check_gradients, check_layer)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# (id, factory(nn) -> layer, input, tolerance)
CASES = [
    ("Conv1D", lambda nn: nn.Conv1D(3, 3, padding=1, strides=2), "c1", RED),
    ("Conv2D", lambda nn: nn.Conv2D(3, 3, padding=1, activation="relu"),
     "c2", RED),
    ("Conv2D_NHWC", lambda nn: nn.Conv2D(3, (3, 2), layout="NHWC",
                                         dilation=(1, 2)), "c2l", RED),
    ("Conv2D_groups", lambda nn: nn.Conv2D(4, 3, groups=2), "c2", RED),
    ("Conv3D", lambda nn: nn.Conv3D(2, 2), "c3", RED),
    ("Conv1DTranspose", lambda nn: nn.Conv1DTranspose(3, 3, strides=2),
     "c1", RED),
    ("Conv2DTranspose",
     lambda nn: nn.Conv2DTranspose(3, 3, strides=2, padding=1,
                                   output_padding=1), "c2", RED),
    ("Conv3DTranspose", lambda nn: nn.Conv3DTranspose(2, 2), "c3", RED),
    ("MaxPool1D", lambda nn: nn.MaxPool1D(), "c1", TR),
    ("MaxPool2D", lambda nn: nn.MaxPool2D(3, 2, 1), "c2", TR),
    ("MaxPool3D", lambda nn: nn.MaxPool3D(), "c3", TR),
    ("AvgPool1D", lambda nn: nn.AvgPool1D(3, 2, 1, ceil_mode=True), "c1",
     TR),
    ("AvgPool2D", lambda nn: nn.AvgPool2D(count_include_pad=False,
                                          padding=1), "c2", TR),
    ("AvgPool3D", lambda nn: nn.AvgPool3D(), "c3", TR),
    ("GlobalMaxPool1D", lambda nn: nn.GlobalMaxPool1D(), "c1", TR),
    ("GlobalMaxPool2D", lambda nn: nn.GlobalMaxPool2D(), "c2", TR),
    ("GlobalMaxPool3D", lambda nn: nn.GlobalMaxPool3D(), "c3", TR),
    ("GlobalAvgPool1D", lambda nn: nn.GlobalAvgPool1D(), "c1", TR),
    ("GlobalAvgPool2D", lambda nn: nn.GlobalAvgPool2D(), "c2", TR),
    ("GlobalAvgPool3D", lambda nn: nn.GlobalAvgPool3D(), "c3", TR),
    ("ReflectionPad2D", lambda nn: nn.ReflectionPad2D(2), "c2", TR),
    ("PixelShuffle1D", lambda nn: nn.PixelShuffle1D(2), "ps1", TR),
    ("PixelShuffle2D", lambda nn: nn.PixelShuffle2D((2, 1)), "c2", TR),
    ("PixelShuffle3D", lambda nn: nn.PixelShuffle3D(2), "ps3", TR),
    ("DeformableConvolution",
     lambda nn: nn.DeformableConvolution(3, 3, padding=1), "c2", RED),
    ("ModulatedDeformableConvolution",
     lambda nn: nn.ModulatedDeformableConvolution(3, 3, padding=1), "c2",
     RED),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_reference(case):
    check_layer(*case[1:])


@pytest.mark.parametrize("factory", [
    lambda nn: nn.Conv2D(3, 3, padding=1, strides=2),
    lambda nn: nn.BatchNorm(),
], ids=["Conv2D", "BatchNorm"])
def test_conv_net_gradients_match_reference(factory):
    """The gradients of a conv net's two trained layers, BatchNorm's in
    training mode (``record()``: the batch's statistics)."""
    check_gradients(factory, "c2")
