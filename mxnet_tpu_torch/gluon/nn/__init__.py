"""``gluon.nn`` of the port: every layer of ``mxnet_tpu/gluon/nn``."""
from .basic_layers import (  # noqa: F401
    Sequential, HybridSequential, Dense, Activation, Dropout, BatchNorm,
    BatchNormReLU, SyncBatchNorm, LayerNorm, GroupNorm, InstanceNorm,
    Embedding, Flatten, Identity, Lambda, HybridLambda, Concatenate,
    HybridConcatenate, Concurrent, HybridConcurrent,
)
from .conv_layers import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose, MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
    AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
    GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D, ReflectionPad2D,
    PixelShuffle1D, PixelShuffle2D, PixelShuffle3D,
    DeformableConvolution, ModulatedDeformableConvolution,
)
from .activations import (  # noqa: F401
    LeakyReLU, PReLU, ELU, SELU, GELU, SiLU, Swish, Mish,
)
from .attention import MultiHeadAttention, TransformerEncoderCell  # noqa
from ..block import Block, HybridBlock  # noqa: F401
from . import basic_layers, conv_layers, activations, attention

__all__ = (basic_layers.__all__ + conv_layers.__all__
           + activations.__all__ + attention.__all__
           + ["Block", "HybridBlock"])
