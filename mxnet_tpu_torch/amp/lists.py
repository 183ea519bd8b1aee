"""AMP op lists: the port's own copy of ``mxnet_tpu/amp/lists.py``
(the reference's FP16_FUNCS / FP32_FUNCS / WIDEST_TYPE_CASTS split, by
the op names that reach the cast insertion)."""

# Compute-bound ops that run in the low-precision dtype.
TARGET_DTYPE_OPS = [
    "fully_connected", "convolution", "deconvolution", "matmul", "dot",
    "einsum", "tensordot", "batch_dot", "rnn",
]

# Numerically sensitive ops pinned to fp32.
FP32_OPS = [
    "softmax", "log_softmax", "masked_softmax", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "l2_normalization", "norm", "mean", "sum",
    "exp", "log", "erfinv", "gamma", "gammaln", "ctc_loss", "var", "std",
]

# Ops of several inputs that cast them to the widest float type.
WIDEST_TYPE_CASTS = [
    "add", "subtract", "multiply", "true_divide", "maximum", "minimum",
    "where", "concatenate", "stack",
]

CONDITIONAL_FP32_OPS = []

TARGET_DTYPE_SET = frozenset(TARGET_DTYPE_OPS)
FP32_SET = frozenset(FP32_OPS)
WIDEST_SET = frozenset(WIDEST_TYPE_CASTS)
