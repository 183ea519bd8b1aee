"""npx.random — the extension samplers (the port of
``mxnet_tpu/numpy_extension/random.py``): ``mx.np.random``'s, drawing
from the port's per-device generators."""
from __future__ import annotations

from ..numpy.random import (  # noqa: F401
    seed, bernoulli, uniform, normal, randint, gamma, exponential,
    multinomial,
)

__all__ = ["seed", "bernoulli", "uniform", "normal", "randint", "gamma",
           "exponential", "multinomial"]
