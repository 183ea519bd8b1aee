"""``mx.random`` (the port of ``mxnet_tpu/random.py``): the global seed
and the legacy sampler names, which are ``mx.np.random``'s.

``seed`` seeds the port's generators (``random_state``: one
``torch.Generator`` per device), so every later draw of ``mx.np.random``,
``npx`` dropout and the Gluon initializers and ``Dropout`` layers
repeats. As in the reference, ``ctx`` is accepted and every device is
seeded.
"""
from __future__ import annotations

from .numpy.random import (  # noqa: F401
    uniform, normal, randint, poisson, exponential, gamma, multinomial,
    shuffle, randn, beta, laplace, negative_binomial,
)
from .random_state import seed as _seed

__all__ = ["seed", "uniform", "normal", "randint", "poisson",
           "exponential", "gamma", "multinomial", "shuffle", "randn",
           "beta", "laplace", "negative_binomial"]


def seed(seed_state, ctx="all"):  # noqa: ARG001 - every device is seeded
    _seed(int(seed_state))
