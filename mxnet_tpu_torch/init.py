"""``mx.init``: an alias of ``mx.initializer``, as in the reference."""
from .initializer import *  # noqa: F401,F403
from .initializer import (  # noqa: F401
    Initializer, InitDesc, Zero, Zeros, One, Ones, Constant, Uniform,
    Normal, Orthogonal, Xavier, MSRAPrelu, Bilinear, LSTMBias,
    InitWithArray, Load, Mixed, register, alias, create,
)
