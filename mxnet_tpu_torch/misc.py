"""Deprecated learning-rate scheduler aliases (the port of
``mxnet_tpu/misc.py``: the historic home of ``FactorScheduler``)."""
from .lr_scheduler import LRScheduler as LearningRateScheduler  # noqa: F401
from .lr_scheduler import FactorScheduler  # noqa: F401

__all__ = ["LearningRateScheduler", "FactorScheduler"]
