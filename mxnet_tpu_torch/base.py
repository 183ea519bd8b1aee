"""Shared helpers of the port (the part of ``mxnet_tpu/base.py``'s role
this slice needs)."""
from __future__ import annotations

__all__ = ["not_ported"]


def not_ported(what, item) -> NotImplementedError:
    """The error for a reference feature a later slice of the port
    brings; ``item`` names its ROADMAP.md queue-1 entry."""
    return NotImplementedError(
        f"{what} is not ported to mxnet_tpu_torch yet (ROADMAP.md queue 1, "
        f"item {item})")
