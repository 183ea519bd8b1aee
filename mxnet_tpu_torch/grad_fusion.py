"""Tensor fusion of the Trainer's gradients (the port of
``mxnet_tpu/grad_fusion.py``).

The reference coalesces same-dtype gradients, in reverse declaration
order (the order backward produces them, its ``priority = -key``), into
size-capped flat buckets and issues one collective per bucket. The
bucket layout is here as it is there: ``build_buckets`` keeps one open
bucket per dtype, flushes it at the byte cap, and keys each bucket by a
digest of its content, so the two packages give equal layouts and keys.
The collectives themselves need a kvstore (ROADMAP.md queue 1, item
19); the one-card ``Trainer`` never reaches them, as the reference's
``allreduce_grads`` returns at once without a store.

Switches (the reference's own environment variables):

- ``MXTPU_FUSED_TRAINER=0`` turns the reference's fused Trainer path
  off; ``fused_enabled`` reads it as the reference does. The port's
  ``Trainer`` always updates through
  ``Optimizer.fused_update_multi_precision``, whose bits equal the
  per-parameter loop's, so the switch changes nothing there.
- ``MXTPU_FUSION_BYTES`` / ``Trainer(fusion=<bytes>)`` cap a bucket
  (4 MiB by default); a gradient larger than the cap has a bucket of
  its own.
"""
from __future__ import annotations

import itertools
import os
import zlib

import torch

from .base import not_ported

__all__ = ["fused_enabled", "default_fusion_bytes", "build_buckets",
           "allreduce_bucket", "reduce_scatter_bucket", "GradBucket",
           "DEFAULT_FUSION_BYTES", "next_owner_uid"]

DEFAULT_FUSION_BYTES = 4 << 20  # 4 MiB, Horovod's fusion-buffer default


def fused_enabled() -> bool:
    """The fused Trainer path's switch, read at each call."""
    return os.environ.get("MXTPU_FUSED_TRAINER", "1").lower() \
        not in ("0", "false", "off")


def default_fusion_bytes() -> int:
    raw = os.environ.get("MXTPU_FUSION_BYTES", "")
    if raw:
        try:
            v = int(raw)
            if v > 0:
                return v
        except ValueError:
            import warnings
            warnings.warn(f"ignoring malformed MXTPU_FUSION_BYTES={raw!r}"
                          " (expected a positive integer)")
    return DEFAULT_FUSION_BYTES


_owner_uids = itertools.count()


def next_owner_uid() -> int:
    """A process-unique owner token for bucket keys (one per Trainer)."""
    return next(_owner_uids)


def _dtype_name(dt: torch.dtype) -> str:
    """The reference's name of a dtype (``str`` of its jax dtype)."""
    return str(dt).replace("torch.", "")


class GradBucket:
    """One fusion bucket: same-dtype parameters, their gradients' bytes
    capped at the fusion limit. ``key`` digests the bucket's content
    (indices, shapes, dtype), not its ordinal."""

    __slots__ = ("bid", "indices", "params", "shapes", "nbytes", "dtype",
                 "key")

    def __init__(self, bid, indices, params, shapes, nbytes, dtype,
                 owner=0):
        self.bid = bid
        self.indices = indices
        self.params = params
        self.shapes = shapes
        self.nbytes = nbytes
        self.dtype = dtype
        sig = zlib.crc32(repr((indices, shapes, dtype)).encode())
        self.key = f"__fused__{owner}:{bid}:{sig:08x}"


def build_buckets(active, cap_bytes, owner=0):
    """Group ``active``, a list of ``(index, param)``, into fusion
    buckets: reverse declaration order, one open bucket per dtype, a
    bucket flushed when the next gradient would pass the byte cap."""
    open_by_dtype = {}
    buckets = []

    def flush(dt):
        b = open_by_dtype.pop(dt, None)
        if b:
            idxs, ps, shapes, nb = b
            buckets.append(GradBucket(len(buckets), tuple(idxs),
                                      tuple(ps), tuple(shapes), nb, dt,
                                      owner=owner))

    for i, p in reversed(active):
        t = p._var()
        dt = _dtype_name(t.dtype)
        nb = t.numel() * t.element_size()
        shape = tuple(int(n) for n in t.shape)
        b = open_by_dtype.get(dt)
        if b is not None and b[3] + nb > cap_bytes:
            flush(dt)
            b = None
        if b is None:
            open_by_dtype[dt] = [[i], [p], [shape], nb]
        else:
            b[0].append(i)
            b[1].append(p)
            b[2].append(shape)
            b[3] += nb
    for dt in list(open_by_dtype):
        flush(dt)
    return buckets


def allreduce_bucket(bucket, kvstore):
    """Flatten, all-reduce and unflatten one bucket: needs a kvstore."""
    raise not_ported("grad_fusion.allreduce_bucket (a kvstore)", 19)


def reduce_scatter_bucket(bucket, kvstore, layout):
    """The fsdp layout's bucket sync: needs a kvstore and a mesh."""
    raise not_ported("grad_fusion.reduce_scatter_bucket (a kvstore)", 19)
