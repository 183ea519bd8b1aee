"""Shape bucketing — map a length to the nearest allowed bucket.

The port's copy of ``mxnet_tpu/bucketing.py``'s policy object and its
env parsing. The serving engine pads each prompt up to its bucket
before prefill, so the port must produce the same bucket for every
length as the JAX package does (greedy token parity depends on it:
the bucket is the prefill width).

A process-global policy can be installed with `set_policy` /
`policy_scope`, or via the ``MXTPU_BUCKETING`` env var:
``pow2`` | ``mult:8`` | ``16,32,64`` (explicit buckets) | ``0``/unset
(disabled).
"""
from __future__ import annotations

import contextlib
import os
import warnings

__all__ = ["BucketingPolicy", "set_policy", "get_policy",
           "policy_scope", "as_policy"]


class BucketingPolicy:
    """Map a size ``n`` to the smallest allowed bucket >= n.

    Parameters
    ----------
    buckets : sequence of int, optional
        Explicit allowed sizes. When given, `mode` is ignored;
        a size above the largest bucket maps to itself.
    mode : {"pow2", "multiple"}
        ``pow2`` rounds up to the next power of two; ``multiple``
        rounds up to the next multiple of `multiple`.
    multiple : int
        Granularity for ``mode="multiple"``.
    min_size : int
        Floor for computed buckets (tiny tails share one bucket).
    max_size : int, optional
        Ceiling: a computed bucket above it clamps to
        ``max(n, max_size)``.
    """

    def __init__(self, buckets=None, mode="pow2", multiple=8,
                 min_size=1, max_size=None):
        if buckets is not None:
            buckets = sorted(int(b) for b in buckets)
            if not buckets or buckets[0] < 1:
                raise ValueError(f"buckets must be positive, got {buckets}")
        elif mode not in ("pow2", "multiple"):
            raise ValueError(
                f"mode must be 'pow2' or 'multiple', got {mode!r}")
        if int(multiple) < 1 or int(min_size) < 1:
            raise ValueError("multiple and min_size must be >= 1")
        self.buckets = buckets
        self.mode = mode
        self.multiple = int(multiple)
        self.min_size = int(min_size)
        self.max_size = int(max_size) if max_size is not None else None

    def bucket(self, n: int) -> int:
        """Smallest allowed size >= n (never below n)."""
        n = int(n)
        if n < 1:
            return n
        if self.buckets is not None:
            target = next((b for b in self.buckets if b >= n), n)
        elif self.mode == "pow2":
            target = max(self.min_size, 1 << (n - 1).bit_length())
        else:
            m = self.multiple
            target = max(self.min_size, -(-n // m) * m)
        if self.max_size is not None and target > self.max_size:
            target = max(n, self.max_size)
        return target

    def sizes(self, max_size: int):
        """Every bucket size reachable for a size in ``1..max_size``,
        sorted ascending — the serving engine's warmup list."""
        return sorted({self.bucket(n) for n in range(1, int(max_size) + 1)})

    def clamped(self, batch_size: int) -> "BucketingPolicy":
        """Copy of this policy that never pads past ``batch_size``."""
        return BucketingPolicy(
            buckets=self.buckets, mode=self.mode, multiple=self.multiple,
            min_size=self.min_size,
            max_size=batch_size if self.max_size is None
            else min(self.max_size, batch_size))

    def __repr__(self):
        if self.buckets is not None:
            body = f"buckets={self.buckets}"
        else:
            body = f"mode={self.mode!r}, multiple={self.multiple}"
        return (f"BucketingPolicy({body}, min_size={self.min_size}, "
                f"max_size={self.max_size})")


def _from_env(spec: str):
    spec = (spec or "").strip()
    if spec in ("", "0", "off", "false", "none"):
        return None
    if spec == "pow2":
        return BucketingPolicy(mode="pow2")
    if spec.startswith("mult:"):
        return BucketingPolicy(mode="multiple", multiple=int(spec[5:]))
    return BucketingPolicy(buckets=[int(x) for x in spec.split(",")])


def as_policy(value):
    """Normalize a user-facing bucketing argument: None/False → None,
    True → env default (or pow2), str → env-style spec, policy → policy."""
    if value is None or value is False:
        return None
    if value is True:
        return get_policy() or BucketingPolicy(mode="pow2")
    if isinstance(value, str):
        return _from_env(value)
    if isinstance(value, BucketingPolicy):
        return value
    raise TypeError(f"bucketing must be a BucketingPolicy, bool, or "
                    f"env-style str, got {type(value).__name__}")


try:
    _policy = _from_env(os.environ.get("MXTPU_BUCKETING", ""))
except (ValueError, TypeError) as _e:
    # a malformed env var must not take down the package import for
    # programs that never touch bucketing
    warnings.warn(f"ignoring malformed MXTPU_BUCKETING="
                  f"{os.environ.get('MXTPU_BUCKETING')!r}: {_e}")
    _policy = None


def set_policy(policy):
    """Install the process-global policy (None disables). Returns the
    previous policy."""
    global _policy
    prev = _policy
    _policy = as_policy(policy) if not isinstance(policy, BucketingPolicy) \
        else policy
    return prev


def get_policy():
    return _policy


@contextlib.contextmanager
def policy_scope(policy):
    prev = set_policy(policy)
    try:
        yield get_policy()
    finally:
        set_policy(prev)
