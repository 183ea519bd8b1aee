"""Global RNG state of the imperative API (the port of
``mxnet_tpu/random_state.py``).

The reference splits one global JAX key per call; the port keeps one
explicit ``torch.Generator`` per device, each seeded from the global
seed when first used, so ``mx.np.random.seed(n)`` makes every later
draw repeat. Torch's generators (Philox on the card) and JAX's
Threefry give different numbers for one seed: the tests compare
shapes, ranges and moments, never values.

The reference's key helpers map onto generators: ``next_key`` gives the
global generator of a device (each draw from it advances the stream, as
each of the reference's keys is a fresh split), ``request_key`` a
generator of a request's own seed, and ``trace_rng`` is a no-op scope
(the eager port has no hybridize trace whose random ops would need a
traced key).
"""
from __future__ import annotations

import threading

import torch

from .context import resolve_device

__all__ = ["seed", "generator", "get_state", "set_state", "next_key",
           "request_key", "trace_rng"]

_lock = threading.Lock()
_seed = [0]
_generators: dict = {}


def seed(seed_value: int):
    """Seed the global generators (parity: mx.np.random.seed)."""
    with _lock:
        _seed[0] = int(seed_value)
        for g in _generators.values():
            g.manual_seed(_seed[0])


def generator(device: torch.device) -> torch.Generator:
    """The global generator of ``device`` (created on first use)."""
    key = str(device)
    g = _generators.get(key)
    if g is None:
        with _lock:
            g = _generators.get(key)
            if g is None:
                g = torch.Generator(device=device)
                g.manual_seed(_seed[0])
                _generators[key] = g
    return g


def get_state():
    """``(seed, {device: generator state})``, host tensors, for a
    checkpoint to restore with :func:`set_state`."""
    with _lock:
        return _seed[0], {k: g.get_state() for k, g in _generators.items()}


def set_state(seed_value, states):
    """Restore a :func:`get_state` snapshot."""
    with _lock:
        _seed[0] = int(seed_value)
        _generators.clear()
    for key, st in states.items():
        generator(torch.device(key)).set_state(st)


def next_key(device=None) -> torch.Generator:
    """The generator to draw the next random numbers from on ``device``
    (the card unless the CPU is asked for): the global generator of that
    device, so draws follow ``seed``."""
    return generator(resolve_device(device))


def request_key(seed_value: int, device=None) -> torch.Generator:
    """The generator of a request's own seed on ``device`` (the card
    unless the CPU is asked for), independent of the global generators:
    the same seed gives the same stream, as the serving engine's
    per-request generators do."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed_value))


class trace_rng:
    """A no-op scope: the reference installs a traced key here while
    hybridize traces a block, and the eager port has no such trace."""

    def __init__(self, key=None):
        self._key = key

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
