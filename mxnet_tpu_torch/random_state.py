"""Global RNG state of the imperative API (the port of
``mxnet_tpu/random_state.py``).

The reference splits one global JAX key per call; the port keeps one
explicit ``torch.Generator`` per device, each seeded from the global
seed when first used, so ``mx.np.random.seed(n)`` makes every later
draw repeat. Torch's generators (Philox on the card) and JAX's
Threefry give different numbers for one seed: the tests compare
shapes, ranges and moments, never values. ``trace_rng`` is not ported:
it serves hybridize.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "get_state", "set_state"]

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
