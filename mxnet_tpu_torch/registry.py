"""Generic class registry helpers.

Counterpart of ``mxnet_tpu/registry.py`` (``get_register_func``,
``get_alias_func``, ``get_create_func``). The port's ``initializer``
registers through it; user code can build its own plug-in registries
the same way.
"""
from __future__ import annotations

import json
import warnings

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func"]

_REGISTRIES = {}


def get_registry(base_class):
    """A copy of the name→class registry for ``base_class``."""
    return dict(_REGISTRIES.get(base_class, {}))


def get_register_func(base_class, nickname):
    """Build a ``register(klass)`` decorator for ``base_class``."""
    if base_class not in _REGISTRIES:
        _REGISTRIES[base_class] = {}
    registry = _REGISTRIES[base_class]

    def register(klass, name=None):
        if not issubclass(klass, base_class):
            raise TypeError(
                f"can only register subclasses of {base_class.__name__}")
        if name is None:
            name = klass.__name__
        name = name.lower()
        if name in registry and registry[name] is not klass:
            warnings.warn(
                f"new {nickname} {klass.__name__} registered with name "
                f"{name} is overriding existing {nickname} "
                f"{registry[name].__name__}")
        registry[name] = klass
        return klass

    register.__doc__ = f"Register {nickname} to the {nickname} factory."
    return register


def get_alias_func(base_class, nickname):
    """Build an ``alias(*names)`` class decorator for ``base_class``."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    alias.__doc__ = f"Register {nickname} under alias names."
    return alias


def get_create_func(base_class, nickname):
    """Build a ``create(spec, **kwargs)`` factory for ``base_class``.

    ``spec`` may be an instance (returned as-is), a registered name, or
    a ``name`` / ``json-dict-string`` pair the reference accepts.
    """
    if base_class not in _REGISTRIES:
        _REGISTRIES[base_class] = {}
    registry = _REGISTRIES[base_class]

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            if len(args) > 1 or kwargs:
                raise ValueError(
                    f"{nickname} is already an instance; "
                    "cannot take additional arguments")
            return args[0]
        if not args:
            raise ValueError(f"{nickname} name is required")
        name, args = args[0], args[1:]
        if isinstance(name, str) and name.startswith("{"):
            spec = json.loads(name)
            name = spec.pop("__name__" if "__name__" in spec else "name")
            kwargs = {**spec, **kwargs}
        name = name.lower()
        if name not in registry:
            raise ValueError(
                f"{name} is not a registered {nickname}; known: "
                f"{sorted(registry)}")
        return registry[name](*args, **kwargs)

    create.__doc__ = f"Create a {nickname} instance by name or spec."
    return create
