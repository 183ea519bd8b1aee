"""Legacy model checkpoint helpers (the port of ``mxnet_tpu/model.py``).

``save_checkpoint`` writes ``prefix-NNNN.params`` in the reference's
legacy binary NDArray format with ``arg:``/``aux:`` key prefixes, so a
checkpoint round-trips with the JAX package and the reference's
tooling; ``load_params`` reads it back (or a Gluon ``save_parameters``
file). A symbol file needs ``mx.sym`` (ROADMAP.md queue 1, item 26):
``save_checkpoint`` with a symbol and ``load_checkpoint`` raise for it.
"""
from __future__ import annotations

from . import legacy_serialization as _legacy
from .base import not_ported
from .callback import BatchEndParam  # noqa: F401  (historic home)

__all__ = ["save_checkpoint", "load_params", "load_checkpoint",
           "BatchEndParam"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Save ``prefix-{epoch:04d}.params`` (``symbol`` must be None: the
    symbol file waits for ``mx.sym``). ``remove_amp_cast`` is accepted
    for the reference's signature; no cast is saved."""
    if symbol is not None:
        raise not_ported("model.save_checkpoint of a symbol (mx.sym)", 26)
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    _legacy.save_legacy(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch):
    """Load ``prefix-{epoch:04d}.params`` -> ``(arg_params,
    aux_params)``, from the legacy binary of :func:`save_checkpoint` or
    a Gluon ``save_parameters`` file. Keys without a prefix go to
    ``aux_params`` when they name running statistics (``running_``,
    ``moving_``), else to ``arg_params``, as in the reference."""
    from . import utils_io
    fname = f"{prefix}-{epoch:04d}.params"
    loaded = utils_io.load(fname)
    if not isinstance(loaded, dict):
        raise ValueError("checkpoint params file has no names; "
                         "not a save_checkpoint artifact")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        elif "running_" in k or "moving_" in k:
            aux_params[k] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Needs ``mx.sym`` to read ``prefix-symbol.json`` (item 26)."""
    raise not_ported("model.load_checkpoint (mx.sym)", 26)
