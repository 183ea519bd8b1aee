"""parallel — the training step of the port, on one device.

Counterpart of ``mxnet_tpu/parallel/__init__.py``. It holds
``TrainStep`` (``train_step.py``): forward, backward and the optimizer
update of one batch, on one card. The device meshes, shardings and
collectives of the reference (``set_mesh``, ``make_mesh``,
``mesh_scope``, the ``tp``/``fsdp`` layouts) wait for ROADMAP.md queue
1, item 20; ``get_mesh`` answers None, so code written against the
reference's default (no mesh) runs as it is.
"""
from __future__ import annotations

from ..base import not_ported
from .train_step import TrainStep

__all__ = ["TrainStep", "get_mesh", "set_mesh", "make_mesh", "mesh_scope",
           "AXIS_DP", "AXIS_TP", "AXIS_PP", "AXIS_SP", "AXIS_EP"]

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_PP = "pp"
AXIS_SP = "sp"
AXIS_EP = "ep"


def get_mesh():
    """The process-global mesh: None (the port runs on one device)."""
    return None


def set_mesh(mesh):
    raise not_ported("parallel.set_mesh (device meshes)", 20)


def make_mesh(shape=None, axis_names=None, devices=None):
    raise not_ported("parallel.make_mesh (device meshes)", 20)


def mesh_scope(mesh):
    raise not_ported("parallel.mesh_scope (device meshes)", 20)
