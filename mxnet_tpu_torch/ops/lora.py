"""Batched multi-tenant LoRA: a stacked adapter bank applied inside the
one fixed-shape decode step.

Counterpart of ``mxnet_tpu/ops/lora.py``. A tenant is a low-rank delta
``y = base(x) + (x @ A) @ B * (alpha / r)`` over frozen base weights.
All adapters of one engine live stacked, per projection, as

    A:     (n_adapters, d_in, rank)
    B:     (n_adapters, rank, d_out)
    scale: (n_adapters,)            # alpha / rank per adapter

and one decode step over B slots gathers each row's adapter by a
per-slot ``(B,)`` index vector::

    y[b] = base(x[b]) + (x[b] @ A[idx[b]]) @ B[idx[b]] * scale[idx[b]]

so a batch mixing any number of tenants, base rows included, runs one
step: the index vector is data, like the int8 tables of
``ops/quantized.py``. Slot 0 is RESERVED all-zeros: a base-model row
adds an exact zero, so its output equals a LoRA-free engine's.

What differs from the reference: the bank is updated IN PLACE.
``set_slot`` and ``clear_slot`` write into the tensors ``init_bank``
allocated and return those same tensors, so loading, refreshing or
unloading an adapter allocates nothing and the bank's ``data_ptr()``
never changes (the port's form of the reference's zero-retrace
contract). The delta is plain jnp in the reference, outside any Pallas
kernel, and plain PyTorch here: two batched products in fp32, the scale,
the add. The sum promotes as jnp does: a bf16 ``y`` plus the fp32
delta is fp32.
"""
from __future__ import annotations

import numpy as onp
import torch

__all__ = ["init_bank", "init_layers", "set_slot", "clear_slot", "apply",
           "gather", "apply_rows", "bank_bytes"]


def _slots_and_rank(n_adapters, rank):
    n, r = int(n_adapters), int(rank)
    if r < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    if n < 2:
        raise ValueError(
            f"n_adapters must be >= 2 (slot 0 is the reserved "
            f"all-zeros base adapter), got {n_adapters}")
    return n, r


def init_bank(n_adapters, d_in, d_out, rank, device=None):
    """Allocate an all-zeros stacked adapter bank for one projection:
    ``{"A": (n, d_in, r), "B": (n, r, d_out), "scale": (n,)}`` fp32 on
    ``device``. Slot 0 is the reserved base-model (all-zeros) adapter,
    so ``n`` must leave at least one loadable slot beside it."""
    n, r = _slots_and_rank(n_adapters, rank)
    z = dict(dtype=torch.float32, device=device)
    return {"A": torch.zeros((n, int(d_in), r), **z),
            "B": torch.zeros((n, r, int(d_out)), **z),
            "scale": torch.zeros((n,), **z)}


def init_layers(n_adapters, n_layers, d_in, d_out, rank, device=None):
    """The banks of one projection in ``n_layers`` layers as one
    allocation each: ``{"A": (n, L, d_in, r), "B": (n, L, r, d_out),
    "scale": (n,)}``. Layer ``li``'s bank is the view ``A[:, li]``,
    ``B[:, li]`` with the shared scale, and one gather by row serves
    every layer."""
    n, r = _slots_and_rank(n_adapters, rank)
    z = dict(dtype=torch.float32, device=device)
    return {"A": torch.zeros((n, int(n_layers), int(d_in), r), **z),
            "B": torch.zeros((n, int(n_layers), r, int(d_out)), **z),
            "scale": torch.zeros((n,), **z)}


def _factor(x, shape, what):
    t = torch.as_tensor(onp.asarray(x, "f4") if not torch.is_tensor(x)
                        else x).float()
    if tuple(t.shape) != shape:
        raise ValueError(f"adapter {what} shape {tuple(t.shape)} != bank "
                         f"slot shape {shape}")
    return t


def set_slot(bank, idx, a, b, alpha):
    """Install adapter ``(a, b, alpha)`` into bank slot ``idx`` IN PLACE
    and return the same bank. Slot 0 is immutable; shapes are checked
    before anything is written."""
    idx = int(idx)
    n, d_in, r = bank["A"].shape
    d_out = bank["B"].shape[2]
    if idx == 0:
        raise ValueError("adapter slot 0 is the reserved all-zeros "
                         "base adapter and cannot be written")
    if not 0 < idx < n:
        raise ValueError(f"adapter slot {idx} out of range (bank holds "
                         f"{n} slots)")
    a = _factor(a, (d_in, r), "A")
    b = _factor(b, (r, d_out), "B")
    with torch.no_grad():
        bank["A"][idx].copy_(a)
        bank["B"][idx].copy_(b)
        bank["scale"][idx] = float(alpha) / r
    return bank


def clear_slot(bank, idx):
    """Zero bank slot ``idx`` back to the base (no-op) adapter, in
    place; returns the same bank."""
    idx = int(idx)
    if idx == 0:
        raise ValueError("adapter slot 0 is already the reserved "
                         "all-zeros base adapter")
    with torch.no_grad():
        bank["A"][idx].zero_()
        bank["B"][idx].zero_()
        bank["scale"][idx] = 0.0
    return bank


def gather(bank, idx):
    """Each row's factors: ``(A[idx], B[idx], scale[idx])``, shapes
    (B, d_in, r), (B, r, d_out) and (B,). ``idx`` is a (B,) integer
    tensor on the bank's device."""
    idx = idx.long()
    return bank["A"][idx], bank["B"][idx], bank["scale"][idx]


def apply_rows(y, x, a, b, s):
    """``y + (x @ a) @ b * s`` over rows already gathered: ``y``/``x``
    are (B, S, d_out)/(B, S, d_in), ``a``/``b``/``s`` per row as
    :func:`gather` gives them. The factors contract in fp32 whatever
    x's type, in the reference's order: the two products, then the
    scale, then the add."""
    lo = torch.bmm(x.float(), a)
    return y + torch.bmm(lo, b) * s[:, None, None]


def apply(y, x, bank, idx):
    """``y + (x @ A[idx]) @ B[idx] * scale[idx]`` — the batched adapter
    delta over a projection's pre-activation output. ``y``/``x`` are
    (B, S, d_out)/(B, S, d_in) (decode steps run S = 1), ``idx`` the
    per-row (B,) adapter index. Rows with ``idx == 0`` add an exact
    zero (slot 0 is all-zeros): base-model rows equal the LoRA-free
    output."""
    return apply_rows(y, x, *gather(bank, torch.as_tensor(idx)))


def bank_bytes(banks):
    """Total device bytes of a model's adapter banks (an iterable of
    per-block ``{proj: bank}`` dicts), as the reference counts them:
    every bank's A, B and scale."""
    return sum(v.numel() * v.element_size()
               for tab in banks for bank in tab.values()
               for v in bank.values())
