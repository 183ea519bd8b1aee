"""Dynamic loss scaling for float16 (the port of
``mxnet_tpu/amp/loss_scaler.py``).

``all_finite`` checks every gradient with one multi-tensor reduction
(``torch._foreach_norm`` at ``ord=inf``: a tensor's largest magnitude,
inf or NaN when it holds one) and reads one flag back: one host read
per check, whatever the number of gradients, as the reference's one
jitted program. ``LossScaler`` keeps the reference's rules: scale 2^16
at first, halved on an overflow (not below 1), doubled after 2000
clean updates (not above 2^24); ``overflow_count`` counts the trips,
and ``telemetry`` counts them as ``amp.overflow``.
"""
from __future__ import annotations

import torch

from .. import telemetry

__all__ = ["all_finite", "LossScaler"]


def all_finite(arrays) -> bool:
    """True iff every element of every floating tensor is finite
    (integer tensors pass)."""
    xs = [a for a in arrays if torch.is_tensor(a) and a.is_floating_point()]
    if not xs:
        return True
    with torch.no_grad():
        peaks = torch._foreach_norm(xs, float("inf"))
        return bool(torch.stack(peaks).isfinite().all().item())


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self.overflow_count = 0

    def has_overflow(self, params):
        """Whether any gradient of ``params`` holds an inf or a NaN."""
        grads = []
        for p in params:
            if p.grad_req == "null" or not p._initialized or \
                    p._nd._grad is None:
                continue
            grads.append(p._nd._grad._data)
        if not grads:
            return False
        overflow = not all_finite(grads)
        if overflow:
            telemetry.counter("amp.overflow")
        return overflow

    def update_scale(self, overflow: bool):
        if overflow:
            self.overflow_count += 1
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      2.0 ** 24)
                self._unskipped = 0
        return self.loss_scale
