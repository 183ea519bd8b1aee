"""Learning-rate schedulers (the port's copy of
``mxnet_tpu/lr_scheduler.py``, which imports nothing of JAX; the port
keeps its own copy rather than import the JAX package).

API parity with the reference's ``python/mxnet/lr_scheduler.py``
(class names, constructor signatures, ``__call__(num_update)``), but a
different design: every schedule here is a **pure function of
``num_update``** computed in closed form. The reference mutates
``self.base_lr`` incrementally inside ``__call__`` (a running
``count``/``cur_step_ind`` state machine), which makes the schedule
depend on the call history; these are stateless, so a scheduler can be
queried at arbitrary points (plotting, resume-from-checkpoint at step
N, jitted lookup tables) and always returns the same value for the
same ``num_update``.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base class: warmup handling + the ``__call__`` contract.

    Subclasses implement :meth:`_decayed_lr`, the post-warmup schedule,
    as a pure function of the number of post-warmup updates.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_begin_lr > base_lr:
            raise ValueError("base lr has to be higher than warmup lr")
        if warmup_steps < 0:
            raise ValueError("warmup steps has to be positive or 0")
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("Supports only linear and constant warmup modes")
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / self.warmup_steps
        return self.warmup_begin_lr + frac * (self.warmup_final_lr
                                              - self.warmup_begin_lr)

    def _decayed_lr(self, steps_after_warmup):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decayed_lr(num_update - self.warmup_steps)


class FactorScheduler(LRScheduler):
    """``lr = base_lr * factor**k`` after every ``step`` updates,
    floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decayed_lr(self, t):
        # the k-th decay fires once num_update exceeds k*step (warmup
        # offset included in the reference's accounting: it counts raw
        # num_update, so re-add it here)
        num_update = t + self.warmup_steps
        n_decays = max(0, (num_update - 1) // self.step)
        return max(self.base_lr * self.factor ** n_decays,
                   self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """``lr = base_lr * factor**k`` where ``k`` counts the milestones in
    ``step`` that ``num_update`` has passed."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("Schedule step must be greater or equal than 1")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("Schedule step must be an increasing list")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor

    def _decayed_lr(self, t):
        num_update = t + self.warmup_steps
        n_decays = sum(1 for milestone in self.step
                       if num_update > milestone)
        return self.base_lr * self.factor ** n_decays


class _SpanScheduler(LRScheduler):
    """Shared shape for schedules that anneal base_lr -> final_lr over
    ``max_update`` total updates: subclasses map the elapsed fraction
    to a remaining-lr fraction in [0, 1]."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError(
                "maximum number of updates must be strictly positive")
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def _remaining(self, frac_elapsed):
        raise NotImplementedError

    def _decayed_lr(self, t):
        frac = min(t / self.max_steps, 1.0) if self.max_steps > 0 else 1.0
        span = self.base_lr - self.final_lr
        return self.final_lr + span * self._remaining(frac)


class PolyScheduler(_SpanScheduler):
    """Polynomial decay: remaining fraction ``(1 - t/T)**pwr``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr,
                         warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _remaining(self, frac_elapsed):
        return (1.0 - frac_elapsed) ** self.power


class CosineScheduler(_SpanScheduler):
    """Cosine decay: remaining fraction ``(1 + cos(pi * t/T)) / 2``."""

    def _remaining(self, frac_elapsed):
        return 0.5 * (1.0 + math.cos(math.pi * frac_elapsed))
