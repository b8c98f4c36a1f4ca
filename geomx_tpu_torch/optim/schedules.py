"""Learning-rate schedules with optax's values (the schedules the repo
uses: ``optax.schedules.warmup_cosine_decay_schedule``, which bench.py
runs with Nesterov momentum).

A schedule maps the optimizer's update count (a host int) to a step
size.  optax evaluates it in fp32 on the device; the port evaluates the
same operations in numpy fp32 and returns the fp32 value as a Python
float.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

_F = np.float32


def _linear_schedule(init_value: float, end_value: float,
                     transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (``transition_begin`` 0)."""
    if transition_steps <= 0:
        return lambda count: float(_F(init_value))

    def schedule(count: int) -> float:
        c = min(max(int(count), 0), transition_steps)
        frac = _F(1) - _F(c) / _F(transition_steps)
        return float(_F(init_value - end_value) * frac + _F(end_value))

    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int,
                           alpha: float = 0.0,
                           exponent: float = 1.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = _F(min(float(count), float(decay_steps)))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c
                                           / _F(decay_steps)))
        decayed = _F(1 - alpha) * cosine ** _F(exponent) + _F(alpha)
        return float(_F(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warm-up from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (warm-up included), as optax's."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = _cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha=alpha, exponent=exponent)

    def schedule(count: int) -> float:
        count = int(count)
        return warm(count) if count < warmup_steps \
            else decay(count - warmup_steps)

    return schedule


def step_size(learning_rate, count: int) -> float:
    """The step size of a constant ``learning_rate`` or of a schedule at
    update ``count``."""
    if callable(learning_rate):
        return learning_rate(count)
    return learning_rate
