"""SGD with optax semantics (the port of ``optax.sgd``).

``optax.sgd(lr, momentum)`` is ``trace(decay=momentum)`` followed by
``scale_by_learning_rate(lr)``:

    trace' = g + momentum * trace
    p'     = p + (-lr) * trace'

With ``nesterov=True`` (``optax.sgd(lr, momentum, nesterov=True)``, the
factory's ``"nag"``) the update is the look-ahead ``g + momentum *
trace'``.  ``learning_rate`` may be a schedule of the update count
(``optim/schedules.py``); the state then keeps the count (optax's
``ScaleByScheduleState``).

``torch.optim.SGD`` orders the same update differently (it scales by
``lr`` inside ``p.add_(buf, alpha=-lr)``), so the port keeps optax's op
order, each op rounded on its own.  Parameters and state are flat dicts
of tensors (with the ``[P, W]`` replica axes on the main path) or bucket
lists; the update is functional and returns new trees.  The fused
SGD-momentum kernel over the flat buckets is ``ops/optim.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from geomx_tpu_torch.optim.schedules import step_size
from geomx_tpu_torch.tree import tree_map


class SGD:
    """``optax.sgd(learning_rate, momentum, nesterov)`` as
    ``init``/``update``."""

    def __init__(self, learning_rate, momentum: Optional[float] = None,
                 nesterov: bool = False):
        self.learning_rate = learning_rate if callable(learning_rate) \
            else float(learning_rate)
        self.momentum = None if momentum is None else float(momentum)
        self.nesterov = bool(nesterov)

    def init(self, params: dict) -> dict:
        state = {}
        if self.momentum is not None:
            state["trace"] = tree_map(torch.zeros_like, params)
        if callable(self.learning_rate):
            state["count"] = 0
        return state

    def update(self, grads: dict, opt_state: dict,
               params: dict) -> Tuple[dict, dict]:
        """Returns ``(new_params, new_opt_state)``."""
        new_state = {}
        if self.momentum is None:
            updates = grads
        else:
            m = self.momentum
            trace = tree_map(lambda g, t: g + t * m, grads,
                             opt_state["trace"])
            updates = tree_map(lambda g, t: g + t * m, grads, trace) \
                if self.nesterov else trace
            new_state["trace"] = trace
        if callable(self.learning_rate):
            count = opt_state["count"]
            new_state["count"] = count + 1
            scale = -step_size(self.learning_rate, count)
        else:
            scale = -self.learning_rate
        return tree_map(lambda p, u: p + u * scale, params, updates), \
            new_state


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False) -> SGD:
    return SGD(learning_rate, momentum, nesterov)
