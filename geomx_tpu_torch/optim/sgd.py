"""SGD with optax semantics (the port of ``optax.sgd``).

``optax.sgd(lr, momentum)`` is ``trace(decay=momentum)`` followed by
``scale_by_learning_rate(lr)``:

    trace' = g + momentum * trace
    p'     = p + (-lr) * trace'

``torch.optim.SGD`` orders the same update differently (it scales by
``lr`` inside ``p.add_(buf, alpha=-lr)``), so the port keeps optax's op
order, each op rounded on its own.  Parameters and state are flat dicts
of tensors (with the ``[P, W]`` replica axes on the main path); the
update is functional and returns new dicts.  The fused SGD-momentum
kernel (``ops/optim_pallas.py`` in the JAX package) is opt-in there and
is not ported yet (ROADMAP.md Queue 2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from geomx_tpu_torch.tree import tree_map


class SGD:
    """``optax.sgd(learning_rate, momentum)`` as ``init``/``update``."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None,
                 nesterov: bool = False):
        if nesterov:
            raise NotImplementedError(
                "nesterov momentum is not ported yet (ROADMAP.md Queue 1, "
                "item 4 'State, step, optimizer semantics')")
        self.learning_rate = float(learning_rate)
        self.momentum = None if momentum is None else float(momentum)

    def init(self, params: dict) -> dict:
        if self.momentum is None:
            return {}
        return {"trace": tree_map(torch.zeros_like, params)}

    def update(self, grads: dict, opt_state: dict,
               params: dict) -> Tuple[dict, dict]:
        """Returns ``(new_params, new_opt_state)``."""
        if self.momentum is None:
            updates = grads
        else:
            updates = tree_map(lambda g, t: g + t * self.momentum, grads,
                               opt_state["trace"])
            opt_state = {"trace": updates}
        scale = -self.learning_rate
        return tree_map(lambda p, u: p + u * scale, params, updates), \
            opt_state


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> SGD:
    return SGD(learning_rate, momentum, nesterov)
