"""Adam with optax semantics (the port of ``optax.adam``).

``optax.adam(lr, b1, b2, eps)`` is ``scale_by_adam`` followed by
``scale_by_learning_rate(lr)``:

    mu'    = (1 - b1) * g + b1 * mu
    nu'    = (1 - b2) * (g * g) + b2 * nu
    count' = count + 1
    u      = (mu' / bc1) / (sqrt(nu' / bc2) + eps),  bc = 1 - b ** count'
    p'     = p + (-lr) * u

``eps`` stays outside the square root; ``eps_root`` (default 0) adds
inside it, ``sqrt(nu' / bc2 + eps_root)``.  ``learning_rate`` may be a
schedule of the update count (``optim/schedules.py``), evaluated at the
count before the increment, as optax's ``scale_by_schedule`` does.  ``torch.optim.Adam`` orders the
same update differently (it folds the bias corrections into the step
size and ``eps``), so the port keeps optax's op order, each op rounded
on its own.  The constants ``1 - b1``, ``1 - b2``, ``lr`` and ``eps``
are Python doubles rounded once to fp32, as JAX rounds weak-typed
scalars, and the bias corrections are the fp32 values JAX computes on
the device (:func:`bias_corrections`).  The step count is a host int.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geomx_tpu_torch.optim.schedules import step_size
from geomx_tpu_torch.tree import tree_map


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` as JAX computes it in fp32 on the device:
    the fp32 ``decay`` raised to ``count`` and rounded once to fp32
    (XLA's ``pow`` is correctly rounded there, which a double power
    reproduces), then one fp32 subtract.  Returned as a Python float
    that holds an fp32 value exactly."""
    power = np.float32(float(np.float32(decay)) ** int(count))
    return float(np.float32(1.0) - power)


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    return bias_correction(b1, count), bias_correction(b2, count)


def adam_moments(g, mu, nu, b1: float, b2: float):
    """``(mu', nu')``: separate tensor ops, so no multiply-add contracts
    into an FMA on any device."""
    mu2 = g * (1.0 - b1) + mu * b1
    nu2 = (g * g) * (1.0 - b2) + nu * b2
    return mu2, nu2


def adam_direction(mu2, nu2, bc1, bc2, eps: float, eps_root: float = 0.0):
    """``(mu'/bc1) / (sqrt(nu'/bc2 + eps_root) + eps)``.  ``bc1``/``bc2``
    are 0-d tensors on the moments' device: PyTorch divides a CUDA
    tensor by a host scalar as a multiply by its reciprocal, which rounds
    differently."""
    nu_hat = nu2 / bc2
    if eps_root:
        nu_hat = nu_hat + eps_root
    return (mu2 / bc1) / (torch.sqrt(nu_hat) + eps)


def device_scalars(cache: dict, device, *values) -> list:
    """0-d fp32 tensors of ``values`` on ``device``, made once a device
    (``cache`` maps device -> tensors)."""
    if device not in cache:
        cache[device] = [torch.full((), v, dtype=torch.float32,
                                    device=device) for v in values]
    return cache[device]


class Adam:
    """``optax.adam(learning_rate, b1, b2, eps, eps_root)`` as
    ``init``/``update`` over a flat dict of tensors or a bucket list.
    State: ``{"count": int, "mu": tree, "nu": tree}``."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate = learning_rate if callable(learning_rate) \
            else float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.eps_root = float(eps_root)

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, opt_state: dict, params):
        """Returns ``(new_params, new_opt_state)``."""
        count = opt_state["count"] + 1
        bc1, bc2 = bias_corrections(self.b1, self.b2, count)
        moments = tree_map(
            lambda g, mu, nu: adam_moments(g, mu, nu, self.b1, self.b2),
            grads, opt_state["mu"], opt_state["nu"])
        mu = tree_map(lambda m: m[0], moments)
        nu = tree_map(lambda m: m[1], moments)
        scalars = {}
        lr = step_size(self.learning_rate, count - 1)

        def apply(p, mu2, nu2):
            u = adam_direction(mu2, nu2,
                               *device_scalars(scalars, p.device, bc1, bc2),
                               self.eps, self.eps_root)
            return p + u * -lr

        return tree_map(apply, params, mu, nu), \
            {"count": count, "mu": mu, "nu": nu}


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root)
