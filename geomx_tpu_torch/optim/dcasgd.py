"""DCASGD — Delay-Compensated Async SGD (port of geomx_tpu/optim/dcasgd.py).

Reference: python/mxnet/optimizer/optimizer.py:872-925 — a per-parameter
previous-weight copy and the update

    grad += wd * weight
    mom   = momentum * mom - lr * (grad + lamda * grad*grad * (weight - previous_weight))
    weight += mom
    previous_weight = weight

The JAX package writes it as an optax transformation whose update is the
new momentum; the port keeps that op order, each op rounded on its own
(``g + wd*w`` is computed even when ``wd`` is 0, as the reference does),
and applies the update in the port's ``init``/``update(grads, opt_state,
params) -> (new_params, new_opt_state)`` form.  The constants are Python
doubles rounded once to fp32, as JAX rounds weak-typed scalars.  MXNet
defaults: momentum 0.0, lamda 0.04.
"""

from __future__ import annotations

from typing import Tuple

import torch

from geomx_tpu_torch.tree import tree_map


class DCASGD:
    """``dcasgd(learning_rate, momentum, lamda, weight_decay)``.  State:
    ``{"momentum": tree, "previous_weights": tree}``."""

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 lamda: float = 0.04, weight_decay: float = 0.0):
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.lamda = float(lamda)
        self.weight_decay = float(weight_decay)

    def init(self, params: dict) -> dict:
        # the previous weights are a private copy: params may be replaced
        # by tensors that later steps reuse
        return {"momentum": tree_map(torch.zeros_like, params),
                "previous_weights": tree_map(torch.clone, params)}

    def update(self, grads: dict, opt_state: dict,
               params: dict) -> Tuple[dict, dict]:
        """Returns ``(new_params, new_opt_state)``."""
        lr, lam = self.learning_rate, self.lamda

        def one(g, m, w, pw):
            g = g + w * self.weight_decay
            return m * self.momentum - (g + g * lam * g * (w - pw)) * lr

        mom = tree_map(one, grads, opt_state["momentum"], params,
                       opt_state["previous_weights"])
        # optax.apply_updates: p + u; previous_weight tracks w + m, a
        # tensor of its own
        def step(w, m):
            return w + m

        return tree_map(step, params, mom), {
            "momentum": mom,
            "previous_weights": tree_map(step, params, mom)}


def dcasgd(learning_rate: float = 0.01, momentum: float = 0.0,
           lamda: float = 0.04, weight_decay: float = 0.0) -> DCASGD:
    return DCASGD(learning_rate, momentum, lamda, weight_decay)
