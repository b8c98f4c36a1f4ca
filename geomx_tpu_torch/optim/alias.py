"""The rest of the JAX factory's optimizers, as optax builds them (port of
the ``optax`` aliases that geomx_tpu/optim/__init__.py returns):
``adamw``, ``rmsprop``, ``adagrad``, ``adadelta``, ``adamax``, ``nadam``
and ``lamb``.

Each is optax's chain of gradient transformations, with optax's
defaults and operation order (optax 0.2.6 ``_src/alias.py`` and
``_src/transform.py``): a transformation maps ``(updates, state,
params)`` to ``(updates, state)``, and :class:`Chain` applies its
transformations in order and adds the result to the params
(``optax.apply_updates``).  The state is a list with one dict a
transformation; counts are host ints.  Constants are Python doubles
that round to fp32 where they meet a tensor, as JAX's weak-typed
scalars do; each op is rounded on its own.

LAMB's trust ratio takes the norms of a whole parameter tensor.  On the
port's training path every leaf carries the leading ``[P, W]`` replica
axes (and under ZeRO a leaf is a bucket shard), so the norms are taken
over each replica slot's own tensor, as each device of the JAX
package's ``shard_map`` takes them.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from geomx_tpu_torch.optim.adam import (bias_correction, bias_corrections,
                                        device_scalars)
from geomx_tpu_torch.optim.schedules import step_size
from geomx_tpu_torch.tree import tree_map

# leading replica axes of every leaf the training step hands an optimizer
REPLICA_DIMS = 2


class Transform(NamedTuple):
    """An optax ``GradientTransformation``: ``init(params) -> state``,
    ``update(updates, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


class Chain:
    """``optax.chain(*transforms)`` with ``optax.apply_updates``, in the
    port's ``init``/``update(grads, opt_state, params) -> (new_params,
    new_opt_state)`` form."""

    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, params) -> List[dict]:
        return [t.init(params) for t in self.transforms]

    def update(self, grads, opt_state, params):
        updates, new_state = grads, []
        for t, s in zip(self.transforms, opt_state, strict=True):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return tree_map(lambda p, u: p + u, params, updates), new_state


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _moment(g, t, decay: float):
    """``(1 - decay) * g + decay * t``."""
    return g * (1.0 - decay) + t * decay


def _moment2(g, t, decay: float):
    """``(1 - decay) * g ** 2 + decay * t``."""
    return (g * g) * (1.0 - decay) + t * decay


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0, nesterov: bool = False) -> Transform:
    """``optax.scale_by_adam``; ``nesterov`` gives Nadam's look-ahead
    first moment ``b1 * mu'/bc1(t+1) + (1 - b1) * g/bc1(t)``."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params):
        count = state["count"] + 1
        mu = tree_map(lambda g, t: _moment(g, t, b1), updates, state["mu"])
        nu = tree_map(lambda g, t: _moment2(g, t, b2), updates, state["nu"])
        bc1, bc2 = bias_corrections(b1, b2, count)
        bc1n = bias_correction(b1, count + 1)
        cache = {}

        def direction(g, m, v):
            c1, c2, c1n = device_scalars(cache, m.device, bc1, bc2, bc1n)
            if nesterov:
                m_hat = (m / c1n) * b1 + (g / c1) * (1.0 - b1)
            else:
                m_hat = m / c1
            v_hat = v / c2
            if eps_root:
                v_hat = v_hat + eps_root
            return m_hat / (torch.sqrt(v_hat) + eps)

        return tree_map(direction, updates, mu, nu), \
            {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> Transform:
    """``optax.scale_by_adamax``: the infinity moment ``max(|g| + eps, b2
    * nu)``, no bias correction for it."""

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params):
        count = state["count"] + 1
        mu = tree_map(lambda g, t: _moment(g, t, b1), updates, state["mu"])
        nu = tree_map(lambda g, t: torch.maximum(g.abs() + eps, t * b2),
                      updates, state["nu"])
        cache = {}

        def direction(m, v):
            (c1,) = device_scalars(cache, m.device,
                                   bias_correction(b1, count))
            return (m / c1) / v

        return tree_map(direction, mu, nu), \
            {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0,
                 eps_in_sqrt: bool = True) -> Transform:
    """``optax.scale_by_rms`` (no bias correction): ``g * rsqrt(nu' +
    eps)``, or ``g / (sqrt(nu') + eps)`` with ``eps_in_sqrt=False``."""

    def init(params):
        return {"nu": tree_map(lambda p: torch.full_like(p, initial_scale),
                               params)}

    def update(updates, state, params):
        nu = tree_map(lambda g, t: _moment2(g, t, decay), updates,
                      state["nu"])
        if eps_in_sqrt:
            scale = tree_map(lambda n: torch.rsqrt(n + eps), nu)
        else:
            scale = tree_map(lambda n: 1.0 / (torch.sqrt(n) + eps), nu)
        return tree_map(lambda s, g: s * g, scale, updates), {"nu": nu}

    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Transform:
    """``optax.scale_by_rss`` (Adagrad): the running sum of squares ``t'
    = g ** 2 + t`` and ``g * rsqrt(t' + eps)`` where ``t' > 0``."""

    def init(params):
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value),
            params)}

    def update(updates, state, params):
        sq = tree_map(lambda g, t: g * g + t, updates,
                      state["sum_of_squares"])

        def scaled(g, t):
            inv = torch.where(t > 0, torch.rsqrt(t + eps),
                              torch.zeros_like(t))
            return inv * g

        return tree_map(scaled, updates, sq), {"sum_of_squares": sq}

    return Transform(init, update)


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6) -> Transform:
    """``optax.scale_by_adadelta``: ``u = sqrt(e_x + eps) / sqrt(e_g' +
    eps) * g``, then ``e_x' = (1 - rho) u ** 2 + rho e_x``."""

    def init(params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(updates, state, params):
        e_g = tree_map(lambda g, t: _moment2(g, t, rho), updates,
                       state["e_g"])
        updates = tree_map(
            lambda g, eg, ex: (torch.sqrt(ex + eps) / torch.sqrt(eg + eps))
            * g, updates, e_g, state["e_x"])
        e_x = tree_map(lambda u, t: _moment2(u, t, rho), updates,
                       state["e_x"])
        return updates, {"e_g": e_g, "e_x": e_x}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> Transform:
    """``optax.add_decayed_weights``: ``u + weight_decay * p`` (computed
    when the decay is 0 too, as optax does)."""

    def update(updates, state, params):
        return tree_map(lambda u, p: u + p * weight_decay, updates,
                        params), state

    return Transform(lambda params: {}, update)


def _slot_norms(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of each replica slot's tensor, broadcastable to x."""
    lead = x.shape[:REPLICA_DIMS]
    n = torch.linalg.vector_norm(x.reshape(lead + (-1,)), dim=-1)
    return n.reshape(lead + (1,) * (x.dim() - len(lead)))


def scale_by_trust_ratio() -> Transform:
    """``optax.scale_by_trust_ratio()`` (no norm clipping, coefficient 1,
    eps 0): ``u * |p| / |u|``, and ``u`` where either norm is zero."""

    def update(updates, state, params):
        def scaled(u, p):
            pn, un = _slot_norms(p), _slot_norms(u)
            ratio = pn * 1.0 / (un + 0.0)
            zero = (pn == 0.0) | (un == 0.0)
            return u * torch.where(zero, torch.ones_like(ratio), ratio)

        return tree_map(scaled, updates, params), state

    return Transform(lambda params: {}, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    """``optax.trace``: ``t' = g + decay * t``, the update ``t'`` or, with
    ``nesterov``, ``g + decay * t'``."""

    def init(params):
        return {"trace": _zeros(params)}

    def update(updates, state, params):
        t = tree_map(lambda g, t: g + t * decay, updates, state["trace"])
        out = tree_map(lambda g, t: g + t * decay, updates, t) \
            if nesterov else t
        return out, {"trace": t}

    return Transform(init, update)


def scale_by_learning_rate(learning_rate) -> Transform:
    """``optax.scale_by_learning_rate``: ``-lr * u``; a schedule is
    evaluated at the count before the increment, which the state
    keeps."""
    if not callable(learning_rate):
        lr = float(learning_rate)
        return Transform(
            lambda params: {},
            lambda updates, state, params: (
                tree_map(lambda u: u * -lr, updates), state))

    def update(updates, state, params):
        count = state["count"]
        lr = step_size(learning_rate, count)
        return tree_map(lambda u: u * -lr, updates), {"count": count + 1}

    return Transform(lambda params: {"count": 0}, update)


def _identity() -> Transform:
    return Transform(lambda params: {},
                     lambda updates, state, params: (updates, state))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> Chain:
    return Chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def nadam(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0) -> Chain:
    return Chain(scale_by_adam(b1, b2, eps, eps_root, nesterov=True),
                 scale_by_learning_rate(learning_rate))


def adamax(learning_rate, b1: float = 0.9, b2: float = 0.999,
           eps: float = 1e-8) -> Chain:
    return Chain(scale_by_adamax(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay: float = 0.9, eps: float = 1e-8,
            initial_scale: float = 0.0, eps_in_sqrt: bool = True,
            momentum: Optional[float] = None,
            nesterov: bool = False) -> Chain:
    return Chain(scale_by_rms(decay, eps, initial_scale, eps_in_sqrt),
                 scale_by_learning_rate(learning_rate),
                 trace(momentum, nesterov) if momentum is not None
                 else _identity())


def adagrad(learning_rate, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Chain:
    return Chain(scale_by_rss(initial_accumulator_value, eps),
                 scale_by_learning_rate(learning_rate))


def adadelta(learning_rate=None, rho: float = 0.9, eps: float = 1e-6,
             weight_decay: float = 0.0) -> Chain:
    return Chain(add_decayed_weights(weight_decay),
                 scale_by_adadelta(rho, eps),
                 scale_by_learning_rate(learning_rate)
                 if learning_rate is not None else _identity())


def lamb(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-6, eps_root: float = 0.0,
         weight_decay: float = 0.0) -> Chain:
    return Chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay),
                 scale_by_trust_ratio(),
                 scale_by_learning_rate(learning_rate))
