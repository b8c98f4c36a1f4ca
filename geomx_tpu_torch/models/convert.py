"""Weights and training state from the JAX package's trees.

The port keeps flax's parameter names (as dotted paths) and layouts
(HWIO conv kernels, ``[in, out]`` dense kernels), so conversion is a
rename and a copy: no transposes.  Inputs are numpy arrays, as a caller
gets them from ``jax.device_get``; this module imports nothing of JAX.
Besides the weights (:func:`from_flax`), the optimizer state
(:func:`opt_state_from_optax`) and the compressors' per-bucket residuals
(:func:`buckets_from_jax`) carry across, so both packages can start
mid-run from the same state.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from geomx_tpu_torch.tree import from_nested, leaf_names


def from_flax(params, batch_stats=None, device=None
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(flax ``params``, flax ``batch_stats``) -> (port params, port
    buffers), each a flat dict from dotted path to an fp32 tensor in the
    JAX leaf order.  ``device`` defaults to the CPU: this is a load
    step, and the caller places the result."""
    device = torch.device("cpu") if device is None else torch.device(device)

    def conv(tree):
        flat = from_nested(tree or {})
        return {k: torch.tensor(np.asarray(flat[k], np.float32),
                                device=device)
                for k in leaf_names(flat)}

    return conv(params), conv(batch_stats)


def load_flax(model: torch.nn.Module, params, batch_stats=None) -> None:
    """Copy flax weights into ``model`` in place; every parameter and
    buffer must be present with its flax shape."""
    p, b = from_flax(params, batch_stats)
    model.load_state_dict({**p, **b}, strict=True)


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def buckets_from_jax(buckets, device=None) -> List[torch.Tensor]:
    """A list of per-bucket arrays (the bucketed compressors' residuals,
    e.g. the 2-bit error feedback) -> fp32 tensors, shapes kept."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return [_tensor(b, device) for b in buckets]


def opt_state_from_optax(state, device=None) -> dict:
    """An optax state -> the port optimizer's state.

    ``state`` is ``optax.sgd``'s ``(TraceState, EmptyState)`` or
    ``optax.adam``'s ``(ScaleByAdamState, EmptyState)`` (a bare inner
    state works too) over a bucket list or a nested leaf tree, with
    numpy leaves.  Returns ``{"trace": tree}`` or ``{"count": int,
    "mu": tree, "nu": tree}``; a bucket list stays a list, a nested tree
    becomes a flat dict of dotted paths.  Shapes are kept (replica axes
    included); Adam's count (an int32, replicated or not) becomes the
    host int."""
    device = torch.device("cpu") if device is None else torch.device(device)
    parts = state if isinstance(state, (tuple, list)) and not hasattr(
        state, "_fields") else (state,)
    inner = next((s for s in parts if hasattr(s, "trace")
                  or hasattr(s, "mu")), None)
    if inner is None:
        raise ValueError(f"no TraceState or ScaleByAdamState in {state!r}")

    def conv(tree):
        if isinstance(tree, (list, tuple)):
            return buckets_from_jax(tree, device)
        flat = from_nested(tree)
        return {k: _tensor(flat[k], device) for k in leaf_names(flat)}

    if hasattr(inner, "trace"):
        return {"trace": conv(inner.trace)}
    count = int(np.asarray(inner.count).reshape(-1)[0])
    return {"count": count, "mu": conv(inner.mu), "nu": conv(inner.nu)}
