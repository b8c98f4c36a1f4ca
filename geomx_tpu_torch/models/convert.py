"""Weights from the JAX package's flax trees.

The port keeps flax's parameter names (as dotted paths) and layouts
(HWIO conv kernels, ``[in, out]`` dense kernels), so conversion is a
rename and a copy: no transposes.  Inputs are numpy arrays, as a caller
gets them from ``jax.device_get``; this module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
