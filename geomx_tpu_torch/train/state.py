"""Replica-local training state (port of geomx_tpu/train/state.py).

Every state tensor carries the leading ``[num_parties,
workers_per_party]`` replica axes, exactly as the JAX state does: each
replica owns its own copy, and the sync algorithms are reductions over
those axes that re-align the copies.  Under FSA all copies stay
identical; ``unreplicate_tree`` takes copy (0, 0) for eval and
checkpoints, as the reference reads weights from rank 0.

On a device mesh (``topology.ReplicaMesh``) a state is placed, one copy
a slot with ``[1, 1, ...]`` tensors on the slot's device:
``mesh.place`` splits any tree, a ``TrainState`` included, and
``mesh.gather`` stacks it back, the counterparts of ``replicate_tree``
onto a mesh and of ``jax.device_get``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from geomx_tpu_torch.tree import tree_map


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict          # leaves [P, W, ...]
    opt_state: Any
    model_state: dict     # non-trainable state (BatchNorm statistics)
    sync_state: Any       # sync-algorithm state (compressor residuals)


def replicate_tree(tree: dict, topology, device) -> dict:
    """Every leaf copied to ``[P, W, *shape]`` on ``device``."""
    shape2 = topology.replica_shape

    def rep(x):
        x = torch.as_tensor(x, device=device)
        return x.expand(shape2 + tuple(x.shape)).contiguous()

    return tree_map(rep, tree)


def unreplicate_tree(tree: dict) -> dict:
    """Copy (party 0, worker 0) of every leaf."""
    return tree_map(lambda x: x[0, 0], tree)
