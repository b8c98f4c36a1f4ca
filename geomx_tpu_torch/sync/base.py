"""SyncAlgorithm protocol (port of geomx_tpu/sync/base.py).

A sync algorithm is a set of hooks around the optimizer step:
``forward_params`` (which parameters the gradients are taken at),
``sync_grads`` (gradient-space communication), ``sync_params``
(parameter-space communication) and ``sync_model_state`` (BatchNorm
statistics).  In the port every tensor they see carries the leading
``[P, W]`` replica axes, and the collectives are reductions over them.

Not ported yet, and raising ``NotImplementedError``: degraded-mode
membership (``bind_membership`` with a dead party), the ZeRO-sharded
update (``bind_zero``) and MultiGPS (ROADMAP.md Queue 1, items 2 and 6).
Nor are ``sync_grad_shards``, ``reset_comm_state``,
``telemetry_scalars`` and ``wire_accounting`` (items 2, 6 and 7).
"""

from __future__ import annotations

import abc
from typing import Any, Tuple


class SyncAlgorithm(abc.ABC):
    name: str = "base"

    num_parties: int = 1
    workers_per_party: int = 1

    # True when sync_grads returns a gradient replicated across the
    # [P, W] axes (hierarchical aggregation: FSA, MixedSync,
    # PipelinedSync); HFA's identity sync_grads keeps per-replica
    # gradients.  The telemetry probes that read it are not ported.
    grads_replicated_after_sync: bool = False

    def bind_topology(self, topology) -> "SyncAlgorithm":
        self.num_parties = topology.num_parties
        self.workers_per_party = topology.workers_per_party
        return self

    def bind_membership(self, mask) -> "SyncAlgorithm":
        """An all-live mask is accepted; a dead party is not ported."""
        from geomx_tpu_torch.topology import normalize_live_mask
        mask = normalize_live_mask(getattr(mask, "live_mask", mask),
                                   self.num_parties)
        if not all(mask):
            raise NotImplementedError(
                "degraded-mode membership is not ported yet (ROADMAP.md "
                "Queue 1, slice 3 'Resilience and utils')")
        return self

    def bind_zero(self, plan) -> "SyncAlgorithm":
        raise NotImplementedError(
            "the ZeRO-sharded update is not ported yet (ROADMAP.md Queue 1, "
            "slice 2 'Sharded updates')")

    def init_state(self, params: dict, model_state: Any = None) -> Any:
        """Algorithm state from ``[P, W]``-replicated example params."""
        return {}

    def forward_params(self, params: dict, state: Any) -> dict:
        return params

    def sync_grads(self, grads: dict, params: dict, state: Any,
                   step: int) -> Tuple[dict, Any]:
        return grads, state

    def sync_params(self, params: dict, state: Any,
                    step: int) -> Tuple[dict, Any]:
        return params, state

    def sync_model_state(self, model_state: dict, state: Any,
                         step: int) -> Tuple[dict, Any]:
        return model_state, state
