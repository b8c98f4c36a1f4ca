"""SyncAlgorithm protocol (port of geomx_tpu/sync/base.py).

A sync algorithm is a set of hooks around the optimizer step:
``forward_params`` (which parameters the gradients are taken at),
``sync_grads`` (gradient-space communication), ``sync_params``
(parameter-space communication) and ``sync_model_state`` (BatchNorm
statistics).  In the port every tensor they see carries the leading
``[P, W]`` replica axes, and the collectives are reductions over them.

The ZeRO-sharded update (``train/zero.py``): an algorithm that sets
``supports_zero`` implements ``sync_grad_shards``, and ``bind_zero``
returns a bound copy whose dc-tier compressor is a private copy
re-padded for the shards.  Shard-shaped dc-tier state lives under the
``"dc_comp"`` key of the sync state.

Not ported yet, and raising ``NotImplementedError``: degraded-mode
membership (``bind_membership`` with a dead party, ROADMAP.md Queue 1,
"Resilience and utils").  Nor are ``reset_comm_state`` (the same item),
``telemetry_scalars`` and ``wire_accounting`` ("Telemetry").
"""

from __future__ import annotations

import abc
import copy
from typing import Any, List, Tuple


def _private_dc_copy(dc_compressor):
    """A shallow copy of a dc-tier compressor stack, so ``bind_zero``'s
    re-padding (``pad_to``, the cached bucket layouts) lands on a private
    instance: the caller's compressor may still back a replicated run
    whose layout must not shift under it."""
    from geomx_tpu_torch.compression.bucketing import BucketedCompressor
    from geomx_tpu_torch.sync.pipeline import PipelinedCompressor
    dc = copy.copy(dc_compressor)
    bucketed = dc
    if isinstance(dc, PipelinedCompressor):
        dc.inner = copy.copy(dc.inner)
        bucketed = dc.inner
    if isinstance(bucketed, BucketedCompressor):
        bucketed._bucketers = {}  # never share the layout cache
    return dc


class SyncAlgorithm(abc.ABC):
    name: str = "base"

    num_parties: int = 1
    workers_per_party: int = 1

    # True when sync_grads returns a gradient replicated across the
    # [P, W] axes (hierarchical aggregation: FSA, MixedSync,
    # PipelinedSync); HFA's identity sync_grads keeps per-replica
    # gradients.  The telemetry probes that read it are not ported.
    grads_replicated_after_sync: bool = False

    # ZeRO-sharded weight update (train/zero.py, GEOMX_ZERO): algorithms
    # whose gradient sync has a bucket-shard form opt in with
    # supports_zero and implement sync_grad_shards.  None = the
    # replicated update.  Shard-shaped dc-tier state lives under the
    # "dc_comp" key of the sync state.
    zero_plan = None
    supports_zero: bool = False

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
                "Queue 1, 'Resilience and utils')")
        return self

    def bind_zero(self, plan) -> "SyncAlgorithm":
        """A copy of this algorithm bound to a
        :class:`~geomx_tpu_torch.train.zero.ZeroPlan`: the gradient sync
        switches to the bucket-shard form and the dc-tier state becomes
        shard-shaped.  Never mutates ``self``: binding re-pads the dc
        compressor's bucket layout, and the caller's algorithm may also
        drive a replicated run.  An algorithm without a shard form (HFA)
        is rejected."""
        if not self.supports_zero:
            raise ValueError(
                f"sync algorithm {self.name!r} does not support the "
                "ZeRO-sharded weight update (GEOMX_ZERO): its "
                "aggregation has no bucket-shard form (FSA, MixedSync "
                "and PipelinedSync do)")
        bound = copy.copy(self)
        bound.dc_compressor = _private_dc_copy(self.dc_compressor)
        plan.bind_compressor(bound.dc_compressor)
        bound.zero_plan = plan
        return bound

    def sync_grad_shards(self, grads: dict, params: dict, state: Any,
                         step: int) -> Tuple[List, Any]:
        """ZeRO gradient sync: (the global-mean flat bucket shards, each
        replica's ``1/W`` slice of every bucket, ``[P, W, n / W]``; the
        new sync state).  Called only with a zero plan bound."""
        raise NotImplementedError(
            f"{self.name!r} bound a zero plan but implements no "
            "sync_grad_shards")

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
