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

Degraded-mode membership (``resilience/``): an algorithm that sets
``supports_degraded`` accepts a live-party mask through
``bind_membership``.  A dead party's dc-tier input is multiplied by its
0/1 weight (``party_weight``, a ``[P, 1, ...]`` tensor operand, so the
step has no branch per party) before the collective, and the mean
renormalizes over the ``num_live`` survivors.  The dead party's replicas
still run every op and kernel of the step: masking changes constants,
never collectives.  ``reset_comm_state`` applies the membership-change
residual policy.

Telemetry (``telemetry/probes.py``): ``telemetry_scalars`` returns an
algorithm's health values from its sync state, one ``[P, W]`` tensor a
value (party-local, as each JAX device holds them; the probe layer folds
them to the live-party mean), and ``wire_accounting`` the static bytes a
step puts on each tier's wire.
"""

from __future__ import annotations

import abc
import copy
import math
from typing import Any, List, Optional, Tuple

import torch


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
    # gradients.  Only replicated gradients feed the replicated-value
    # probes (telemetry/probes.py).
    grads_replicated_after_sync: bool = False

    # ZeRO-sharded weight update (train/zero.py, GEOMX_ZERO): algorithms
    # whose gradient sync has a bucket-shard form opt in with
    # supports_zero and implement sync_grad_shards.  None = the
    # replicated update.  Shard-shaped dc-tier state lives under the
    # "dc_comp" key of the sync state.
    zero_plan = None
    supports_zero: bool = False

    # degraded-mode membership (resilience/): None = every party live.
    # Set only through bind_membership; algorithms opt in with
    # supports_degraded (the mask changes the dc-tier algebra, and an
    # algorithm that ignored it would average in a dead party's stale
    # shard)
    live_parties: Optional[Tuple[bool, ...]] = None
    supports_degraded: bool = False

    def bind_topology(self, topology) -> "SyncAlgorithm":
        self.num_parties = topology.num_parties
        self.workers_per_party = topology.workers_per_party
        return self

    # ---- membership (degraded-mode WAN sync) -------------------------------

    def bind_membership(self, mask) -> "SyncAlgorithm":
        """Bind a live-party mask (a ``MembershipEpoch`` or any boolean
        sequence).  Call after ``bind_topology``; an all-live mask clears
        degraded mode.  A dead party's shard is excluded by
        multiplication to exact zeros before the dc collective and the
        mean renormalizes over the survivors (``Trainer.apply_membership``
        rebuilds the step around the new mask)."""
        from geomx_tpu_torch.topology import normalize_live_mask
        mask = normalize_live_mask(getattr(mask, "live_mask", mask),
                                   self.num_parties)
        self._party_weights = {}
        if all(mask):
            self.live_parties = None
            return self
        if not self.supports_degraded:
            raise ValueError(
                f"sync algorithm {self.name!r} does not support a "
                "degraded membership mask: its aggregation algebra has "
                "no renormalized-survivor form (FSA, MixedSync and "
                "PipelinedSync do)")
        self.live_parties = mask
        return self

    @property
    def num_live(self) -> int:
        """Parties contributing to the dc tier under the bound mask."""
        if self.live_parties is None:
            return self.num_parties
        return sum(self.live_parties)

    def party_weight(self, like: torch.Tensor) -> Optional[torch.Tensor]:
        """Each party's 0/1 contribution weight under the bound mask, as a
        float32 ``[P, 1, 1, ...]`` tensor on ``like``'s device that
        broadcasts against ``like`` (``[P, W, ...]``); None when every
        party is live.  Built once a bind and device: the JAX package's
        ``m[axis_index(dc)]``, as a tensor operand."""
        if self.live_parties is None:
            return None
        w = self._party_weights.get(like.device)
        if w is None:
            w = self._party_weights[like.device] = torch.tensor(
                self.live_parties, dtype=torch.float32,
                device=like.device).view(-1, 1)
        return w.view(w.shape + (1,) * (like.dim() - 2))

    def mask_parties(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` times its party's weight: a dead party's entries become
        exact zeros (signed, as the JAX product gives them); ``x`` itself
        when every party is live."""
        w = self.party_weight(x)
        return x if w is None else x * w

    def reset_comm_state(self, params: dict, state: Any,
                         policy: str = "reset") -> Any:
        """Apply the membership-change residual policy to the sync state:
        ``"reset"`` re-initializes dc-tier communication state
        (error-feedback residuals, pipeline double buffers), ``"carry"``
        keeps it.  ``params`` are ``[P, W]``-replicated, as
        ``init_state`` takes them.  Base: nothing to reset."""
        if policy not in ("reset", "carry"):
            raise ValueError(f"unknown residual policy {policy!r}: "
                             "expected 'reset' or 'carry'")
        return state

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

    # ---- telemetry (telemetry/probes.py) -----------------------------------

    def telemetry_scalars(self, state: Any) -> dict:
        """Health values from this algorithm's sync state, one ``[P, W]``
        tensor a value (party-local; the probe layer folds them to the
        live-party mean).  Called only when telemetry is on, so
        implementations are free to add reductions — the disabled step
        never runs them.  Base: nothing to report."""
        return {}

    def wire_accounting(self, params: dict) -> dict:
        """Static per-step wire-volume accounting (plain Python floats,
        resolved when the step is built) over ``[P, W]``-replicated
        ``params``: what each tier puts on the wire a step and a party,
        and the compression ratio against the dense payload.  Algorithms
        with a dc-tier compressor get the generic accounting."""
        out = {}
        dc = getattr(self, "dc_compressor", None)
        if dc is not None:
            dense = float(sum(math.prod(p.shape[2:]) * p.element_size()
                              for p in params.values()))
            if self.zero_plan is not None:
                # ZeRO (train/zero.py): a replica's dc payload is the
                # compressed 1/W bucket shard; the worker tier's
                # scatter/gather bytes ride along
                out.update(self.zero_plan.wire_accounting(params))
                wire = out.get("dc_wire_bytes", 0.0)
                # the per-party dense baseline shrinks with the shard too
                dense = dense / self.zero_plan.W
            else:
                wire = float(dc.wire_bytes(params))
            out["dc_wire_bytes"] = wire
            out["dc_dense_bytes"] = dense
            out["dc_compression_ratio"] = dense / wire if wire else 1.0
        wc = getattr(self, "worker_compressor", None)
        if wc is not None and self.zero_plan is None:
            out["worker_wire_bytes"] = float(wc.wire_bytes(params))
        return out
