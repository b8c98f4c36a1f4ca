"""MixedSync — asynchronous global tier, with optional DCASGD compensation
(port of geomx_tpu/sync/mixed.py).

Reference semantics (README.md:36-40): the intra-party tier stays
synchronous, but local servers push to the global tier without a
barrier, so a party's gradient is computed at weights that are stale by
the other parties' in-flight updates.  DCASGD compensates: for gradient
``g`` pushed from stale weights ``w_stale`` and applied at the current
weights ``w``,

    g_compensated = g + lambda * g * g * (w - w_stale).

The emulation is the JAX package's: the true weights evolve identically
on every replica; each party holds a *stale copy* that it computes
gradients at (``forward_params``), refreshed every ``pull_interval``
steps (the asynchronous pull, a Python branch on the host step).  Each
step the global update applies the mean of all parties'
delay-compensated gradients.

Under a bound ZeRO plan (``train/zero.py``) ``sync_grad_shards``
scatters the bucketed party mean over the workers and computes the
DCASGD term shard-wise against each worker's slice of the true and stale
weights; the stale copy stays full and replicated (the forward runs at
it).  Under a membership mask the dc-tier mean renormalizes over the
survivors, as FSA's does.  ``telemetry_scalars`` reports the EF
residual and the stale copy's norm (telemetry/probes.py).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from geomx_tpu_torch.compression.base import Compressor, NoCompressor
from geomx_tpu_torch.compression.bucketing import maybe_bucketed
from geomx_tpu_torch.parallel.collectives import pmean, psum
from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.tree import leaf_names, tree_map


def dcasgd_term(g: torch.Tensor, w: torch.Tensor, w_stale: torch.Tensor,
                lam: float) -> torch.Tensor:
    """``g + lam * g * g * (w - w_stale)`` in the JAX package's op order
    (each product rounded on its own)."""
    return g + g * lam * g * (w - w_stale)


class MixedSync(SyncAlgorithm):
    name = "mixed"
    supports_degraded = True  # renormalized survivor mean (resilience/)
    grads_replicated_after_sync = True  # hierarchical psum output
    supports_zero = True  # bucket-shard form (train/zero.py)

    def __init__(self, dc_compressor: Optional[Compressor] = None,
                 pull_interval: int = 1, dcasgd_lambda: float = 0.0,
                 bucket_bytes: Optional[int] = None):
        if pull_interval < 1:
            raise ValueError("pull_interval must be >= 1")
        # the same dc-tier default as FSA: fused flat-bucket collectives
        # (GEOMX_BUCKET_BYTES=0 opts out)
        self.dc_compressor = maybe_bucketed(dc_compressor or NoCompressor(),
                                            bucket_bytes)
        self.pull_interval = int(pull_interval)
        self.dcasgd_lambda = float(dcasgd_lambda)

    def _dc_init(self, params: dict) -> Any:
        if self.zero_plan is not None:
            return self.dc_compressor.init_shard_state(params,
                                                       self.zero_plan.W)
        return self.dc_compressor.init_state(params)

    def init_state(self, params: dict, model_state: Any = None) -> Any:
        # the stale copy is a clone: the JAX package stores the
        # (immutable) params arrays themselves, and a PyTorch caller's
        # params may be written in place.  It stays full and replicated
        # under ZeRO: the forward runs at it
        return {"stale": tree_map(torch.clone, params),
                "dc_comp": self._dc_init(params)}

    def forward_params(self, params: dict, state: Any) -> dict:
        # parties train at their stale pull of the global weights
        return state["stale"]

    def sync_grads(self, grads: dict, params: dict, state: Any,
                   step: int) -> Tuple[dict, Any]:
        # the intra-party tier stays synchronous (dist_async still merges
        # the party's workers at the local server before the global push)
        if self.workers_per_party > 1:
            grads = tree_map(lambda g: pmean(g, WORKER_AXIS), grads)
        if self.dcasgd_lambda > 0.0:
            lam = self.dcasgd_lambda
            grads = tree_map(lambda g, w, ws: dcasgd_term(g, w, ws, lam),
                             grads, params, state["stale"])
        # degraded mode: exclude dead parties' shards and renormalize the
        # mean over the survivors, as FSA does
        if self.live_parties is not None:
            grads = tree_map(self.mask_parties, grads)
        np_ = self.num_parties
        grads, dstate = self.dc_compressor.allreduce(
            grads, state["dc_comp"], DC_AXIS, np_)
        nl = self.num_live
        if nl > 1:  # single-survivor configs skip the dead g/1 divide
            grads = tree_map(lambda g: g / nl, grads)
        return grads, dict(state, dc_comp=dstate)

    def sync_grad_shards(self, grads: dict, params: dict, state: Any,
                         step: int) -> Tuple[list, Any]:
        """The ZeRO form of :meth:`sync_grads`: the worker-tier
        psum_scatter of the fused buckets, the DCASGD term computed
        shard-wise against each worker's slice of the true and stale
        weights (both replicated, so the slice is free), then the
        per-shard compressed dc tier."""
        plan = self.zero_plan
        leaves = [grads[k] for k in leaf_names(grads)]
        bk = self.dc_compressor.zero_bucketer(leaves)
        shards = [plan.scatter_bucket(b, WORKER_AXIS)
                  for b in bk.flatten(leaves)]
        if self.dcasgd_lambda > 0.0:
            lam = self.dcasgd_lambda
            p_sh = plan.tree_shards(params, bk)
            s_sh = plan.tree_shards(state["stale"], bk)
            shards = [dcasgd_term(g, w, ws, lam)
                      for g, w, ws in zip(shards, p_sh, s_sh)]
        shards = [self.mask_parties(g) for g in shards]
        np_ = self.num_parties
        shards, dstate = self.dc_compressor.allreduce_shards(
            shards, state["dc_comp"], DC_AXIS, np_, bk)
        nl = self.num_live
        if nl > 1:
            shards = [g / nl for g in shards]
        return shards, dict(state, dc_comp=dstate)

    def sync_params(self, params: dict, state: Any,
                    step: int) -> Tuple[dict, Any]:
        # the asynchronous pull: refresh the stale copy every
        # pull_interval steps (a clone, as in init_state)
        if (step + 1) % self.pull_interval == 0:
            state = dict(state, stale=tree_map(torch.clone, params))
        return params, state

    def sync_model_state(self, model_state: dict, state: Any,
                         step: int) -> Tuple[dict, Any]:
        if not model_state:
            return model_state, state
        if self.workers_per_party > 1:
            model_state = tree_map(lambda x: pmean(x, WORKER_AXIS),
                                   model_state)
        if self.num_parties > 1:
            if self.live_parties is None:
                model_state = tree_map(lambda x: pmean(x, DC_AXIS),
                                       model_state)
            else:
                nl = self.num_live
                model_state = tree_map(
                    lambda x: psum(self.mask_parties(x), DC_AXIS) / nl,
                    model_state)
        return model_state, state

    def reset_comm_state(self, params: dict, state: Any,
                         policy: str = "reset") -> Any:
        """FSA's policy: ``"reset"`` re-initializes the dc-tier
        compressor state; the stale pull copy always carries (it tracks
        the true weights, which survive a membership change)."""
        state = super().reset_comm_state(params, state, policy)
        if policy == "carry":
            return state
        return dict(state, dc_comp=self._dc_init(params))

    def telemetry_scalars(self, state: Any) -> dict:
        """EF residual magnitude plus the stale copy's norm: the distance
        DCASGD compensates grows with the gap between the true weights'
        refresh and the copy the party trains at (telemetry/probes.py;
        enabled path only).  ``[P, W]`` tensors."""
        from geomx_tpu_torch.telemetry.probes import replica_norms
        P, W = self.num_parties, self.workers_per_party
        return {"ef_residual_norm": replica_norms(state["dc_comp"], P, W),
                "stale_copy_norm": replica_norms(state["stale"], P, W)}
