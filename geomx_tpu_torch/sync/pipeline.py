"""Pipelined WAN sync: double-buffered staleness-1 dc-tier collectives
(port of geomx_tpu/sync/pipeline.py).

Step *t* launches the compressed dc-tier all-reduce on step *t*'s
party-mean gradients, and the optimizer applies step *t-1*'s completed
aggregate, held in a double buffer inside ``sync_state`` (on the
bucketed engine's flat fp32 layout, or one leaf-shaped buffer a leaf
with bucketing off).  Semantics: staleness-1 data parallelism,

    w_{t+1} = w_t - lr * g_global(w_{t-1}).

The first step applies a zero aggregate (the warm-up bubble); every
gradient is applied exactly once, one step late, and
``Trainer.drain_pipeline`` applies the last one.  The optional DCASGD
term re-centres the stale aggregate at the weights it is applied to,
``g + lambda * g * g * (w_t - w_{t-1})``, with ``w_{t-1}`` kept in
``sync_state`` (one params copy, only when ``lambda > 0``).  A
staleness-1 gradient roughly halves the stable learning-rate headroom.

The model-state sync (BatchNorm statistics) is double-buffered as a
whole: each step launches the worker and dc means of its fresh
statistics into the buffer and applies the previous step's.  The buffer
is seeded with the initial statistics.

The JAX package pins the flattened party mean with
``lax.optimization_barrier`` so XLA cannot fuse across the tier
boundary.  Eager PyTorch runs the ops in program order and has no
counterpart; the ``dc_pipeline/launch`` and ``dc_pipeline/apply`` spans
stay, as ``record_function``.

Composes with FSA and MixedSync by wrapping their dc-tier compressor;
HFA is rejected (its global tier already fires off the critical path,
and a stale milestone delta would corrupt the milestone algebra).  Under
a bound ZeRO plan the in-flight buffers hold ``1/W`` bucket shards
(``init_shard_state``, ``allreduce_shards``, ``peek_shards``) and the
drain returns the parked shard aggregates (``drain_grad_shards``);
``GEOMX_PIPELINE_DCASGD`` is rejected there.  Not ported yet:
``reset_comm_state`` and membership (ROADMAP.md Queue 1, "Resilience
and utils"), ``telemetry_scalars``, ``wire_accounting`` and the in-flight
byte counter ("Telemetry").
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional, Tuple

import torch
from torch.profiler import record_function

from geomx_tpu_torch.compression.base import Compressor
from geomx_tpu_torch.compression.bucketing import BucketedCompressor
from geomx_tpu_torch.parallel.collectives import pmean
from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.sync.mixed import dcasgd_term
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.tree import leaf_names, tree_map


def _resolve_depth(depth: Optional[int]) -> int:
    if depth is not None:
        return int(depth)
    raw = os.environ.get("GEOMX_PIPELINE_DEPTH")
    return int(float(raw)) if raw else 1


class PipelinedCompressor(Compressor):
    """Double-buffer any dc-tier compressor.

    ``allreduce`` launches the wrapped collective on this step's
    gradients, parks the result in its state, and returns the previous
    step's completed aggregate.  The parked aggregates are tensors the
    wrapped collective allocated; nothing writes them in place.
    """

    fuses_tree = True  # tree-level: never wrap in bucketing again

    def __init__(self, inner: Compressor):
        if isinstance(inner, PipelinedCompressor):
            raise ValueError("dc-tier compressor is already pipelined; "
                             "double-wrapping would add a second step of "
                             "staleness")
        self.inner = inner
        self.name = inner.name
        self._bucketed = isinstance(inner, BucketedCompressor)

    def _leaves(self, tree: dict):
        names = leaf_names(tree)
        return names, [tree[k] for k in names]

    def init_state(self, grads: dict) -> Any:
        _, leaves = self._leaves(grads)
        if self._bucketed:
            bk = self.inner._bucketer(leaves)
            lead = tuple(leaves[0].shape[:2])
            inflight = [torch.zeros(lead + (n,), dtype=torch.float32,
                                    device=leaves[0].device)
                        for n in bk.bucket_sizes]
        else:
            inflight = [torch.zeros_like(leaf) for leaf in leaves]
        return {"inflight": inflight, "inner": self.inner.init_state(grads)}

    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        raise NotImplementedError(
            "PipelinedCompressor is tree-level (the in-flight buffer "
            "spans the whole gradient); per-leaf state is not supported")

    def init_shard_state(self, grads: dict, num_shards: int) -> Any:
        """ZeRO: the in-flight double buffer holds ``1/W`` bucket shards
        ``[P, W, n / W]``, so the parked aggregate shrinks with the
        worker axis as the optimizer state does."""
        if not self._bucketed:
            raise ValueError(
                "GEOMX_ZERO requires the bucketed dc-tier engine under "
                "the pipelined compressor (GEOMX_BUCKET_BYTES > 0)")
        _, leaves = self._leaves(grads)
        bk = self.inner._bucketer(leaves)
        lead = tuple(leaves[0].shape[:2])
        inflight = [torch.zeros(lead + (n // num_shards,),
                                dtype=torch.float32, device=leaves[0].device)
                    for n in bk.bucket_sizes]
        return {"inflight": inflight,
                "inner": self.inner.init_shard_state(grads, num_shards)}

    def zero_bucketer(self, leaves):
        return self.inner.zero_bucketer(leaves)

    def allreduce_shards(self, shards, state: Any, axis_name: str,
                         axis_size: int, bk) -> Tuple[list, Any]:
        """The double-buffered ZeRO dc tier: launch this step's per-shard
        compressed collectives and return the previous step's completed
        shard aggregates."""
        with record_function(f"{axis_name}_pipeline/launch"):
            launched, inner_state = self.inner.allreduce_shards(
                shards, state["inner"], axis_name, axis_size, bk)
        with record_function(f"{axis_name}_pipeline/apply"):
            out = list(state["inflight"])
        return out, {"inflight": launched, "inner": inner_state}

    def peek_shards(self, state: Any) -> Tuple[list, Any]:
        """The completed in-flight shard aggregates, and the state with
        the buffer zeroed: the ZeRO drain path."""
        prev = state["inflight"]
        zeroed = [torch.zeros_like(b) for b in prev]
        return list(prev), dict(state, inflight=zeroed)

    def allreduce(self, grads: dict, state: Any, axis_name: str,
                  axis_size: int) -> Tuple[dict, Any]:
        names, leaves = self._leaves(grads)
        if not leaves:
            return grads, state
        prev = state["inflight"]
        if self._bucketed:
            bk = self.inner._bucketer(leaves)
            buckets = bk.flatten(leaves)
            with record_function(f"{axis_name}_pipeline/launch"):
                launched, inner_state = self.inner.allreduce_buckets(
                    buckets, state["inner"], axis_name, axis_size, bk)
            with record_function(f"{axis_name}_pipeline/apply"):
                out = dict(zip(names, bk.unflatten(prev)))
        else:
            with record_function(f"{axis_name}_pipeline/launch"):
                launched_tree, inner_state = self.inner.allreduce(
                    grads, state["inner"], axis_name, axis_size)
            launched = [launched_tree[k] for k in names]
            with record_function(f"{axis_name}_pipeline/apply"):
                out = dict(zip(names, prev))
        return out, {"inflight": launched, "inner": inner_state}

    def allreduce_leaf(self, g, state, axis_name, axis_size):
        raise NotImplementedError(
            "PipelinedCompressor is tree-level; the per-leaf path "
            "(MultiGPS) does not compose with pipelining")

    def peek(self, grads_like: dict, state: Any) -> Tuple[dict, Any]:
        """The completed in-flight aggregate as a gradient tree, and the
        state with the buffer zeroed: the drain path."""
        names, leaves = self._leaves(grads_like)
        prev = state["inflight"]
        if self._bucketed:
            out = dict(zip(names, self.inner._bucketer(leaves)
                           .unflatten(prev)))
        else:
            out = dict(zip(names, prev))
        zeroed = [torch.zeros_like(b) for b in prev]
        return out, dict(state, inflight=zeroed)

    # the same bytes a step as the wrapped path, one step late
    def wire_bytes(self, grads: dict) -> int:
        return self.inner.wire_bytes(grads)

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        return self.inner.wire_bytes_leaf(leaf)


class PipelinedSync(SyncAlgorithm):
    """Staleness-1 pipelined wrapper around FSA or MixedSync: opt in with
    ``GEOMX_PIPELINE_DEPTH=1`` (``get_sync_algorithm``) or wrap
    explicitly, ``PipelinedSync(FSA(...), dcasgd_lambda=0.04)``."""

    # the applied gradient is the previous step's completed dc aggregate
    grads_replicated_after_sync = True

    def __init__(self, inner: SyncAlgorithm, depth: Optional[int] = None,
                 dcasgd_lambda: float = 0.0):
        from geomx_tpu_torch.sync.fsa import FSA
        from geomx_tpu_torch.sync.mixed import MixedSync
        if not isinstance(inner, (FSA, MixedSync)):
            raise ValueError(
                "GEOMX_PIPELINE_DEPTH composes with sync_mode=fsa or "
                f"mixed only, not {getattr(inner, 'name', type(inner).__name__)!r}: "
                "HFA's global tier already fires off the critical path "
                "every K1*K2 steps (a stale delta would corrupt the "
                "milestone algebra), and other algorithms have no "
                "per-step dc-tier collective to double-buffer")
        depth = _resolve_depth(depth)
        if depth != 1:
            raise ValueError(
                f"GEOMX_PIPELINE_DEPTH={depth} unsupported: only depth 1 "
                "(double buffering, staleness 1) is implemented — deeper "
                "pipelines need a ring buffer and staleness-k "
                "compensation, and hide no additional latency once the "
                "DCN round trip fits inside one step of compute")
        # a shallow copy: installing the pipelined compressor must not
        # make the caller's algorithm (perhaps a synchronous baseline)
        # staleness-1 too; compressors keep their state in sync_state,
        # so sharing them is safe
        self.inner = copy.copy(inner)
        self.depth = depth
        self.dcasgd_lambda = float(dcasgd_lambda)
        self.name = f"pipelined_{inner.name}"
        if not isinstance(self.inner.dc_compressor, PipelinedCompressor):
            self.inner.dc_compressor = PipelinedCompressor(
                self.inner.dc_compressor)

    def bind_topology(self, topology) -> "PipelinedSync":
        super().bind_topology(topology)
        self.inner.bind_topology(topology)
        return self

    # -- the ZeRO-sharded update (train/zero.py) ------------------------------
    supports_zero = True

    def bind_zero(self, plan) -> "PipelinedSync":
        """Bind the ZeRO plan through to the wrapped algorithm, which
        owns the shard-form sync; the pipelined compressor double-buffers
        shard-sized aggregates.  A copy, as the base contract.  The
        pipeline's DCASGD term is rejected: its previous-weights copy has
        no shard-local form, and a full copy would forfeit the 1/W
        memory the mode exists for."""
        if self.dcasgd_lambda > 0.0:
            raise ValueError(
                "GEOMX_ZERO does not compose with GEOMX_PIPELINE_DCASGD: "
                "the compensation's prev-params copy has no shard-local "
                "form; disable one of the two")
        bound = copy.copy(self)
        bound.inner = self.inner.bind_zero(plan)
        bound.zero_plan = plan
        return bound

    def sync_grad_shards(self, grads: dict, params: dict, state: Any,
                         step: int) -> Tuple[list, Any]:
        # the wrapped algorithm's shard-form sync over a pipelined dc
        # tier: the shards are the previous step's aggregates, divided
        shards, inner_state = self.inner.sync_grad_shards(
            grads, params, state["inner"], step)
        return shards, dict(state, inner=inner_state)

    def drain_grad_shards(self, params: dict,
                          state: Any) -> Tuple[list, Any]:
        """The ZeRO drain: the completed in-flight shard aggregates,
        divided as ``sync_grad_shards`` would have, with the buffer
        zeroed.  No collectives; ``ZeroPlan.apply_shard_update`` then
        runs the all_gather that rebuilds the params."""
        comp = self.inner.dc_compressor
        shards, dc_state = comp.peek_shards(state["inner"]["dc_comp"])
        np_ = self.num_parties
        if np_ > 1:
            shards = [g / np_ for g in shards]
        return shards, dict(state,
                            inner=dict(state["inner"], dc_comp=dc_state))

    def init_state(self, params: dict, model_state: Any = None) -> Any:
        state = {"inner": self.inner.init_state(params)}
        if self.dcasgd_lambda > 0.0:
            # the weights the in-flight gradient was computed at (a
            # clone, where the JAX package keeps the immutable arrays)
            state["prev_params"] = tree_map(torch.clone, params)
        if self.num_parties > 1 and model_state:
            # seed the model-state double buffer with the initial stats
            # (identical on every replica), not zeros: the first applied
            # buffer must be a valid BatchNorm state
            state["inflight_ms"] = tree_map(torch.clone, model_state)
        return state

    def forward_params(self, params: dict, state: Any) -> dict:
        return self.inner.forward_params(params, state["inner"])

    def sync_grads(self, grads: dict, params: dict, state: Any,
                   step: int) -> Tuple[dict, Any]:
        # the inner algorithm runs unmodified; its dc-tier compressor is
        # pipelined, so `g` is the previous step's aggregate, already
        # tier-divided
        g, inner_state = self.inner.sync_grads(grads, params,
                                               state["inner"], step)
        new_state = dict(state, inner=inner_state)
        if self.dcasgd_lambda > 0.0:
            lam = self.dcasgd_lambda
            g = tree_map(lambda gg, w, wp: dcasgd_term(gg, w, wp, lam),
                         g, params, state["prev_params"])
            # the aggregate in flight was computed at THIS step's forward
            # weights (MixedSync: its stale pull, not the true weights);
            # kept as a clone, as in init_state
            new_state["prev_params"] = tree_map(
                torch.clone, self.inner.forward_params(params, inner_state))
        return g, new_state

    def sync_params(self, params: dict, state: Any,
                    step: int) -> Tuple[dict, Any]:
        params, inner_state = self.inner.sync_params(params, state["inner"],
                                                     step)
        return params, dict(state, inner=inner_state)

    def sync_model_state(self, model_state: dict, state: Any,
                         step: int) -> Tuple[dict, Any]:
        if not model_state:
            return model_state, state
        if "inflight_ms" not in state:
            # no buffer (one party, or init_state never saw the model
            # state): the inner synchronous path
            ms, inner_state = self.inner.sync_model_state(
                model_state, state["inner"], step)
            return ms, dict(state, inner=inner_state)
        # both stat tiers feed the buffer; the applied value is the
        # previous step's fully aggregated statistics
        if self.workers_per_party > 1:
            model_state = tree_map(lambda x: pmean(x, WORKER_AXIS),
                                   model_state)
        launched = tree_map(lambda x: pmean(x, DC_AXIS), model_state)
        return state["inflight_ms"], dict(state, inflight_ms=launched)

    def drain_grads(self, params: dict, state: Any) -> Tuple[dict, Any]:
        """The gradient tree of one drain step: the completed in-flight
        aggregate, tier-divided and compensated as ``sync_grads`` would
        have, with the buffer zeroed.  No collectives: the buffer holds
        reduced values."""
        comp = self.inner.dc_compressor
        g, dc_state = comp.peek(params, state["inner"]["dc_comp"])
        np_ = self.num_parties
        if np_ > 1:
            g = tree_map(lambda x: x / np_, g)
        new_state = dict(state, inner=dict(state["inner"], dc_comp=dc_state))
        if self.dcasgd_lambda > 0.0:
            lam = self.dcasgd_lambda
            g = tree_map(lambda gg, w, wp: dcasgd_term(gg, w, wp, lam),
                         g, params, state["prev_params"])
        return g, new_state

    def drain_model_state(self, model_state: dict,
                          state: Any) -> Tuple[dict, Any]:
        """The model-state half of a drain step: apply the parked dc-tier
        statistics.  The buffer keeps the applied value, the seeding a
        fresh init gets."""
        if "inflight_ms" not in state:
            return model_state, state
        parked = state["inflight_ms"]
        return parked, dict(state, inflight_ms=tree_map(torch.clone, parked))
