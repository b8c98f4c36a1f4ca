"""FSA — Fully Synchronous Algorithm (port of geomx_tpu/sync/fsa.py).

One hierarchical compressed all-reduce per step:

    g_party  = psum(g, "worker") / workers_per_party      (intra-party tier)
    g_global = dc_compressor.allreduce(g_party, "dc") / P (cross-party tier)

followed by an optimizer step applied identically on every replica.  By
default the dc compressor is wrapped in the bucketed engine
(compression/bucketing.py); ``GEOMX_BUCKET_BYTES=0`` opts out.  The
pipelined form is ``sync/pipeline.py``.  Under a bound ZeRO plan
(``train/zero.py``) ``sync_grad_shards`` runs the same hierarchy on
``1/W`` bucket shards.  The degraded-membership form (a dead party's
weight) is not ported yet (ROADMAP.md Queue 1, "Resilience and
utils").
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from geomx_tpu_torch.compression.base import Compressor, NoCompressor
from geomx_tpu_torch.compression.bucketing import maybe_bucketed
from geomx_tpu_torch.parallel.collectives import pmean
from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.tree import leaf_names, tree_map


class FSA(SyncAlgorithm):
    name = "fsa"
    grads_replicated_after_sync = True  # hierarchical psum output
    supports_zero = True  # bucket-shard form of the same hierarchy

    def __init__(self, dc_compressor: Optional[Compressor] = None,
                 worker_compressor: Optional[Compressor] = None,
                 bucket_bytes: Optional[int] = None):
        self.dc_compressor = maybe_bucketed(dc_compressor or NoCompressor(),
                                            bucket_bytes)
        self.worker_compressor = worker_compressor or NoCompressor()

    def _dc_init(self, params: dict) -> Any:
        """dc-tier compressor state: shard-shaped under a bound ZeRO
        plan (the residuals live on each worker's 1/W bucket slice),
        bucket- or leaf-shaped otherwise."""
        if self.zero_plan is not None:
            return self.dc_compressor.init_shard_state(params,
                                                       self.zero_plan.W)
        return self.dc_compressor.init_state(params)

    def init_state(self, params: dict, model_state: Any = None) -> Any:
        return {
            "dc_comp": self._dc_init(params),
            "worker_comp": self.worker_compressor.init_state(params),
        }

    def sync_grads(self, grads: dict, params: dict, state: Any,
                   step: int) -> Tuple[dict, Any]:
        nw = self.workers_per_party
        np_ = self.num_parties
        # intra-party tier: mean over workers
        g, wstate = self.worker_compressor.allreduce(
            grads, state["worker_comp"], WORKER_AXIS, nw)
        if nw > 1:  # single-worker parties skip the dead x/1 divide
            g = tree_map(lambda x: x / nw, g)
        # cross-party tier: compressed mean over parties
        g, dstate = self.dc_compressor.allreduce(g, state["dc_comp"],
                                                 DC_AXIS, np_)
        if np_ > 1:
            g = tree_map(lambda x: x / np_, g)
        return g, {"dc_comp": dstate, "worker_comp": wstate}

    def sync_grad_shards(self, grads: dict, params: dict, state: Any,
                         step: int) -> Tuple[list, Any]:
        """The ZeRO form of :meth:`sync_grads`: the same two tiers on the
        bucket shards,

            worker tier: psum_scatter(flat buckets) / W
            dc tier:     compressed all-reduce of each shard / P

        Returns the list of global-mean bucket shards ``[P, W, n / W]``,
        not a gradient tree.  A configured worker compressor is bypassed
        (``build_train_step`` warns)."""
        plan = self.zero_plan
        leaves = [grads[k] for k in leaf_names(grads)]
        bk = self.dc_compressor.zero_bucketer(leaves)
        shards = [plan.scatter_bucket(b, WORKER_AXIS)
                  for b in bk.flatten(leaves)]
        shards, dstate = self.dc_compressor.allreduce_shards(
            shards, state["dc_comp"], DC_AXIS, self.num_parties, bk)
        np_ = self.num_parties
        if np_ > 1:
            shards = [x / np_ for x in shards]
        return shards, dict(state, dc_comp=dstate)

    def sync_model_state(self, model_state: dict, state: Any,
                         step: int) -> Tuple[dict, Any]:
        # keep non-trainable stats (BatchNorm) consistent across replicas
        if self.workers_per_party > 1:
            model_state = tree_map(lambda x: pmean(x, WORKER_AXIS),
                                   model_state)
        if self.num_parties > 1:
            model_state = tree_map(lambda x: pmean(x, DC_AXIS), model_state)
        return model_state, state
