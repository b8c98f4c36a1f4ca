"""FSA — Fully Synchronous Algorithm (port of geomx_tpu/sync/fsa.py).

One hierarchical compressed all-reduce per step:

    g_party  = psum(g, "worker") / workers_per_party      (intra-party tier)
    g_global = dc_compressor.allreduce(g_party, "dc") / P (cross-party tier)

followed by an optimizer step applied identically on every replica.  By
default the dc compressor is wrapped in the bucketed engine
(compression/bucketing.py); ``GEOMX_BUCKET_BYTES=0`` opts out.  The
pipelined form is ``sync/pipeline.py``; the degraded-membership and ZeRO
forms are not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from geomx_tpu_torch.compression.base import Compressor, NoCompressor
from geomx_tpu_torch.compression.bucketing import maybe_bucketed
from geomx_tpu_torch.parallel.collectives import pmean
from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.tree import tree_map


class FSA(SyncAlgorithm):
    name = "fsa"
    grads_replicated_after_sync = True  # hierarchical psum output

    def __init__(self, dc_compressor: Optional[Compressor] = None,
                 worker_compressor: Optional[Compressor] = None,
                 bucket_bytes: Optional[int] = None):
        self.dc_compressor = maybe_bucketed(dc_compressor or NoCompressor(),
                                            bucket_bytes)
        self.worker_compressor = worker_compressor or NoCompressor()

    def init_state(self, params: dict, model_state: Any = None) -> Any:
        return {
            "dc_comp": self.dc_compressor.init_state(params),
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

    def sync_model_state(self, model_state: dict, state: Any,
                         step: int) -> Tuple[dict, Any]:
        # keep non-trainable stats (BatchNorm) consistent across replicas
        if self.workers_per_party > 1:
            model_state = tree_map(lambda x: pmean(x, WORKER_AXIS),
                                   model_state)
        if self.num_parties > 1:
            model_state = tree_map(lambda x: pmean(x, DC_AXIS), model_state)
        return model_state, state
