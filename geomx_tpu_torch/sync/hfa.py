"""HFA — Hierarchical Frequency Aggregation (port of geomx_tpu/sync/hfa.py).

Reference semantics (README.md:41-44; worker loop examples/cnn_hfa.py:108-134;
server milestone math kvstore_dist_server.h:988-1017,1327-1346):

- every step: each replica runs its *own* optimizer update (the
  replicas drift apart);
- every K1 steps: the local tier averages parameters within the party
  (a ``pmean`` over the worker axis);
- every K1*K2 steps: each party sends ``(params - milestone) / P``, the
  parameter delta since the last global milestone, through the dc-tier
  compressor; everyone sets ``params = milestone + sum(deltas)`` and
  resets its milestone there.

The gates are Python branches on the host step (the JAX package's
``lax.cond``), so a skipped step launches nothing.  With one party the
global tier never fires and the state is ``{}``.

Telemetry: HFA reports no sync-state values, and its wire accounting is
the base class's (its dc-tier compressor's bytes a global sync).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from geomx_tpu_torch.compression.base import Compressor, NoCompressor
from geomx_tpu_torch.compression.bucketing import maybe_bucketed
from geomx_tpu_torch.parallel.collectives import pmean
from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.tree import tree_map


class HFA(SyncAlgorithm):
    name = "hfa"

    def __init__(self, k1: int = 20, k2: int = 10,
                 dc_compressor: Optional[Compressor] = None,
                 bucket_bytes: Optional[int] = None):
        if k1 < 1 or k2 < 1:
            raise ValueError("HFA periods must be >= 1")
        self.k1 = int(k1)
        self.k2 = int(k2)
        # the K1*K2 global delta crosses the same WAN hop as FSA's
        # gradients, so it gets the same fused flat-bucket default
        self.dc_compressor = maybe_bucketed(dc_compressor or NoCompressor(),
                                            bucket_bytes)

    def init_state(self, params: dict, model_state: Any = None) -> Any:
        if self.num_parties <= 1:
            # one party: the global tier never fires, so no milestone
            return {}
        # the last globally agreed parameters (reference
        # stored_milestone): a clone, where the JAX package keeps the
        # immutable params arrays themselves
        return {"milestone": tree_map(torch.clone, params),
                "dc_comp": self.dc_compressor.init_state(params)}

    # gradients are applied per replica: sync_grads is the identity

    def sync_params(self, params: dict, state: Any,
                    step: int) -> Tuple[dict, Any]:
        # `step` is the 0-based step being finished; the reference gates
        # on the 1-based global_iters % K1 == 0 (cnn_hfa.py:119)
        iters = step + 1
        if self.workers_per_party > 1 and iters % self.k1 == 0:
            params = tree_map(lambda p: pmean(p, WORKER_AXIS), params)
        if self.num_parties > 1 and iters % (self.k1 * self.k2) == 0:
            np_ = self.num_parties
            milestone = state["milestone"]
            # per-party delta, pre-divided as the reference does
            # ((store - milestone) / NumGlobalWorkers,
            # kvstore_dist_server.h:1334)
            delta = tree_map(lambda a, m: (a - m) / np_, params, milestone)
            agg, comp_state = self.dc_compressor.allreduce(
                delta, state["dc_comp"], DC_AXIS, np_)
            params = tree_map(lambda m, d: m + d, milestone, agg)
            # the new milestone is a clone of the new params, which the
            # optimizer consumes next
            state = {"milestone": tree_map(torch.clone, params),
                     "dc_comp": comp_state}
        return params, state

    def sync_model_state(self, model_state: dict, state: Any,
                         step: int) -> Tuple[dict, Any]:
        if not model_state:
            return model_state, state
        iters = step + 1
        if self.workers_per_party > 1 and iters % self.k1 == 0:
            model_state = tree_map(lambda s: pmean(s, WORKER_AXIS),
                                   model_state)
        if self.num_parties > 1 and iters % (self.k1 * self.k2) == 0:
            model_state = tree_map(lambda s: pmean(s, DC_AXIS), model_state)
        return model_state, state
