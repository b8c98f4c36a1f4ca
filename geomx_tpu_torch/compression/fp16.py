"""FP16 low-precision transmission (port of geomx_tpu/compression/fp16.py).

Reference behaviour: compute in fp32, transmit fp16, accumulate in fp32
on the server.  The gather path casts each party's gradient to 16 bits
(fp16, or bf16 with ``bf16=True``), all-gathers the 16-bit payload over
the tier, upcasts and sums the parties in party order.  With
``sparse_agg`` (default ``GEOMX_SPARSE_AGG``) the parties sum on a
shared int16 lattice instead (``sparseagg.lattice_allreduce_fp16``):
the same 2-byte wire, and no per-party dense intermediate.  Plain
PyTorch ops on every device: the JAX package has no kernel here.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from geomx_tpu_torch.compression import sparseagg
from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.parallel.collectives import all_gather
from geomx_tpu_torch.utils.profiler import span


class FP16Compressor(Compressor):
    name = "fp16"

    def __init__(self, bf16: bool = False,
                 sparse_agg: Optional[bool] = None):
        self.wire_dtype = torch.bfloat16 if bf16 else torch.float16
        if sparse_agg is None:
            sparse_agg = sparseagg.sparse_agg_enabled()
        self.sparse_agg = bool(sparse_agg)

    def allreduce_leaf(self, g: torch.Tensor, state: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        with span("fp16/allreduce"):
            if axis_size == 1:
                return g.to(self.wire_dtype).to(g.dtype), state
            if self.sparse_agg:
                out = sparseagg.lattice_allreduce_fp16(g, axis_name,
                                                       axis_size)
                return out.to(g.dtype), state
            # [P, W, A, *s] 16-bit payloads; fp32 accumulate, party order
            parts = all_gather(g.to(self.wire_dtype), axis_name) \
                .to(g.dtype).unbind(REPLICA_DIMS)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total, state

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        return math.prod(leaf.shape[REPLICA_DIMS:]) * 2
