"""2-bit gradient quantization with error feedback (port of
geomx_tpu/compression/twobit.py).

Reference semantics (the reference's Quantize2BitImpl): the residual
accumulates the gradient; elements whose residual crosses +-threshold
go out as sign codes worth +-threshold, the rest as 0, and the sent
amount leaves the residual (error feedback); 16 two-bit codes pack into
one 32-bit word.

The port carries the JAX package's kernel path (``_allreduce_pallas``)
through ``ops.twobit`` on every device: quantize the replica's tensor
with its residual, all-gather the packed words over the tier, then
dequantize every party's part and sum the parts in party order — one
kernel launch on the card.  The JAX jnp path's contiguous wire format
and its ``total_signs * threshold`` sum are not ported; the two sums
agree exactly when the threshold is a power of two.  Not ported, and
raising ``NotImplementedError``: ``sparse_agg`` (the int8 sign lattice,
ROADMAP.md Queue 1, slice 2 'Compression off the main path').
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Tuple

import torch
from torch.profiler import record_function

from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.ops import twobit as twobit_ops
from geomx_tpu_torch.parallel.collectives import all_gather


class TwoBitCompressor(Compressor):
    name = "2bit"

    def __init__(self, threshold: float = 0.5,
                 sparse_agg: Optional[bool] = None):
        if threshold <= 0:
            raise ValueError("threshold must be greater than 0")  # gc.cc:50
        self.threshold = float(threshold)
        if sparse_agg is None:
            raw = os.environ.get("GEOMX_SPARSE_AGG", "").strip().lower()
            sparse_agg = raw in ("1", "true", "yes", "on")
        if sparse_agg:
            raise NotImplementedError(
                "2bit sparse_agg (the int8 sign-lattice merge) is not ported "
                "yet (ROADMAP.md Queue 1, slice 2 'Compression off the main "
                "path': compression/sparseagg.py)")
        # the packed words of the last all-reduce's wire, kept for
        # inspection (chip_smoke.py reads their code density)
        self.last_wire: Optional[torch.Tensor] = None

    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        # error-feedback residual, same shape as the gradient
        return torch.zeros(leaf.shape, dtype=torch.float32,
                           device=leaf.device)

    def allreduce_leaf(self, g: torch.Tensor, residual: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        shape, dtype = g.shape, g.dtype
        lead = tuple(shape[:REPLICA_DIMS])
        n = math.prod(shape[REPLICA_DIMS:])
        with record_function("twobit/quantize"):
            packed, new_res = twobit_ops.quantize_2bit(
                g.reshape(lead + (n,)).to(torch.float32),
                residual.reshape(lead + (n,)), self.threshold)
        with record_function("twobit/dequantize"):
            if axis_size == 1:
                self.last_wire = packed
                out = twobit_ops.dequantize_2bit(packed, n, self.threshold)
            else:
                # the wire transfer: every replica receives the parties'
                # words [P, W, A, words] and sums their values in order
                self.last_wire = all_gather(packed, axis_name).contiguous()
                out = twobit_ops.dequantize_2bit(self.last_wire, n,
                                                 self.threshold, summed=True)
        return out.reshape(shape).to(dtype), new_res.reshape(shape)
