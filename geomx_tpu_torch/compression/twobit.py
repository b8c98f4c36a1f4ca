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
agree exactly when the threshold is a power of two.

``sparse_agg`` (default ``GEOMX_SPARSE_AGG``) over more than one party
sums on the int8 sign lattice instead (``_allreduce_lattice``, the JAX
op order, plain PyTorch ops): codes in {-1, 0, +1} with the same error
feedback, an exact integer sum over the tier, one scale by the
threshold.  Its wire is n int8 bytes a party.

``last_wire`` is a record for inspection only: the all-reduce reads its
wire from a local.  On a device mesh (``parallel/collectives.
run_on_mesh``) one compressor serves every slot, so only slot ``(0, 0)``
writes the record there, its own ``[1, 1, ...]`` block.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from geomx_tpu_torch.compression import sparseagg
from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.ops import twobit as twobit_ops
from geomx_tpu_torch.parallel.collectives import all_gather, records_here
from geomx_tpu_torch.utils.profiler import span


class TwoBitCompressor(Compressor):
    name = "2bit"

    def __init__(self, threshold: float = 0.5,
                 sparse_agg: Optional[bool] = None):
        if threshold <= 0:
            raise ValueError("threshold must be greater than 0")  # gc.cc:50
        self.threshold = float(threshold)
        if sparse_agg is None:
            sparse_agg = sparseagg.sparse_agg_enabled()
        self.sparse_agg = bool(sparse_agg)
        # the last all-reduce's wire (packed words, or the lattice's int8
        # codes), kept for inspection (chip_smoke.py reads its density);
        # slot (0, 0)'s under a mesh (module docstring)
        self.last_wire: Optional[torch.Tensor] = None

    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        # error-feedback residual, same shape as the gradient
        return torch.zeros(leaf.shape, dtype=torch.float32,
                           device=leaf.device)

    def allreduce_leaf(self, g: torch.Tensor, residual: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        if self.sparse_agg and axis_size > 1:
            return self._allreduce_lattice(g, residual, axis_name, axis_size)
        shape, dtype = g.shape, g.dtype
        lead = tuple(shape[:REPLICA_DIMS])
        n = math.prod(shape[REPLICA_DIMS:])
        with span("twobit/quantize"):
            packed, new_res = twobit_ops.quantize_2bit(
                g.reshape(lead + (n,)).to(torch.float32),
                residual.reshape(lead + (n,)), self.threshold)
        with span("twobit/dequantize"):
            if axis_size == 1:
                wire = packed
                out = twobit_ops.dequantize_2bit(packed, n, self.threshold)
            else:
                # the wire transfer: every replica receives the parties'
                # words [P, W, A, words] and sums their values in order
                wire = all_gather(packed, axis_name).contiguous()
                out = twobit_ops.dequantize_2bit(wire, n, self.threshold,
                                                 summed=True)
        if records_here():
            self.last_wire = wire
        return out.reshape(shape).to(dtype), new_res.reshape(shape)

    def _allreduce_lattice(self, g: torch.Tensor, residual: torch.Tensor,
                           axis_name: str, axis_size: int
                           ) -> Tuple[torch.Tensor, Any]:
        """Sign codes with the same error feedback, summed on the int8
        lattice and scaled once (``twobit.py:132-150``)."""
        with span("twobit/lattice"):
            r = residual + g.to(torch.float32)
            one = torch.ones((), dtype=torch.int8, device=r.device)
            zero = torch.zeros((), dtype=torch.int8, device=r.device)
            codes = torch.where(r >= self.threshold, one,
                                torch.where(r <= -self.threshold, -one,
                                            zero))
            new_res = r - codes.to(torch.float32) * self.threshold
            if records_here():
                self.last_wire = codes
            out = sparseagg.lattice_allreduce_signs(codes, self.threshold,
                                                    axis_name, axis_size)
        return out.to(g.dtype), new_res

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        n = math.prod(leaf.shape[REPLICA_DIMS:])
        if self.sparse_agg:
            return n  # int8 sign codes on the lattice sum
        # the kernel path's words: 128 int32 words per 2048-element row
        return 4 * twobit_ops.num_words(n)
