"""Mixed-Precision Quantization (port of geomx_tpu/compression/mpq.py).

Tensors smaller than ``size_lower_bound`` elements (the reference's
``MXNET_KVSTORE_SIZE_LOWER_BOUND``, default 200k) travel as fp16; larger
ones go through Bi-Sparse.  The split is static per tensor; under the
bucketed dc tier the tensor routed is a flat bucket, so ResNet-20's one
272,512-element bucket takes BSC and a small model's bucket fp16.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.compression.bisparse import BiSparseCompressor
from geomx_tpu_torch.compression.fp16 import FP16Compressor


class MPQCompressor(Compressor):
    name = "mpq"

    def __init__(self, ratio: float = 0.01, size_lower_bound: int = 200_000,
                 bf16: bool = False, approx: Optional[bool] = None):
        self.size_lower_bound = int(size_lower_bound)
        self.small = FP16Compressor(bf16=bf16)
        # approx=None takes BiSparseCompressor's default selection
        self.large = BiSparseCompressor(ratio=ratio, approx=approx)

    def route(self, leaf: torch.Tensor) -> Compressor:
        """The sub-compressor of a ``[P, W, *shape]`` leaf."""
        n = math.prod(leaf.shape[REPLICA_DIMS:])
        return self.large if n >= self.size_lower_bound else self.small

    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        return self.route(leaf).init_leaf_state(leaf)

    def allreduce_leaf(self, g: torch.Tensor, state: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        return self.route(g).allreduce_leaf(g, state, axis_name, axis_size)

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        return self.route(leaf).wire_bytes_leaf(leaf)
