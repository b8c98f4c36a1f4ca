"""Bi-directional Sparse ("bsc") gradient compression (port of
geomx_tpu/compression/bisparse.py).

Push side: DGC-style momentum correction ``u = 0.9u + g; v = v + u``;
the sampled magnitude boundary; exactly ``k = ceil(ratio * n)`` (value,
index) pairs with ``(0.0, -1)`` sentinels; ``u``/``v`` zeroed at the
sent coordinates (error feedback).  The pairs are all-gathered over the
dc axis and every party scatter-adds all parties' pairs into the dense
aggregate.

The port carries the ``select="sampled"`` path — the one the JAX package
runs with its fused kernels on — through ``ops.bsc`` (CUDA kernels on
the card, plain PyTorch on the CPU).  Not ported yet, and raising
``NotImplementedError``: the ``exact``/``approx`` top-k selections and
the ``sparse_agg`` owner-routed merge (ROADMAP.md Queue 1, slice 2).
The control plane's effective-k operand has no hook in the port.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Optional, Tuple

import torch
from torch.profiler import record_function

from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.ops import bsc as bsc_ops
from geomx_tpu_torch.ops.sampled_topk import probe_positions
from geomx_tpu_torch.parallel.collectives import all_gather, psum

MOMENTUM = bsc_ops.MOMENTUM  # hardcoded in the reference (gc.cc:200)

_log = logging.getLogger("geomx_tpu_torch.compression")


class BiSparseCompressor(Compressor):
    name = "bsc"

    def __init__(self, ratio: float = 0.01, approx: Optional[bool] = None,
                 min_sparse_size: int = 1024, select: Optional[str] = None,
                 sparse_agg: Optional[bool] = None):
        """``select``: only ``"sampled"`` (the reference's sampled
        boundary scan) is ported; the default is ``GEOMX_BSC_SELECT`` if
        set, else ``"sampled"``.  ``min_sparse_size``: tensors smaller
        than this go dense (a 2k-pair payload would approach the dense
        size)."""
        if ratio <= 0:
            raise ValueError("threshold must be greater than 0")
        self.ratio = float(ratio)
        if select is None:
            if approx is not None:
                select = "approx" if approx else "exact"
            else:
                select = os.environ.get("GEOMX_BSC_SELECT") or "sampled"
        if select not in ("exact", "approx", "sampled"):
            raise ValueError(f"unknown BSC selection {select!r}")
        if select != "sampled":
            raise NotImplementedError(
                f"BSC select={select!r} is not ported yet (ROADMAP.md "
                "Queue 1, slice 2 'Compression off the main path'); use "
                "select='sampled'")
        self.select = select
        if sparse_agg is None:
            raw = os.environ.get("GEOMX_SPARSE_AGG", "").strip().lower()
            sparse_agg = raw in ("1", "true", "yes", "on")
        if sparse_agg:
            raise NotImplementedError(
                "BSC sparse_agg (owner-routed compressed-domain merge) is "
                "not ported yet (ROADMAP.md Queue 1, slice 2 'Compression "
                "off the main path')")
        self.min_sparse_size = int(min_sparse_size)
        self._probes: dict = {}  # (n, device) -> probe positions tensor

    def k_for(self, n: int) -> int:
        return max(1, int(math.ceil(n * self.ratio)))

    def _sparse_eligible(self, n: int) -> bool:
        return n >= self.min_sparse_size

    def _probe(self, n: int, device) -> torch.Tensor:
        # cached on the device: a pageable host copy per step would wait
        # for the stream to drain
        key = (n, str(device))
        pos = self._probes.get(key)
        if pos is None:
            pos = self._probes[key] = probe_positions(n, device=device)
        return pos

    def init_leaf_state(self, leaf: torch.Tensor) -> Any:
        if not self._sparse_eligible(math.prod(leaf.shape[REPLICA_DIMS:])):
            return ()
        # momentum buffer u and velocity (error accumulator) v, gc.cc:219-222
        return (torch.zeros(leaf.shape, dtype=torch.float32,
                            device=leaf.device),
                torch.zeros(leaf.shape, dtype=torch.float32,
                            device=leaf.device))

    def compress(self, g_flat: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor):
        """Momentum-corrected sampled top-k with error feedback on
        ``[*B, n]`` rows: ``(vals [*B, k], idx [*B, k], new_u, new_v)``."""
        n = g_flat.shape[-1]
        k = self.k_for(n)
        with record_function("bsc/threshold"):
            thr = bsc_ops.sampled_boundary_guv(
                g_flat, u, v, k, positions=self._probe(n, g_flat.device))
        with record_function("bsc/select_pack"):
            return bsc_ops.select_pack(g_flat, u, v, thr, k)

    def decompress(self, vals: torch.Tensor, idx: torch.Tensor, n: int,
                   run: Optional[int] = None) -> torch.Tensor:
        """Scatter-add (value, index) pairs into dense ``[*B, n]`` rows
        (reference BSCDecompress, gc.cc:310-336); negative indices are
        sentinels.  ``run``: pairs fold run by run in order."""
        with record_function("bsc/scatter_add"):
            return bsc_ops.scatter_add(vals, idx, n, run)

    def allreduce_leaf(self, g: torch.Tensor, state: Any, axis_name: str,
                       axis_size: int) -> Tuple[torch.Tensor, Any]:
        shape, dtype = g.shape, g.dtype
        lead = tuple(shape[:REPLICA_DIMS])
        n = math.prod(shape[REPLICA_DIMS:])
        if not self._sparse_eligible(n):
            _log.debug("bsc dense fallback: leaf of %d elements < "
                       "min_sparse_size=%d", n, self.min_sparse_size)
            if axis_size == 1:
                return g, state
            return psum(g, axis_name), state
        u, v = state
        vals, idx, u, v = self.compress(
            g.reshape(lead + (n,)).to(torch.float32),
            u.reshape(lead + (n,)), v.reshape(lead + (n,)))
        k = vals.shape[-1]
        if axis_size == 1:
            out = self.decompress(vals, idx, n)
        else:
            # the wire transfer: 2k values per party over the dc tier;
            # every replica folds the parties' runs in party order
            all_vals = all_gather(vals, axis_name).reshape(lead + (-1,))
            all_idx = all_gather(idx, axis_name).reshape(lead + (-1,))
            out = self.decompress(all_vals, all_idx, n, run=k)
        return (out.reshape(shape).to(dtype),
                (u.reshape(shape), v.reshape(shape)))
