"""Bi-directional Sparse ("bsc") gradient compression (port of
geomx_tpu/compression/bisparse.py).

Push side: DGC-style momentum correction ``u = 0.9u + g; v = v + u``;
a magnitude selection of exactly ``k = ceil(ratio * n)`` (value, index)
pairs, with ``(0.0, -1)`` sentinels where the sampled boundary leaves
slots free; ``u``/``v`` zeroed at the sent coordinates (error feedback).

Selections (``select``):

- ``"sampled"`` (the default) — the reference's sampled boundary scan,
  the one the JAX package runs with its fused kernels on, through
  ``ops.bsc`` (CUDA kernels on the card, plain PyTorch on the CPU);
- ``"exact"`` — ``lax.top_k`` of ``|v|`` through ``ops.topk`` (ties to
  the lower index), values gathered, ``u``/``v`` zeroed at the chosen
  coordinates, in plain PyTorch ops on every device;
- ``"approx"`` — ``lax.approx_max_k`` in the JAX package.  PyTorch has
  no approximate top-k, and on the CPU ``approx_max_k`` returns exactly
  ``lax.top_k``'s indices, so ``approx`` runs the exact selection on
  every device.

Aggregation over the dc axis: by default every party all-gathers all
parties' pairs and scatter-adds them into the dense aggregate.  With
``sparse_agg`` the pairs go through the owner-routed merge of
``compression/sparseagg.py`` instead (route, merge, re-select, one
gather of the owners' selections); its final decompress is
``bsc_scatter_add`` over the gathered selections with ``run = kr``:
the owners' index ranges are disjoint and each owner's merged indices
unique, so no coordinate receives two values and the sum is exact in
any fold order.

Ratio retuning (``control/``): with a control context open, ``compress``
reads the ``bsc_ratio_scale`` operand and selects ``eff_k = clip(round(k
* scale), 1, k)`` pairs, computed on the device as an int32 tensor; the
wire keeps its ``k`` slots (the configured ratio is the capacity), the
slots past the selection ride as sentinels, and their mass stays in the
error-feedback buffers.  The sampled route raises its boundary to the
``eff_k`` quantile (the select/pack kernel, its static ``k`` and its
sentinels unchanged); exact/approx turn the slots at or past ``eff_k``
into ``(0.0, -1)`` before error feedback.  With no context open no op is
added.

Telemetry (``telemetry/probes.py``): ``compress`` records
``bsc_emitted_fraction``, the share of the ``k`` wire slots a replica
fills with real pairs, into an open probe collection; with none open
(telemetry off) it runs no op for it.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Optional, Tuple

import torch
from torch.profiler import record_function

from geomx_tpu_torch.compression import sparseagg
from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.control.actuators import current_ratio_scale
from geomx_tpu_torch.ops import bsc as bsc_ops
from geomx_tpu_torch.ops.sampled_topk import probe_positions
from geomx_tpu_torch.ops.topk import top_k
from geomx_tpu_torch.parallel.collectives import all_gather, psum
from geomx_tpu_torch.telemetry.probes import record_inline

MOMENTUM = bsc_ops.MOMENTUM  # hardcoded in the reference (gc.cc:200)

_log = logging.getLogger("geomx_tpu_torch.compression")


class BiSparseCompressor(Compressor):
    name = "bsc"

    def __init__(self, ratio: float = 0.01, approx: Optional[bool] = None,
                 min_sparse_size: int = 1024, select: Optional[str] = None,
                 sparse_agg: Optional[bool] = None,
                 sparse_agg_parties: Optional[int] = None):
        """``select``: "sampled", "exact" or "approx" (module docstring);
        the default is ``GEOMX_BSC_SELECT`` if set, else "sampled";
        ``approx`` is the legacy boolean spelling of exact/approx.
        ``min_sparse_size``: tensors smaller than this go dense (a
        2k-pair payload would approach the dense size).  ``sparse_agg``
        (default ``GEOMX_SPARSE_AGG``): the owner-routed merge.
        ``sparse_agg_parties`` pins the dc width the wire accounting of
        that path assumes; without it the width of the last all-reduce
        is used (2 before any)."""
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
        self.select = select
        self.approx = select == "approx"
        self.min_sparse_size = int(min_sparse_size)
        if sparse_agg is None:
            sparse_agg = sparseagg.sparse_agg_enabled()
        self.sparse_agg = bool(sparse_agg)
        self.sparse_agg_parties = None if sparse_agg_parties is None \
            else int(sparse_agg_parties)
        self._wire_axis_size = self.sparse_agg_parties or 2
        self._probes: dict = {}  # (n, device) -> probe positions tensor
        # the last owner-routed all-reduce's index tensors, kept for
        # inspection (sparseagg.wire_stats; chip_smoke.py reads them)
        self.last_wire: Optional[dict] = None

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
        """Momentum-corrected top-k with error feedback on ``[*B, n]``
        rows: ``(vals [*B, k], idx [*B, k] int32, new_u, new_v)``.  Under
        an open control context the selection count is the device-side
        ``eff_k`` (module docstring)."""
        n = g_flat.shape[-1]
        k = self.k_for(n)
        scale = current_ratio_scale()
        eff_k = None
        if scale is not None:
            eff_k = torch.round(scale * k).clamp(1.0, float(k)) \
                .to(torch.int32)
        if self.select == "sampled":
            with record_function("bsc/threshold"):
                thr = bsc_ops.sampled_boundary_guv(
                    g_flat, u, v, k if eff_k is None else eff_k,
                    positions=self._probe(n, g_flat.device))
            with record_function("bsc/select_pack"):
                vals, idx, u, v = bsc_ops.select_pack(g_flat, u, v, thr, k)
            # in-situ achieved payload: the sampled boundary emits <= k
            # real pairs, the rest ride as sentinels
            record_inline("bsc_emitted_fraction",
                          lambda: (idx >= 0).sum(-1) / k)
            return vals, idx, u, v
        with record_function("bsc/topk"):
            u = u * MOMENTUM + g_flat
            v = v + u
            _, idx = top_k(v.abs(), k)
            sel = idx.long()
            vals = v.gather(-1, sel)
            if eff_k is not None:
                # ranked selection under eff_k: slots past it become
                # sentinels before error feedback, so the mass they would
                # have carried stays in u/v (their coordinates are
                # written back unchanged: top-k indices are unique)
                keep = torch.arange(k, device=idx.device) < eff_k
                zero = torch.zeros((), dtype=v.dtype, device=v.device)
                v = v.scatter(-1, sel, torch.where(keep, zero, vals))
                u = u.scatter(-1, sel, torch.where(
                    keep, zero, u.gather(-1, sel)))
                vals = torch.where(keep, vals, zero)
                idx = torch.where(keep, idx, torch.full(
                    (), -1, dtype=idx.dtype, device=idx.device))
                record_inline("bsc_emitted_fraction",
                              lambda: (idx >= 0).sum(-1) / k)
                return vals, idx, u, v
            # error feedback: sent coordinates reset (gc.cc:250-252)
            v = v.scatter(-1, sel, 0.0)
            u = u.scatter(-1, sel, 0.0)
        # exact/approx top-k always fills all k slots
        record_inline("bsc_emitted_fraction",
                      lambda: torch.ones(idx.shape[:-1], dtype=torch.float32,
                                         device=idx.device))
        return vals, idx, u, v

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
        elif self.sparse_agg:
            # compressed-domain merge: route pairs to their index-range
            # owners, merge, re-select, decompress once; the routing
            # overflow goes back into the velocity v
            if self.sparse_agg_parties is None:
                self._wire_axis_size = int(axis_size)
            self.last_wire = {}
            out, v = sparseagg.sparse_allreduce(
                vals, idx, n, axis_name, axis_size, self.decompress,
                ef_buffer=v, record=self.last_wire)
        else:
            # the wire transfer: 2k values per party over the dc tier;
            # every replica folds the parties' runs in party order
            all_vals = all_gather(vals, axis_name).reshape(lead + (-1,))
            all_idx = all_gather(idx, axis_name).reshape(lead + (-1,))
            out = self.decompress(all_vals, all_idx, n, run=k)
        return (out.reshape(shape).to(dtype),
                (u.reshape(shape), v.reshape(shape)))

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        n = math.prod(leaf.shape[REPLICA_DIMS:])
        if not self._sparse_eligible(n):
            return n * 4
        if self.sparse_agg:
            return sparseagg.sparse_wire_bytes(self.k_for(n),
                                               self._wire_axis_size)
        return 2 * self.k_for(n) * 4
