"""Synchronization algorithms over the two HiPS tiers (port of
geomx_tpu/sync).  FSA is ported; MixedSync, HFA, DGT and the pipelined
form are ROADMAP.md Queue 1, slice 2."""

from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.sync.fsa import FSA

__all__ = ["SyncAlgorithm", "FSA", "get_sync_algorithm"]


def get_sync_algorithm(cfg, compressor=None):
    """Build the sync algorithm named by ``cfg.sync_mode``."""
    from geomx_tpu_torch.compression import get_compressor
    comp = compressor if compressor is not None \
        else get_compressor(cfg.compression)
    mode = cfg.sync_mode.lower()
    if mode in ("fsa", "dist_sync", "sync"):
        return FSA(dc_compressor=comp,
                   bucket_bytes=getattr(cfg, "bucket_bytes", None))
    if mode in ("mixed", "dist_async", "async", "hfa"):
        raise NotImplementedError(
            f"sync mode {cfg.sync_mode!r} is not ported yet (ROADMAP.md "
            "Queue 1, slice 2 'Other sync algorithms')")
    raise ValueError(f"Unknown sync mode: {cfg.sync_mode!r}")
