"""Synchronization algorithms over the two HiPS tiers (port of
geomx_tpu/sync): FSA, MixedSync (with optional DCASGD compensation), HFA,
the DGT compressor wrap and the pipelined WAN sync."""

import warnings

from geomx_tpu_torch.sync.base import SyncAlgorithm
from geomx_tpu_torch.sync.dgt import DGTCompressor
from geomx_tpu_torch.sync.fsa import FSA
from geomx_tpu_torch.sync.hfa import HFA
from geomx_tpu_torch.sync.mixed import MixedSync
from geomx_tpu_torch.sync.pipeline import PipelinedSync

__all__ = ["SyncAlgorithm", "FSA", "HFA", "MixedSync", "DGTCompressor",
           "PipelinedSync", "get_sync_algorithm"]


def get_sync_algorithm(cfg, compressor=None):
    """Build the sync algorithm named by ``cfg.sync_mode`` from a GeoConfig,
    as the JAX package's factory does."""
    from geomx_tpu_torch.compression import get_compressor
    comp = compressor if compressor is not None \
        else get_compressor(cfg.compression)
    if cfg.enable_dgt:
        comp = DGTCompressor(inner=comp,
                             block_elems=max(1, cfg.dgt_block_size // 4),
                             k=cfg.dgt_k, alpha=cfg.dgt_contri_alpha,
                             channels=cfg.udp_channel_num)
    mode = cfg.sync_mode.lower()
    bucket_bytes = getattr(cfg, "bucket_bytes", None)
    if mode in ("fsa", "dist_sync", "sync"):
        algo = FSA(dc_compressor=comp, bucket_bytes=bucket_bytes)
    elif mode in ("mixed", "dist_async", "async"):
        # DCASGD compensation is opt-in (the reference's --dcasgd flag)
        lam = cfg.dcasgd_lambda if getattr(cfg, "dcasgd", False) else 0.0
        algo = MixedSync(dc_compressor=comp,
                         pull_interval=cfg.mixed_pull_interval,
                         dcasgd_lambda=lam, bucket_bytes=bucket_bytes)
    elif mode == "hfa":
        algo = HFA(k1=cfg.hfa_k1, k2=cfg.hfa_k2, dc_compressor=comp,
                   bucket_bytes=bucket_bytes)
    else:
        raise ValueError(f"Unknown sync mode: {cfg.sync_mode!r}")
    depth = getattr(cfg, "pipeline_depth", 0)
    if depth and cfg.num_parties <= 1:
        # one party has no dc-tier round trip to hide, and staleness 1
        # would only degrade the trajectory
        warnings.warn(
            "GEOMX_PIPELINE_DEPTH ignored: num_parties == 1 has no "
            "dc-tier collective to pipeline", stacklevel=2)
    elif depth:
        # double-buffer the dc-tier collective (sync/pipeline.py); the
        # constructor rejects HFA and depths other than 1
        algo = PipelinedSync(algo, depth=depth,
                             dcasgd_lambda=getattr(cfg, "pipeline_dcasgd",
                                                   0.0))
    return algo
