"""Environment-variable configuration surface (port of geomx_tpu/config.py).

An adapted copy of ``GeoConfig`` holding only the fields the ported main
path reads.  Every knob reads the same ``GEOMX_*`` variable first and
falls back to the reference's original ``DMLC_*`` name, exactly as the
JAX package does, so one launch environment configures both packages.
"""

from __future__ import annotations

import dataclasses
import os


def _env(names, default, cast):
    """First set env var among `names` wins; else `default`."""
    for n in names:
        v = os.environ.get(n)
        if v is not None and v != "":
            try:
                return cast(v)
            except (TypeError, ValueError):
                raise ValueError(f"Bad value for env var {n}: {v!r}")
    return default


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    """The knobs of the ported slice, with the JAX package's defaults."""

    # ---- topology (reference: scripts/cpu/run_vanilla_hips.sh)
    num_parties: int = 1              # data centers (global tier width)
    workers_per_party: int = 1        # intra-DC workers (local tier width)

    # ---- synchronization algorithm: only "fsa" is ported so far
    sync_mode: str = "fsa"

    # ---- gradient compression spec: "none" | "bsc,<ratio>[,key=val]"
    compression: str = "none"

    # ---- bucketed dc-tier communication (compression/bucketing.py);
    # 0 restores the per-leaf path
    bucket_bytes: int = 4 * 1024 * 1024

    # ---- compute precision: "fp32" or "bf16" (train/step.py)
    precision: str = "fp32"

    @classmethod
    def from_env(cls, **overrides) -> "GeoConfig":
        cfg = dict(
            num_parties=_env(["GEOMX_NUM_PARTIES", "DMLC_NUM_GLOBAL_WORKER"],
                             1, int),
            workers_per_party=_env(["GEOMX_WORKERS_PER_PARTY",
                                    "DMLC_NUM_WORKER"], 1, int),
            sync_mode=_env(["GEOMX_SYNC_MODE"], "fsa", str),
            compression=_env(["GEOMX_COMPRESSION"], "none", str),
            bucket_bytes=_env(["GEOMX_BUCKET_BYTES"], 4 * 1024 * 1024,
                              lambda s: int(float(s))),
            precision=_env(["GEOMX_PRECISION"], "fp32", str),
        )
        cfg.update(overrides)
        return cls(**cfg)
