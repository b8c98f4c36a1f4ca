"""Environment-variable configuration surface (port of geomx_tpu/config.py).

An adapted copy of ``GeoConfig`` holding only the fields the ported main
path reads.  Every knob reads the same ``GEOMX_*`` variable first and
falls back to the reference's original ``DMLC_*`` name, exactly as the
JAX package does, so one launch environment configures both packages.

The reference's knobs that change its training step but that the port
does not run yet are read too, under the same names and casts, and
refused: a config that sets one to anything but its default raises
``NotImplementedError`` naming the ROADMAP.md Queue 1 item that ports it
(``UNPORTED``), so a launch environment is never half obeyed.  A
pipeline depth with one party only warns, as it does in the reference
(``geomx_tpu/sync/__init__.py:50-60``): there is no dc-tier collective
to pipeline.
"""

from __future__ import annotations

import dataclasses
import os
import warnings


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


def _env_bool(names, default) -> bool:
    return bool(_env(names, int(default), lambda s: int(float(s))))


# field -> (its variables, the ROADMAP.md Queue 1 item that ports it);
# each item removes its fields from here when it lands
UNPORTED = {
    "pipeline_depth": ("GEOMX_PIPELINE_DEPTH", "Other sync algorithms"),
    "enable_dgt": ("GEOMX_ENABLE_DGT / ENABLE_DGT", "Other sync algorithms"),
    "zero": ("GEOMX_ZERO", "Sharded updates"),
    "multi_gps": ("GEOMX_MULTI_GPS", "Sharded updates"),
    "control": ("GEOMX_CONTROL", "Control"),
}


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    """The knobs of the ported slice, with the JAX package's defaults."""

    # ---- topology (reference: scripts/cpu/run_vanilla_hips.sh)
    num_parties: int = 1              # data centers (global tier width)
    workers_per_party: int = 1        # intra-DC workers (local tier width)

    # ---- synchronization algorithm: only "fsa" is ported so far
    sync_mode: str = "fsa"

    # ---- gradient compression spec: "none" | "bsc,<ratio>[,key=val]" |
    # "2bit,<threshold>"
    compression: str = "none"
    twobit_threshold: float = 0.5

    # ---- bucketed dc-tier communication (compression/bucketing.py);
    # 0 restores the per-leaf path
    bucket_bytes: int = 4 * 1024 * 1024

    # ---- compute precision: "fp32" or "bf16" (train/step.py)
    precision: str = "fp32"

    # ---- fused optimizer apply over the dc tier's flat buckets (needs an
    # optimizer built by ops.optim.fused_optimizer and bucketing on)
    fused_optim: bool = False

    # ---- read and refused unless at their defaults (UNPORTED): the
    # pipelined sync, the DGT wrap, ZeRO, MultiGPS and the control plane
    pipeline_depth: int = 0
    enable_dgt: int = 0
    zero: bool = False
    multi_gps: bool = False
    control: bool = False

    def __post_init__(self):
        for field, (names, item) in UNPORTED.items():
            value = getattr(self, field)
            if not value:
                continue
            if field == "pipeline_depth" and self.num_parties <= 1:
                warnings.warn(
                    "GEOMX_PIPELINE_DEPTH ignored: num_parties == 1 has no "
                    "dc-tier collective to pipeline", stacklevel=3)
                continue
            raise NotImplementedError(
                f"{field}={value!r} ({names}) changes the training step and "
                f"is not ported yet (ROADMAP.md Queue 1, {item!r})")

    @classmethod
    def from_env(cls, **overrides) -> "GeoConfig":
        cfg = dict(
            num_parties=_env(["GEOMX_NUM_PARTIES", "DMLC_NUM_GLOBAL_WORKER"],
                             1, int),
            workers_per_party=_env(["GEOMX_WORKERS_PER_PARTY",
                                    "DMLC_NUM_WORKER"], 1, int),
            sync_mode=_env(["GEOMX_SYNC_MODE"], "fsa", str),
            compression=_env(["GEOMX_COMPRESSION"], "none", str),
            twobit_threshold=_env(["GEOMX_2BIT_THRESHOLD"], 0.5, float),
            bucket_bytes=_env(["GEOMX_BUCKET_BYTES"], 4 * 1024 * 1024,
                              lambda s: int(float(s))),
            precision=_env(["GEOMX_PRECISION"], "fp32", str),
            fused_optim=_env_bool(["GEOMX_FUSED_OPTIM"], False),
            pipeline_depth=_env(["GEOMX_PIPELINE_DEPTH"], 0,
                                lambda s: int(float(s))),
            enable_dgt=_env(["GEOMX_ENABLE_DGT", "ENABLE_DGT"], 0, int),
            zero=_env_bool(["GEOMX_ZERO"], False),
            multi_gps=_env_bool(["GEOMX_MULTI_GPS"], False),
            control=_env_bool(["GEOMX_CONTROL"], False),
        )
        cfg.update(overrides)
        return cls(**cfg)
