"""Environment-variable configuration surface (port of geomx_tpu/config.py).

An adapted copy of ``GeoConfig`` with every field of the JAX package's,
under the same names and defaults (the host-plane-only knobs included,
which configure nothing in the step, as there).  Every knob reads the same ``GEOMX_*`` variable first and
falls back to the reference's original ``DMLC_*`` name, exactly as the
JAX package does, so one launch environment configures both packages.

The refusal mechanism: a reference knob that changes its training step,
or adds outputs to its run, but that the port does not run yet is read
too, under the same name and cast, and listed in ``UNPORTED``; a config
that sets one to anything but its default raises ``NotImplementedError``
naming, by its title, the ROADMAP.md Queue 1 item that ports it, so a
launch environment is never half obeyed.  Every such knob is ported
now, so the table is empty.
"""

from __future__ import annotations

import dataclasses
import os

# the JAX package's default data directory (GeoConfig.data_dir and
# load_dataset's root there), so that one data layout serves both
DEFAULT_DATA_DIR = os.path.join(os.sep, "root", "data")


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
UNPORTED: dict = {}
# what a refused knob does in the JAX package, by item
UNPORTED_EFFECT: dict = {}


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    """The knobs of the ported slice, with the JAX package's defaults."""

    # ---- topology (reference: scripts/cpu/run_vanilla_hips.sh)
    num_parties: int = 1              # data centers (global tier width)
    workers_per_party: int = 1        # intra-DC workers (local tier width)

    # ---- synchronization algorithm: "fsa" (dist_sync), "mixed"
    # (dist_async [+ dcasgd]), "hfa"
    sync_mode: str = "fsa"
    # HFA periods (reference scripts/cpu/run_hfa_sync.sh: K1=20, K2=10)
    hfa_k1: int = 20
    hfa_k2: int = 10
    # MixedSync: parties refresh their stale copy of the global
    # parameters every `mixed_pull_interval` steps
    mixed_pull_interval: int = 1
    # DCASGD compensation is opt-in, as in the reference
    # (examples/cnn.py --dcasgd); MXNet's default lamda 0.04
    dcasgd: bool = False
    dcasgd_lambda: float = 0.04

    # ---- gradient compression spec: "none" | "bsc,<ratio>[,key=val]" |
    # "2bit,<threshold>"
    compression: str = "none"
    bsc_threshold: float = 0.01       # -bcr default (reference examples/cnn_bsc.py)
    twobit_threshold: float = 0.5
    # MPQ size split (reference MXNET_KVSTORE_SIZE_LOWER_BOUND,
    # src/kvstore/kvstore_dist_server.h:183; the demo uses 200000)
    size_lower_bound: int = 200_000

    # ---- bucketed dc-tier communication (compression/bucketing.py);
    # 0 restores the per-leaf path
    bucket_bytes: int = 4 * 1024 * 1024

    # ---- compute precision: "fp32" or "bf16" (train/step.py)
    precision: str = "fp32"

    # ---- fused optimizer apply over the dc tier's flat buckets (needs an
    # optimizer built by ops.optim.fused_optimizer and bucketing on)
    fused_optim: bool = False

    # ---- pipelined WAN sync (sync/pipeline.py): 0 = a synchronous dc
    # tier, 1 = double buffering (staleness 1); FSA and MixedSync only
    pipeline_depth: int = 0
    # DCASGD-style compensation of the pipelined aggregate; 0 disables
    pipeline_dcasgd: float = 0.0

    # ---- DGT (reference 3rdparty/ps-lite/include/ps/kv_app.h:1036-1045)
    enable_dgt: int = 0
    dgt_block_size: int = 4096        # bytes in the reference; elements/4
    dgt_k: float = 0.5                # DMLC_K: fraction sent reliably
    dgt_k_min: float = 0.2            # DMLC_K_MIN (read, not acted on)
    dgt_contri_alpha: float = 0.3     # DGT_CONTRI_ALPHA EWMA factor
    adaptive_k: bool = False          # ADAPTIVE_K_FLAG (read, not acted on)
    udp_channel_num: int = 1          # DMLC_UDP_CHANNEL_NUM

    # ---- P3 (reference ENABLE_P3, src/kvstore/kvstore_dist.h:835-872)
    # and TSEngine (reference van.cc:447-454).  These, bsc_threshold,
    # size_lower_bound and heartbeat_interval_s configure nothing in the
    # step, as in the JAX package: they are read and kept so that one
    # launch environment parses alike in both packages, and the host plane
    # reads its own variables (service/client.py, service/scheduler.py,
    # examples/dist_ps.py)
    enable_p3: bool = False
    p3_slice_elems: int = 500_000     # bigarray_bound // 2 in the reference
    enable_inter_ts: bool = False
    enable_intra_ts: bool = False
    max_greed_rate: float = 0.9       # MAX_GREED_RATE_TS

    # ---- the ZeRO-sharded weight update over the dc tier's fused
    # buckets (train/zero.py); needs bucketing and sync_mode fsa or mixed
    # (pipelined composes)
    zero: bool = False

    # ---- MultiGPS (parallel/multigps.py): leaves of at least
    # bigarray_bound elements update as worker-axis shards (reference
    # MXNET_KVSTORE_BIGARRAY_BOUND, src/kvstore/kvstore_dist.h:69)
    bigarray_bound: int = 1_000_000
    multi_gps: bool = False

    # ---- input-pipeline prefetch depth: batches the loader's producer
    # thread assembles and copies ahead of the step (data/loader.py); 0
    # assembles them in the caller's thread
    prefetch: int = 2

    # ---- data (load_dataset's root)
    data_dir: str = DEFAULT_DATA_DIR

    # ---- liveness (reference van.cc:1147-1160): the heartbeat period (0
    # disables) and the silence after which a node is dead (reference
    # PS_HEARTBEAT_TIMEOUT, van.h:304-305), the PartyLivenessController's
    # default timeout
    heartbeat_interval_s: float = 0.0
    heartbeat_timeout_s: float = 15.0

    # ---- resilience (resilience/: membership epochs, degraded-mode
    # sync, deterministic chaos).  The residual policy at a membership
    # change: "reset" re-initializes the dc-tier compressor residuals and
    # pipeline buffers, "carry" keeps them
    resilience_residuals: str = "reset"
    # the PartyLivenessController's floor: a transition leaving fewer
    # live parties raises instead of publishing an unexecutable epoch
    resilience_min_live: int = 1
    # chaos schedule spec (resilience/chaos.py format); "" = no chaos
    chaos_schedule: str = ""

    # ---- the collective audit (analysis/): the Trainer records the step
    # program's collective signature on the first fit batch and diffs
    # every membership swap's program against it, re-arming at a depth
    # switch; findings at audit_severity or above raise AuditError
    audit: bool = False
    audit_severity: str = "error"

    # ---- telemetry (telemetry/): the step probes (train/step.py), the
    # JSONL event log, the flight recorder and the run capsule, which the
    # Trainer arms (train/trainer.py)
    telemetry: bool = False
    telemetry_events: str = ""
    flight: bool = False
    flight_steps: int = 0
    flight_dir: str = ""
    capsule: bool = False
    capsule_dir: str = ""
    capsule_sample_s: float = 0.0
    # ---- the control plane (control/: the Graft Pilot).  When on, the
    # Trainer threads a control-operand subtree through sync_state (the
    # bsc ratio scale, a 0-d fp32 tensor on the device, so retuning it
    # launches nothing new) and Trainer.apply_control is the actuation
    # boundary for ratio and pipeline-depth decisions
    control: bool = False
    # steps between controller evaluations (GraftPilot.tick no-ops on
    # non-multiples)
    control_interval: int = 1
    # absolute bsc-ratio operating range "lo,hi" for the ratio policy;
    # "" derives [configured_ratio/8, configured_ratio] (the configured
    # ratio is the wire capacity: the scale only tunes downward)
    control_ratio_bounds: str = ""
    # minimum steps between two actuations of the same knob
    control_cooldown: int = 5

    # ---- the serving plane (serve/: the model registry, the serving
    # replica and the batched inference gateway).  The gateway binds
    # POST /infer on serve_port (0 = ephemeral), coalesces requests for
    # serve_queue_ms into a batch of at most serve_max_batch (padded to
    # power-of-two buckets: one captured graph a bucket on the card);
    # serve_staleness_s is the replica-freshness bound, serve_timeout_s
    # the per-request client deadline; serve_warmup builds every
    # (bucket, input shape) forward at gateway start, serve_native_wire
    # gates the binary /infer lane.  Host plane only
    serve_port: int = 0
    serve_max_batch: int = 8
    serve_queue_ms: float = 2.0
    serve_staleness_s: float = 10.0
    serve_timeout_s: float = 30.0
    serve_warmup: bool = True
    serve_native_wire: bool = True

    # ---- FleetScope (telemetry/fleetscope.py): arms the
    # scheduler-colocated fleet aggregator (GET /fleet and the
    # geomx_fleet_* rollups), polling every fleetscope_interval_s; the
    # SLO burn-rate spec as "window_s:threshold" pairs.  Host plane only
    fleetscope: bool = False
    fleetscope_interval_s: float = 2.0
    fleetscope_burn_windows: str = "60:14,300:6"

    def __post_init__(self):
        for field, (names, item) in UNPORTED.items():
            value = getattr(self, field)
            if not value:
                continue
            raise NotImplementedError(
                f"{field}={value!r} ({names}) {UNPORTED_EFFECT[item]} and "
                f"is not ported yet (ROADMAP.md Queue 1, {item!r})")

    @classmethod
    def from_env(cls, **overrides) -> "GeoConfig":
        cfg = dict(
            num_parties=_env(["GEOMX_NUM_PARTIES", "DMLC_NUM_GLOBAL_WORKER"],
                             1, int),
            workers_per_party=_env(["GEOMX_WORKERS_PER_PARTY",
                                    "DMLC_NUM_WORKER"], 1, int),
            sync_mode=_env(["GEOMX_SYNC_MODE"], "fsa", str),
            hfa_k1=_env(["GEOMX_HFA_K1", "DMLC_K1"], 20, int),
            hfa_k2=_env(["GEOMX_HFA_K2", "DMLC_K2"], 10, int),
            mixed_pull_interval=_env(["GEOMX_MIXED_PULL_INTERVAL"], 1, int),
            dcasgd=_env_bool(["GEOMX_DCASGD"], False),
            dcasgd_lambda=_env(["GEOMX_DCASGD_LAMBDA"], 0.04, float),
            compression=_env(["GEOMX_COMPRESSION"], "none", str),
            bsc_threshold=_env(["GEOMX_BSC_THRESHOLD"], 0.01, float),
            twobit_threshold=_env(["GEOMX_2BIT_THRESHOLD"], 0.5, float),
            size_lower_bound=_env(
                ["GEOMX_SIZE_LOWER_BOUND", "MXNET_KVSTORE_SIZE_LOWER_BOUND"],
                200_000, int),
            bucket_bytes=_env(["GEOMX_BUCKET_BYTES"], 4 * 1024 * 1024,
                              lambda s: int(float(s))),
            precision=_env(["GEOMX_PRECISION"], "fp32", str),
            fused_optim=_env_bool(["GEOMX_FUSED_OPTIM"], False),
            pipeline_depth=_env(["GEOMX_PIPELINE_DEPTH"], 0,
                                lambda s: int(float(s))),
            pipeline_dcasgd=_env(["GEOMX_PIPELINE_DCASGD"], 0.0, float),
            enable_dgt=_env(["GEOMX_ENABLE_DGT", "ENABLE_DGT"], 0, int),
            dgt_block_size=_env(["GEOMX_DGT_BLOCK_SIZE", "DGT_BLOCK_SIZE"],
                                4096, int),
            dgt_k=_env(["GEOMX_DGT_K", "DMLC_K"], 0.5, float),
            dgt_k_min=_env(["GEOMX_DGT_K_MIN", "DMLC_K_MIN"], 0.2, float),
            dgt_contri_alpha=_env(["GEOMX_DGT_CONTRI_ALPHA",
                                   "DGT_CONTRI_ALPHA"], 0.3, float),
            adaptive_k=_env_bool(["GEOMX_ADAPTIVE_K", "ADAPTIVE_K_FLAG"],
                                 False),
            udp_channel_num=_env(["GEOMX_UDP_CHANNEL_NUM",
                                  "DMLC_UDP_CHANNEL_NUM"], 1, int),
            enable_p3=_env_bool(["GEOMX_ENABLE_P3", "ENABLE_P3"], False),
            p3_slice_elems=_env(["GEOMX_P3_SLICE_ELEMS"], 500_000, int),
            enable_inter_ts=_env_bool(["GEOMX_ENABLE_INTER_TS",
                                       "ENABLE_INTER_TS"], False),
            enable_intra_ts=_env_bool(["GEOMX_ENABLE_INTRA_TS",
                                       "ENABLE_INTRA_TS"], False),
            max_greed_rate=_env(["GEOMX_MAX_GREED_RATE",
                                 "MAX_GREED_RATE_TS"], 0.9, float),
            zero=_env_bool(["GEOMX_ZERO"], False),
            bigarray_bound=_env(
                ["GEOMX_BIGARRAY_BOUND", "MXNET_KVSTORE_BIGARRAY_BOUND"],
                1_000_000, int),
            multi_gps=_env_bool(["GEOMX_MULTI_GPS"], False),
            prefetch=_env(["GEOMX_PREFETCH"], 2, lambda s: int(float(s))),
            data_dir=_env(["GEOMX_DATA_DIR"], DEFAULT_DATA_DIR, str),
            heartbeat_interval_s=_env(
                ["GEOMX_HEARTBEAT_INTERVAL", "PS_HEARTBEAT_INTERVAL"], 0.0,
                float),
            heartbeat_timeout_s=_env(
                ["GEOMX_HEARTBEAT_TIMEOUT", "PS_HEARTBEAT_TIMEOUT"], 15.0,
                float),
            resilience_residuals=_env(
                ["GEOMX_RESILIENCE_RESIDUALS"], "reset", str),
            resilience_min_live=_env(
                ["GEOMX_RESILIENCE_MIN_LIVE"], 1, int),
            chaos_schedule=_env(["GEOMX_CHAOS_SCHEDULE"], "", str),
            audit=_env_bool(["GEOMX_AUDIT"], False),
            audit_severity=_env(["GEOMX_AUDIT_SEVERITY"], "error", str),
            telemetry=_env_bool(["GEOMX_TELEMETRY"], False),
            telemetry_events=_env(["GEOMX_TELEMETRY_EVENTS"], "", str),
            flight=_env_bool(["GEOMX_FLIGHT"], False),
            flight_steps=_env(["GEOMX_FLIGHT_STEPS"], 0,
                              lambda s: int(float(s))),
            flight_dir=_env(["GEOMX_FLIGHT_DIR"], "", str),
            capsule=_env_bool(["GEOMX_CAPSULE"], False),
            capsule_dir=_env(["GEOMX_CAPSULE_DIR"], "", str),
            capsule_sample_s=_env(["GEOMX_CAPSULE_SAMPLE_S"], 0.0, float),
            control=_env_bool(["GEOMX_CONTROL"], False),
            control_interval=_env(["GEOMX_CONTROL_INTERVAL"], 1, int),
            control_ratio_bounds=_env(
                ["GEOMX_CONTROL_RATIO_BOUNDS"], "", str),
            control_cooldown=_env(["GEOMX_CONTROL_COOLDOWN"], 5, int),
            serve_port=_env(["GEOMX_SERVE_PORT"], 0,
                            lambda s: int(float(s))),
            serve_max_batch=_env(["GEOMX_SERVE_MAX_BATCH"], 8,
                                 lambda s: int(float(s))),
            serve_queue_ms=_env(["GEOMX_SERVE_QUEUE_MS"], 2.0, float),
            serve_staleness_s=_env(["GEOMX_SERVE_STALENESS_S"], 10.0,
                                   float),
            serve_timeout_s=_env(["GEOMX_SERVE_TIMEOUT_S"], 30.0,
                                 float),
            serve_warmup=_env_bool(["GEOMX_SERVE_WARMUP"], True),
            serve_native_wire=_env_bool(["GEOMX_SERVE_NATIVE_WIRE"],
                                        True),
            fleetscope=_env_bool(["GEOMX_FLEETSCOPE"], False),
            fleetscope_interval_s=_env(
                ["GEOMX_FLEETSCOPE_INTERVAL_S"], 2.0, float),
            fleetscope_burn_windows=_env(
                ["GEOMX_FLEETSCOPE_BURN_WINDOWS"], "60:14,300:6", str),
        )
        cfg.update(overrides)
        return cls(**cfg)

