"""The telemetry plane of the port (port of geomx_tpu/telemetry/).

Sensors:

- :mod:`registry` — process-global Counter/Gauge/Histogram registry
  every subsystem writes into;
- :mod:`probes` — step-health probes (grad norm, NaN/Inf, achieved
  compression, EF residuals), gated by ``GEOMX_TELEMETRY``, with a
  disabled step that dispatches the same ops as one without the probes;
- :mod:`tracing` — cross-party WAN round correlation (``round_id``
  spans + :func:`merge_traces`);
- :mod:`export` — Prometheus text exposition, the HTTP exporter and the
  bounded JSONL event log;
- :mod:`ledger` — the fleet round ledger of the host plane.

Interpretation: :mod:`attribution` (Chrome traces -> per-step phase
breakdown), :mod:`roofline` (MFU and the bound verdict, FLOPs from
PyTorch's FLOP counter), :mod:`links` (per-link EWMA estimates),
:mod:`flight` (the flight recorder, ``GEOMX_FLIGHT``).

Whole-run capture: :mod:`capsule` (``GEOMX_CAPSULE``) and
:mod:`costmodel` (a step-time cost model fitted from a capsule).

Not ported: FleetScope (``GEOMX_FLEETSCOPE``, ROADMAP.md Queue 1,
"Telemetry").
"""


from geomx_tpu_torch.telemetry.attribution import (attribute_merged,
                                                   attribute_trace,
                                                   classify_span,
                                                   publish_attribution)
from geomx_tpu_torch.telemetry.capsule import (Capsule, RegistrySampler,
                                               RunCapsule, capsule_enabled,
                                               capsule_from_config,
                                               sample_registry)
from geomx_tpu_torch.telemetry.costmodel import (StepTimeCostModel,
                                                 candidate_wire_bytes,
                                                 fit_affine_link)
from geomx_tpu_torch.telemetry.export import (EventLog, get_event_log,
                                              log_event,
                                              parse_prometheus_text,
                                              render_prometheus)
from geomx_tpu_torch.telemetry.flight import (FlightRecorder, flight_enabled,
                                              flight_recorder_from_config,
                                              install_incident_recorder,
                                              notify_host_incident,
                                              uninstall_incident_recorder)
from geomx_tpu_torch.telemetry.ledger import (RoundLedger, get_round_ledger,
                                              reset_round_ledger)
from geomx_tpu_torch.telemetry.links import (LinkObservatory,
                                             get_link_observatory,
                                             reset_link_observatory)
from geomx_tpu_torch.telemetry.probes import telemetry_enabled
from geomx_tpu_torch.telemetry.registry import (MetricRegistry,
                                                get_registry,
                                                reset_registry)
from geomx_tpu_torch.telemetry.roofline import (publish_roofline,
                                                roofline_record,
                                                trainer_roofline)
from geomx_tpu_torch.telemetry.tracing import merge_traces, rounds_in_trace

__all__ = [
    "MetricRegistry", "get_registry", "reset_registry",
    "telemetry_enabled",
    "EventLog", "get_event_log", "log_event",
    "render_prometheus", "parse_prometheus_text",
    "merge_traces", "rounds_in_trace",
    "attribute_trace", "attribute_merged", "classify_span",
    "publish_attribution",
    "roofline_record", "trainer_roofline", "publish_roofline",
    "LinkObservatory", "get_link_observatory", "reset_link_observatory",
    "RoundLedger", "get_round_ledger", "reset_round_ledger",
    "FlightRecorder", "flight_enabled", "flight_recorder_from_config",
    "notify_host_incident", "install_incident_recorder",
    "uninstall_incident_recorder",
    "RunCapsule", "Capsule", "RegistrySampler", "sample_registry",
    "capsule_enabled", "capsule_from_config",
    "StepTimeCostModel", "fit_affine_link", "candidate_wire_bytes",
]
