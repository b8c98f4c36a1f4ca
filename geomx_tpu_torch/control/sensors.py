"""Sensors: fold the observability surfaces into one observation (port
of geomx_tpu/control/sensors.py).

The telemetry plane is what a controller sees: per-link EWMA
throughput/RTT/loss with staleness confidence
(``telemetry/links.LinkObservatory``), the exposed-vs-hidden comms
fraction (``telemetry/attribution`` publishing
``geomx_phase_fraction``), achieved density, EF-residual norms and wire
accounting (the ``geomx_step_probe`` registry family the Trainer
publishes), FleetScope's fleet rollups (``geomx_fleet_rollup``) and the
roster epoch and live mask (``resilience/liveness``).
:class:`ControlSensors` reads each surface through its public API and
normalizes the result into one frozen :class:`ControlObservation` a
tick, so policies consume one shape and never re-implement staleness
filtering, registry label plumbing or membership bookkeeping.

Determinism: an observation is a pure read of the surfaces at an
explicit ``now`` (virtual time in replays); nothing here samples a
clock or mutates sensor state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ControlObservation:
    """One normalized controller input (all fields Optional-safe: a
    missing surface reads as None, and policies degrade gracefully)."""

    step: int
    # per-link quality, already staleness-filtered (links.py snapshot
    # records keyed "party->peer")
    links: Dict[str, dict]
    # step-time phase fractions (attribution.py; sum to ~1 when present)
    exposed_comms: Optional[float] = None
    hidden_comms: Optional[float] = None
    compute_fraction: Optional[float] = None
    host_stall: Optional[float] = None
    # absolute per-step compute seconds when the caller can supply it
    # (a modelled WAN does); fraction-only consumers leave it None
    compute_s: Optional[float] = None
    # in-graph probe registry reads (geomx_step_probe)
    ef_residual_norm: Optional[float] = None
    grad_norm: Optional[float] = None
    achieved_density: Optional[float] = None
    emitted_fraction: Optional[float] = None
    ratio_scale: Optional[float] = None
    dc_wire_bytes: Optional[float] = None
    dc_dense_bytes: Optional[float] = None
    # resilience surface
    roster_epoch: int = 0
    live_mask: Optional[Tuple[bool, ...]] = None
    num_live: Optional[int] = None
    # fleet surface (telemetry/fleetscope.py publishing the
    # geomx_fleet_rollup gauge family): fleet-wide truth so SloPolicy
    # can steer on the whole fleet, not gateway-local numbers
    fleet_qps: Optional[float] = None
    fleet_shed_rate: Optional[float] = None
    fleet_staleness_max_s: Optional[float] = None
    fleet_burn_rate: Optional[float] = None
    fleet_propagation_p99_s: Optional[float] = None
    fleet_nodes_dead: Optional[int] = None


# probe-name -> observation-field mapping for the registry reads
_PROBE_FIELDS = {
    "ef_residual_norm": "ef_residual_norm",
    "grad_norm_global": "grad_norm",
    "dc_nonzero_fraction": "achieved_density",
    "bsc_emitted_fraction": "emitted_fraction",
    "control_ratio_scale": "ratio_scale",
    "dc_wire_bytes": "dc_wire_bytes",
    "dc_dense_bytes": "dc_dense_bytes",
}


def _gauge_values(registry, family: str) -> Dict[str, float]:
    """{first-label-value: gauge value} for one registry family ({}
    when the family was never registered)."""
    fam = registry.get(family)
    if fam is None:
        return {}
    out: Dict[str, float] = {}
    for label_values, child in fam.children():
        key = label_values[0] if label_values else ""
        out[key] = float(child.value)
    return out


class ControlSensors:
    """The controller's one read path over the observability planes.

    ``observatory``: a :class:`~geomx_tpu_torch.telemetry.links.
    LinkObservatory` (default: the process-global one).  ``registry``:
    a :class:`~geomx_tpu_torch.telemetry.registry.MetricRegistry` (default:
    process-global).  ``liveness``: an optional
    :class:`~geomx_tpu_torch.resilience.liveness.PartyLivenessController`.
    ``min_confidence``: the staleness gate applied to link estimates
    (links below it are invisible to every policy).  ``compute_s_fn``:
    optional callable ``step -> seconds`` supplying absolute compute
    time when the host knows it (a modelled WAN; a profiler-derived
    estimate in live runs).  ``registry_fn``: the REPLAY path
    (telemetry/capsule.py) — a callable ``step -> registry-like``
    serving the registry view recorded AT that step, so an offline
    re-tick over a run capsule reads exactly what the live tick read;
    takes precedence over ``registry``.
    """

    def __init__(self, observatory=None, registry=None, liveness=None,
                 min_confidence: float = 0.5, compute_s_fn=None,
                 registry_fn=None):
        self.observatory = observatory
        self.registry = registry
        self.liveness = liveness
        self.min_confidence = float(min_confidence)
        self.compute_s_fn = compute_s_fn
        self.registry_fn = registry_fn

    def _observatory(self):
        if self.observatory is not None:
            return self.observatory
        from geomx_tpu_torch.telemetry.links import get_link_observatory
        return get_link_observatory()

    def _registry(self):
        if self.registry is not None:
            return self.registry
        from geomx_tpu_torch.telemetry.registry import get_registry
        return get_registry()

    def observe(self, step: int,
                now: Optional[float] = None) -> ControlObservation:
        """One normalized observation at ``step`` (pass ``now`` when
        replaying on a virtual clock so staleness decays on replay
        time, not wall time)."""
        links = self._observatory().snapshot(
            now=now, min_confidence=self.min_confidence)
        reg = self.registry_fn(step) if self.registry_fn is not None \
            else self._registry()
        probes = _gauge_values(reg, "geomx_step_probe")
        phases = _gauge_values(reg, "geomx_phase_fraction")
        fields: Dict[str, Optional[float]] = {}
        for probe, field in _PROBE_FIELDS.items():
            if probe in probes:
                fields[field] = float(probes[probe])
        obs = dict(
            step=int(step), links=links,
            exposed_comms=phases.get("exposed_comms"),
            hidden_comms=phases.get("hidden_comms"),
            compute_fraction=phases.get("compute"),
            host_stall=phases.get("host_stall"),
            **fields)
        fleet = _gauge_values(reg, "geomx_fleet_rollup")
        for gkey, field in (("qps", "fleet_qps"),
                            ("shed_rate", "fleet_shed_rate"),
                            ("replica_staleness_max_s",
                             "fleet_staleness_max_s"),
                            ("burn_rate_max", "fleet_burn_rate"),
                            ("propagation_p99_s",
                             "fleet_propagation_p99_s")):
            if gkey in fleet:
                obs[field] = float(fleet[gkey])
        if "nodes_dead" in fleet:
            obs["fleet_nodes_dead"] = int(fleet["nodes_dead"])
        if self.compute_s_fn is not None:
            obs["compute_s"] = float(self.compute_s_fn(step))
        if self.liveness is not None:
            epoch = self.liveness.epoch
            obs["roster_epoch"] = int(epoch.version)
            obs["live_mask"] = tuple(bool(b) for b in epoch.live_mask)
            obs["num_live"] = int(epoch.num_live)
        return ControlObservation(**obs)
