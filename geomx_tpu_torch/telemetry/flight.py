"""Flight recorder: a bounded ring of per-step records + anomaly dumps
(port of geomx_tpu/telemetry/flight.py).

The telemetry plane publishes the *latest* probe values; when a run
goes wrong (a party's gradient turns NaN at step 48 012, achieved
density quietly drifts, the exposed-comms fraction jumps after a link
degrades) the question is always "what did the last few hundred steps
look like" — and by the time anyone asks, the registry only remembers
the end state.  :class:`FlightRecorder` keeps the answer in memory:

- a ring of the last K per-step records (probe values, phase
  breakdown, membership epoch, wire bytes — whatever the trainer
  publishes), bounded at ``GEOMX_FLIGHT_STEPS`` records;
- deterministic anomaly rules evaluated on every record against the
  ring's rolling history: a **nonfinite probe** (including the
  per-party vector, so the bundle names the poisoned party the
  aggregate hides), a **grad-norm spike** vs the rolling median, an
  **achieved-density drift**, and an **exposed-comms fraction jump**;
- when a rule fires, the whole ring dumps as one JSON forensics
  bundle (ATOMIC, via the same temp-file+replace the profiler uses) —
  the flight recorder's black-box readout.

Everything is pure functions of the recorded values: the same step
sequence fires the same rules at the same steps, which is what makes a
seeded NaN injection a deterministic acceptance test.

Gated by ``GEOMX_FLIGHT`` / ``GeoConfig(flight=True)``; requires the
telemetry probes (no probes, nothing to record — the trainer warns).
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_STEPS = 256

# anomaly rule ids (the bundle's "fired" entries carry these)
NONFINITE = "nonfinite_probe"
GRAD_SPIKE = "grad_norm_spike"
DENSITY_DRIFT = "density_drift"
EXPOSED_JUMP = "exposed_comms_jump"
STUCK_ROUND = "stuck_round"
HONESTY_DRIFT = "honesty_ratio_drift"


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return math.nan
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _finite(vals) -> List[float]:
    return [v for v in vals if v is not None and math.isfinite(v)]


class FlightRecorder:
    """Bounded per-step record ring with anomaly-triggered dumps.

    ``capacity``: ring size (``GEOMX_FLIGHT_STEPS``).  ``dump_dir``:
    where forensics bundles land ("" disables auto-dump; rules still
    evaluate and report).  Rule knobs (all overridable per instance,
    env rows in docs/telemetry.md):

    - ``spike_factor``: grad-norm spike fires when the norm exceeds
      this multiple of the rolling median (GEOMX_FLIGHT_SPIKE);
    - ``density_drift``: achieved-density drift fires when
      ``dc_nonzero_fraction`` moves more than this *relative* fraction
      away from the rolling median (GEOMX_FLIGHT_DENSITY_DRIFT);
    - ``exposed_jump``: exposed-comms fires when the fraction exceeds
      the rolling median by this *absolute* amount
      (GEOMX_FLIGHT_EXPOSED_JUMP);
    - ``stuck_round_s``: the fleet-round-ledger rule — fires when the
      oldest OPEN round (``ledger_open_round_age_s``, fed by
      :meth:`record_ledger`) has been open longer than this
      (GEOMX_FLIGHT_STUCK_S);
    - ``honesty_drift``: fires when the per-round wire honesty ratio
      (``wire_honesty_ratio``) moves more than this *relative*
      fraction away from its rolling median — framing/retry overhead
      quietly growing, or a compressor starting to lie
      (GEOMX_FLIGHT_HONESTY_DRIFT);
    - ``min_history``: rolling rules stay quiet until this many prior
      records exist (a fresh run's first steps are not anomalies);
    - ``window``: how many trailing records feed the rolling median.
    """

    def __init__(self, capacity: int = DEFAULT_STEPS,
                 dump_dir: str = "",
                 spike_factor: float = 10.0,
                 density_drift: float = 0.5,
                 exposed_jump: float = 0.25,
                 stuck_round_s: float = 30.0,
                 honesty_drift: float = 0.25,
                 min_history: int = 5,
                 window: int = 64,
                 decision_capacity: int = 64,
                 incident_capacity: int = 128):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0 (got {capacity!r})")
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.spike_factor = float(spike_factor)
        self.density_drift = float(density_drift)
        self.exposed_jump = float(exposed_jump)
        self.stuck_round_s = float(stuck_round_s)
        self.honesty_drift = float(honesty_drift)
        self.min_history = int(min_history)
        self.window = int(window)
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        # controller actuations (control/actuators.py): a bounded
        # sibling ring so a forensics bundle shows the last N decisions
        # alongside the step records — "the density drifted at step 412"
        # reads very differently next to "the pilot lowered the ratio at
        # step 410"
        self._decisions: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(decision_capacity)))
        # host-plane incidents (server/scheduler restarts, wire CRC
        # rejections — docs/resilience.md "Host-plane recovery"): a
        # bounded sibling ring fed by notify_host_incident, so a
        # forensics bundle shows recovery activity next to the step
        # records ("loss plateaued at step 812" reads differently next
        # to "the global server restarted at generation 3")
        self._incidents: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(incident_capacity)))
        self.dumps: List[str] = []    # bundle paths written so far
        self.anomalies_seen = 0

    # ---- recording ---------------------------------------------------------

    def record(self, step: int, probes: Dict[str, Any], *,
               membership_version: int = 0,
               phases: Optional[Dict[str, float]] = None,
               extra: Optional[Dict[str, Any]] = None) -> List[dict]:
        """Append one per-step record and evaluate the anomaly rules
        against the ring's history.  Returns the fired anomalies (empty
        list when healthy); when ``dump_dir`` is set, any firing also
        writes the forensics bundle and appends its path to
        :attr:`dumps`."""
        rec: Dict[str, Any] = {
            "step": int(step),
            "membership_version": int(membership_version),
            "probes": dict(probes),
        }
        if phases is not None:
            rec["phases"] = dict(phases)
        if extra:
            rec["extra"] = dict(extra)
        fired = self._check(rec)
        self._ring.append(rec)
        if fired:
            self.anomalies_seen += len(fired)
            rec["anomalies"] = fired
            if self.dump_dir:
                self.dumps.append(self.dump(fired, rec))
        return fired

    def record_ledger(self, step: int, ledger=None,
                      now: Optional[float] = None,
                      **record_kw) -> List[dict]:
        """Feed one fleet-round-ledger summary (telemetry/ledger.py)
        through the ring as a probes record, so the ``stuck_round`` and
        ``honesty_ratio_drift`` rules evaluate against the rolling
        history exactly like every other rule.  ``ledger`` defaults to
        the process-global one; ``now`` pins the staleness clock for
        deterministic replays."""
        if ledger is None:
            from geomx_tpu_torch.telemetry.ledger import get_round_ledger
            ledger = get_round_ledger()
        return self.record(step, ledger.summary(now=now), **record_kw)

    def snapshot(self) -> List[dict]:
        return list(self._ring)

    def record_decision(self, decision: Dict[str, Any]) -> None:
        """Append one controller actuation (a Decision's JSON form) to
        the bounded decision ring; it rides every subsequent forensics
        bundle."""
        self._decisions.append(dict(decision))

    def decisions(self) -> List[dict]:
        return list(self._decisions)

    def record_incident(self, kind: str,
                        detail: Optional[Dict[str, Any]] = None) -> None:
        """Append one host-plane incident (``server_restart`` /
        ``scheduler_restart`` / ``wire_crc_error``); it rides every
        subsequent forensics bundle.  Usually fed through the module's
        :func:`notify_host_incident` fan-out, not called directly."""
        self._incidents.append({"kind": str(kind),
                                "detail": dict(detail or {}),
                                "unix": round(time.time(), 6)})

    def incidents(self) -> List[dict]:
        return list(self._incidents)

    # ---- anomaly rules (pure functions of ring + new record) ---------------

    def _history(self, field: str, from_phases: bool = False
                 ) -> List[float]:
        out: List[float] = []
        for rec in list(self._ring)[-self.window:]:
            src = rec.get("phases") if from_phases else rec.get("probes")
            v = (src or {}).get(field)
            if v is not None:
                try:
                    out.append(float(v))
                except (TypeError, ValueError):
                    pass
        return _finite(out)

    def _check(self, rec: dict) -> List[dict]:
        fired: List[dict] = []
        probes = rec["probes"]

        # 1. nonfinite probe — fires immediately, names the party
        bad_scalars = []
        for name, v in probes.items():
            try:
                vals = v if isinstance(v, (list, tuple)) else [v]
                if any(not math.isfinite(float(u)) for u in vals):
                    bad_scalars.append(name)
            except (TypeError, ValueError):
                continue
        parties = probes.get("party_grad_nonfinite")
        poisoned = [i for i, flag in enumerate(parties or [])
                    if float(flag) > 0]
        if bad_scalars or poisoned or \
                float(probes.get("grad_all_finite", 1.0) or 0.0) < 1.0 \
                and "grad_all_finite" in probes:
            fired.append({"rule": NONFINITE, "step": rec["step"],
                          "nonfinite_probes": sorted(bad_scalars),
                          "poisoned_parties": poisoned})

        # 2. grad-norm spike vs rolling median
        hist = self._history("grad_norm_global")
        norm = probes.get("grad_norm_global")
        if norm is not None and len(hist) >= self.min_history:
            med = _median(hist)
            norm = float(norm)
            if math.isfinite(norm) and med > 0 \
                    and norm > self.spike_factor * med:
                fired.append({"rule": GRAD_SPIKE, "step": rec["step"],
                              "grad_norm": norm, "rolling_median": med,
                              "factor": norm / med})

        # 3. achieved-density drift (the in-situ compression ratio moved)
        hist = self._history("dc_nonzero_fraction")
        dens = probes.get("dc_nonzero_fraction")
        if dens is not None and len(hist) >= self.min_history:
            med = _median(hist)
            dens = float(dens)
            if math.isfinite(dens) and med > 0 and \
                    abs(dens - med) > self.density_drift * med:
                fired.append({"rule": DENSITY_DRIFT, "step": rec["step"],
                              "density": dens, "rolling_median": med,
                              "relative_drift": abs(dens - med) / med})

        # 4. exposed-comms fraction jump (the wire became the bottleneck)
        phases = rec.get("phases") or {}
        exp = phases.get("exposed_comms")
        hist = self._history("exposed_comms", from_phases=True)
        if exp is not None and len(hist) >= self.min_history:
            med = _median(hist)
            exp = float(exp)
            if math.isfinite(exp) and exp - med > self.exposed_jump:
                fired.append({"rule": EXPOSED_JUMP, "step": rec["step"],
                              "exposed_fraction": exp,
                              "rolling_median": med, "jump": exp - med})

        # 5. stuck round (fleet round ledger): an open round older than
        # the bound — a shard that died without failover, a sender that
        # will never satisfy the gate.  Immediate like the nonfinite
        # rule: the age itself already encodes the history.
        age = probes.get("ledger_open_round_age_s")
        if age is not None:
            try:
                age = float(age)
            except (TypeError, ValueError):
                age = None
        if age is not None and math.isfinite(age) \
                and age > self.stuck_round_s:
            fired.append({"rule": STUCK_ROUND, "step": rec["step"],
                          "open_round_age_s": age,
                          "open_rounds":
                              probes.get("ledger_open_rounds"),
                          "oldest_open":
                              probes.get("ledger_oldest_open")})

        # 6. honesty-ratio drift: measured-vs-declared wire bytes moved
        # relative to the rolling median — framing/retry overhead
        # creeping up, or a compressor's declared bytes going stale
        hist = self._history("wire_honesty_ratio")
        ratio = probes.get("wire_honesty_ratio")
        if ratio is not None and len(hist) >= self.min_history:
            med = _median(hist)
            ratio = float(ratio)
            if math.isfinite(ratio) and med > 0 and \
                    abs(ratio - med) > self.honesty_drift * med:
                fired.append({"rule": HONESTY_DRIFT, "step": rec["step"],
                              "honesty_ratio": ratio,
                              "rolling_median": med,
                              "relative_drift": abs(ratio - med) / med})
        return fired

    # ---- forensics bundle --------------------------------------------------

    def dump(self, fired: List[dict], rec: dict,
             path: Optional[str] = None) -> str:
        """Write the forensics bundle: the anomalies that fired, the
        triggering record, and the whole ring (oldest first).  Atomic
        (temp file + replace); the filename carries the step and first
        rule so concurrent anomalies never clobber each other."""
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            rule = fired[0]["rule"] if fired else "manual"
            path = os.path.join(
                self.dump_dir, f"flight_step{rec['step']}_{rule}.json")
        poisoned = sorted({p for f in fired
                           for p in f.get("poisoned_parties", [])})
        # the counter/gauge state AT dump time: step records say what
        # the run published per step, but the registry holds the
        # cumulative truth (restart counters, CRC rejections, eviction
        # totals) a forensics read needs next to them.  Bounded by the
        # same size discipline as the ring: at most `capacity` children
        # per family, dropped children counted in the sample itself.
        try:
            from geomx_tpu_torch.telemetry.capsule import sample_registry
            registry_section = sample_registry(
                max_children_per_family=self.capacity)
        except Exception:
            registry_section = {}
        bundle = {
            "kind": "geomx_flight_bundle",
            "written_unix": round(time.time(), 6),
            "step": rec["step"],
            "fired": fired,
            "poisoned_parties": poisoned,
            "trigger": rec,
            "ring": self.snapshot(),
            "decisions": self.decisions(),
            "incidents": self.incidents(),
            "registry": registry_section,
            "capacity": self.capacity,
        }
        from geomx_tpu_torch.utils.atomicio import atomic_json_dump
        return atomic_json_dump(path, bundle)


# ---- host-plane incident fan-out ------------------------------------------
# The durable host plane (service/, docs/resilience.md) reports its
# recovery activity here: one call lands the incident in (a) the
# process-global registry counter, (b) the structured event log, and
# (c) every installed FlightRecorder's bounded incident ring, so
# forensics bundles show restarts and wire-CRC rejections next to the
# step records.  Recorders self-install via install_incident_recorder
# (the trainer does this when the flight recorder is armed).

_incident_lock = threading.Lock()
_incident_recorders: List["FlightRecorder"] = []


def install_incident_recorder(recorder: "FlightRecorder") -> None:
    with _incident_lock:
        if recorder not in _incident_recorders:
            _incident_recorders.append(recorder)


def uninstall_incident_recorder(recorder: "FlightRecorder") -> None:
    with _incident_lock:
        if recorder in _incident_recorders:
            _incident_recorders.remove(recorder)


def announce_host_restart(node: str, generation: int, kind: str,
                          **detail) -> None:
    """The one restart-announcement contract both host-plane singletons
    share: bump ``geomx_host_restarts_total{node}``, publish the
    ``geomx_host_generation{node}`` gauge, and fan the incident out
    (``kind`` is ``server_restart`` / ``scheduler_restart``)."""
    try:
        from geomx_tpu_torch.telemetry import get_registry
        reg = get_registry()
        reg.counter("geomx_host_restarts_total",
                    "Host-plane process restarts recovered from the "
                    "durable store", ("node",)).labels(node=node).inc()
        reg.gauge("geomx_host_generation",
                  "Current durable generation per host-plane node",
                  ("node",)).labels(node=node).set(generation)
    except Exception:
        pass
    notify_host_incident(kind, generation=generation, **detail)


def notify_host_incident(kind: str, **detail) -> None:
    """Fan one host-plane incident out to the registry, the event log
    and every installed flight recorder.  Best-effort by design: the
    failure being reported must never be compounded by its reporting."""
    try:
        from geomx_tpu_torch.telemetry import get_registry, log_event
        get_registry().counter(
            "geomx_host_incidents_total",
            "Host-plane incidents (restarts recovered from the durable "
            "store, wire integrity rejections)", ("kind",)).labels(
            kind=kind).inc()
        log_event(kind, **detail)
    except Exception:
        pass
    with _incident_lock:
        recorders = list(_incident_recorders)
    for rec in recorders:
        try:
            rec.record_incident(kind, detail)
        except Exception:
            pass


def flight_enabled(config: Optional[Any] = None) -> bool:
    """``GeoConfig(flight=True)`` or ``GEOMX_FLIGHT`` (same numeric-
    boolean parse as every GEOMX_* knob)."""
    if config is not None and getattr(config, "flight", False):
        return True
    from geomx_tpu_torch.config import _env_bool
    return _env_bool(["GEOMX_FLIGHT"], False)


def flight_recorder_from_config(config: Optional[Any] = None
                                ) -> Optional[FlightRecorder]:
    """The trainer's constructor path: None when the recorder is off;
    otherwise a ring sized/parameterized from config + env
    (GEOMX_FLIGHT_STEPS and the rule-threshold rows)."""
    if not flight_enabled(config):
        return None
    from geomx_tpu_torch.config import _env
    steps = getattr(config, "flight_steps", 0) or \
        _env(["GEOMX_FLIGHT_STEPS"], DEFAULT_STEPS,
             lambda s: int(float(s)))
    dump_dir = getattr(config, "flight_dir", "") or \
        _env(["GEOMX_FLIGHT_DIR"], "geomx_flight", str)
    return FlightRecorder(
        capacity=steps, dump_dir=dump_dir,
        spike_factor=_env(["GEOMX_FLIGHT_SPIKE"], 10.0, float),
        density_drift=_env(["GEOMX_FLIGHT_DENSITY_DRIFT"], 0.5, float),
        exposed_jump=_env(["GEOMX_FLIGHT_EXPOSED_JUMP"], 0.25, float),
        stuck_round_s=_env(["GEOMX_FLIGHT_STUCK_S"], 30.0, float),
        honesty_drift=_env(["GEOMX_FLIGHT_HONESTY_DRIFT"], 0.25, float))
