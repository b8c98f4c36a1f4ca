"""Run capsules: whole-run telemetry capture + bit-exact offline replay
(port of geomx_tpu/telemetry/capsule.py).

The observability planes each dump their own
artifact — registry values are point-in-time, Chrome traces, the event
log, the fleet round ledger and the Pilot's decision log land in
disjoint files with no shared manifest — so nothing reconstructs *a
run* offline.  :class:`RunCapsule` fixes that: one recorder snapshots
the full observability state of a training run into ONE versioned,
atomically-written archive, and :class:`Capsule` reconstructs the
run's sensor surfaces offline, **bit-identically**:

- a **manifest**: the resolved :class:`~geomx_tpu_torch.config.GeoConfig`,
  every ``GEOMX_*``/reference-alias env knob, the chaos schedule,
  build identity and a wall-clock anchor;
- a **registry time series**: periodic full samples of every Counter /
  Gauge / Histogram (:class:`RegistrySampler` — the sampling loop the
  registry itself never had), plus per-step records of the
  ``geomx_step_probe`` / ``geomx_phase_fraction`` gauge families at
  each publish boundary (what :class:`~geomx_tpu_torch.control.sensors.
  ControlSensors` actually reads);
- a **link journal**: every :meth:`LinkObservatory.observe` call with
  its RESOLVED timestamp (the :meth:`~geomx_tpu_torch.telemetry.links.
  LinkObservatory.set_tap` hook) — replaying the journal through a
  fresh observatory in order reproduces the EWMA state, and therefore
  every ``snapshot(now=...)``, bit-identically;
- the Chrome trace(s), the bounded event log, the fleet round ledger
  and the Pilot decision log, all in one archive.

Offline, :meth:`Capsule.sensors` rebuilds the
:class:`~geomx_tpu_torch.control.sensors.ControlSensors` observation
stream (per-step registry views + a journal-fed replay observatory), so
a :class:`~geomx_tpu_torch.control.policy.GraftPilot` re-ticked over the
capsule reproduces the live decision sequence exactly — the
deterministic-replay substrate an offline planner search and the
fitted step-time cost model
(:mod:`geomx_tpu_torch.telemetry.costmodel`) build on.

Gated by ``GEOMX_CAPSULE`` / ``GeoConfig(capsule=True)``; archive
location ``GEOMX_CAPSULE_DIR``, sampler cadence
``GEOMX_CAPSULE_SAMPLE_S`` (docs/telemetry.md "Run capsules").
Everything here is host-plane Python.

The archive's decision-log section is the control plane's
``DecisionLog`` snapshot (``control/actuators.py``), and
:meth:`Capsule.replay_decisions` re-ticks a Pilot over the recorded
sensor stream to reproduce it.  The manifest's env section resolves the
``GEOMX_*`` surface, the reference aliases and PyTorch's and CUDA's
backend variables.
"""

from __future__ import annotations

import collections
import os
import platform
import sys
import threading
import time
from typing import Any, Dict, List, Optional

CAPSULE_KIND = "geomx_run_capsule"
CAPSULE_VERSION = 1

DEFAULT_SAMPLE_S = 10.0
DEFAULT_MAX_SAMPLES = 512
DEFAULT_MAX_STEPS = 4096
DEFAULT_MAX_JOURNAL = 262_144
DEFAULT_MAX_TRACES = 8

# env prefixes the manifest resolves (the GEOMX_* surface plus the
# reference aliases config.py honors and the backend-shaping vars)
_ENV_PREFIXES = ("GEOMX_", "DMLC_", "MXNET_", "TORCH_", "PYTORCH_",
                 "CUDA_")


def _geomx_version() -> str:
    try:
        from importlib.metadata import version
        return version("geomx-tpu")
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# registry sampling (the time-series loop the registry never had)
# ---------------------------------------------------------------------------

def sample_registry(registry=None,
                    max_children_per_family: int = 0) -> Dict[str, dict]:
    """One full, JSON-able snapshot of every registry family: counters
    and gauges as values, histograms as (bounds, bucket counts, sum,
    count).  ``max_children_per_family`` bounds high-cardinality
    families (dropped children are counted, never silently lost) —
    the flight recorder's bundle section uses it to keep the same size
    discipline as its ring."""
    from geomx_tpu_torch.telemetry.registry import HistogramChild, get_registry
    reg = registry if registry is not None else get_registry()
    out: Dict[str, dict] = {}
    for fam in reg.collect():
        children = fam.children()
        dropped = 0
        if max_children_per_family and \
                len(children) > max_children_per_family:
            dropped = len(children) - max_children_per_family
            children = children[:max_children_per_family]
        rows: List[dict] = []
        for values, child in children:
            row: Dict[str, Any] = {"labels": list(values)}
            if isinstance(child, HistogramChild):
                cum, total, count = child.snapshot()
                row.update(buckets=list(child.upper_bounds),
                           counts=cum, sum=total, count=count)
            else:
                row["value"] = child.value
            rows.append(row)
        entry: Dict[str, Any] = {"type": fam.type,
                                 "label_names": list(fam.label_names),
                                 "children": rows}
        if dropped:
            entry["dropped_children"] = dropped
        out[fam.name] = entry
    return out


class RegistrySampler:
    """Periodic whole-registry sampler: a bounded time series of
    :func:`sample_registry` snapshots.  :meth:`sample` takes one sample
    at an explicit ``now`` (the bench's virtual clock); :meth:`start`
    runs a wall-clock daemon loop at ``interval_s`` for live runs."""

    def __init__(self, registry=None, interval_s: float = DEFAULT_SAMPLE_S,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        self.registry = registry
        # a non-positive cadence would make the daemon loop's
        # stop.wait(0) a busy spin walking the whole registry — clamp
        # to the documented default ("0 = 10 s", config.py)
        self.interval_s = float(interval_s) if interval_s \
            and float(interval_s) > 0 else DEFAULT_SAMPLE_S
        self.samples: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(max_samples)))
        self.dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def sample(self, now: Optional[float] = None) -> dict:
        entry = {"t": time.time() if now is None else float(now),
                 "families": sample_registry(self.registry)}
        with self._lock:
            if len(self.samples) == self.samples.maxlen:
                self.dropped += 1
            self.samples.append(entry)
        return entry

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.samples)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception:
                    pass  # sampling must never take down the run

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="capsule-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------

def _gauge_map(registry, family: str) -> Dict[str, float]:
    """{first-label-value: value} over one gauge family — the exact
    read :class:`ControlSensors` performs, duplicated here so telemetry
    never imports control (control imports telemetry)."""
    fam = registry.get(family)
    if fam is None:
        return {}
    out: Dict[str, float] = {}
    for label_values, child in fam.children():
        out[label_values[0] if label_values else ""] = float(child.value)
    return out


class RunCapsule:
    """Record one training run's whole observability state into a
    single versioned archive at ``path`` (atomic on every
    :meth:`write`, via :mod:`geomx_tpu_torch.utils.atomicio`).

    The recorder is fed from four directions: per-step records at the
    trainer's publish boundary (:meth:`record_step`), the link journal
    via :meth:`attach_observatory`, periodic registry samples
    (:attr:`sampler`), and run-scoped artifacts collected at
    :meth:`write` time (traces, event log, round ledger, decision
    log).  Every buffer is bounded with a dropped counter — a capsule
    whose journal overflowed says so instead of replaying wrong.
    """

    def __init__(self, path: str, *, config=None,
                 sample_s: float = DEFAULT_SAMPLE_S,
                 registry=None,
                 max_steps: int = DEFAULT_MAX_STEPS,
                 max_journal: int = DEFAULT_MAX_JOURNAL,
                 extra_manifest: Optional[dict] = None):
        self.path = str(path)
        # reclaim orphans a hard kill mid-write left behind (the
        # archive rewrites at every fit end; see atomicio)
        from geomx_tpu_torch.utils.atomicio import sweep_stale_tmp
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        sweep_stale_tmp(d)
        self.registry = registry
        self._lock = threading.Lock()
        self._steps: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(max_steps)))
        self.steps_dropped = 0
        self._journal: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(max_journal)))
        self.journal_dropped = 0
        self._traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._observatory = None
        self.sampler = RegistrySampler(registry=registry,
                                       interval_s=sample_s)
        self.writes = 0
        cfg_dict = None
        if config is not None:
            import dataclasses
            cfg_dict = dataclasses.asdict(config) \
                if dataclasses.is_dataclass(config) else dict(config)
        # graftlint: disable=GXL006 — the manifest's whole job is
        # recording the resolved env surface at run start
        env = {k: v for k, v in sorted(os.environ.items())
               if k.startswith(_ENV_PREFIXES)}
        self.manifest: Dict[str, Any] = {
            "kind": CAPSULE_KIND,
            "version": CAPSULE_VERSION,
            "created_unix": round(time.time(), 6),
            "anchor_unix": round(time.time(), 6),
            "config": cfg_dict,
            "env": env,
            "chaos_schedule": (cfg_dict or {}).get("chaos_schedule", "")
            or env.get("GEOMX_CHAOS_SCHEDULE", ""),
            "sample_s": float(sample_s),
            "build": {
                "geomx_version": _geomx_version(),
                "python": sys.version.split()[0],
                "platform": platform.platform(),
            },
        }
        if extra_manifest:
            self.manifest["extra"] = dict(extra_manifest)

    # ---- feeds -------------------------------------------------------------

    def attach_observatory(self, observatory) -> None:
        """Install the link-journal tap on ``observatory`` and record
        its fold parameters in the manifest (the replay observatory is
        reconstructed with the same alpha / staleness half-life)."""
        self._observatory = observatory
        self.manifest["observatory"] = {
            "alpha": observatory.alpha,
            "stale_after_s": observatory.stale_after_s,
        }
        observatory.set_tap(self._link_tap)

    def detach_observatory(self) -> None:
        if self._observatory is not None:
            self._observatory.set_tap(None)
            self._observatory = None

    def _link_tap(self, entry: dict) -> None:
        # called under the observatory lock (journal order == fold
        # order); the capsule lock nests inside it so write() can
        # snapshot the journal from another thread — never take the
        # observatory lock while holding the capsule lock
        with self._lock:
            if len(self._journal) == self._journal.maxlen:
                self.journal_dropped += 1
            self._journal.append(entry)

    def record_step(self, step: int, t: Optional[float] = None,
                    probes: Optional[Dict[str, Any]] = None,
                    phases: Optional[Dict[str, float]] = None,
                    timing: Optional[Dict[str, float]] = None,
                    extra: Optional[Dict[str, Any]] = None) -> dict:
        """Record one step's sensor surface.  ``probes``/``phases``
        default to the live ``geomx_step_probe`` /
        ``geomx_phase_fraction`` gauge families — exactly what a
        control tick at this moment would read, which is what makes
        the replayed observation stream bit-identical.  ``t`` is the
        run clock at the record (virtual in seeded replays; wall clock
        in live runs); ``timing`` carries measured per-step seconds
        (``total_s`` / ``compute_s`` / ``wan_s`` / ``exposed_s``) the
        cost model fits on."""
        if probes is None or phases is None:
            from geomx_tpu_torch.telemetry.registry import get_registry
            reg = self.registry if self.registry is not None \
                else get_registry()
            if probes is None:
                probes = _gauge_map(reg, "geomx_step_probe")
            if phases is None:
                phases = _gauge_map(reg, "geomx_phase_fraction")
        rec: Dict[str, Any] = {
            "step": int(step),
            "t": time.time() if t is None else float(t),
            "probes": dict(probes),
            "phases": dict(phases),
        }
        if timing:
            rec["timing"] = {k: float(v) for k, v in timing.items()}
        if extra:
            rec["extra"] = dict(extra)
        with self._lock:
            if len(self._steps) == self._steps.maxlen:
                self.steps_dropped += 1
            self._steps.append(rec)
        return rec

    def set_param_shapes(self, shapes: Dict[str, dict]) -> None:
        """Record the model's flat parameter layout
        (``{path: {"shape": [...], "dtype": "float32"}}``) — the cost
        model's input for candidate wire-byte accounting."""
        self.manifest["param_shapes"] = {
            str(k): {"shape": [int(d) for d in v["shape"]],
                     "dtype": str(v["dtype"])}
            for k, v in shapes.items()}

    def add_trace(self, doc: dict, label: str = "rank0") -> None:
        """Attach one Chrome trace document (``Profiler.to_doc()`` /
        ``merge_traces`` output).  Re-adding a label replaces it, so a
        trainer can refresh its trace at every write; the trace count
        is bounded at the oldest-label eviction."""
        with self._lock:
            self._traces[str(label)] = doc
            self._traces.move_to_end(str(label))
            while len(self._traces) > DEFAULT_MAX_TRACES:
                self._traces.popitem(last=False)

    # ---- archive -----------------------------------------------------------

    def _summary(self, steps: List[dict], journal: List[dict],
                 now: Optional[float] = None) -> dict:
        """Pre-computed cross-section summary stored IN the archive so
        ``tools/runcap.py diff``/``explain`` (and benchtrend's
        regression explainer) stay stdlib-only readers."""
        out: Dict[str, Any] = {"num_steps": len(steps)}
        if steps:
            out["first_t"] = steps[0]["t"]
            out["last_t"] = steps[-1]["t"]
            phase_acc: Dict[str, List[float]] = {}
            probe_acc: Dict[str, List[float]] = {}
            for rec in steps:
                for k, v in rec.get("phases", {}).items():
                    phase_acc.setdefault(k, []).append(float(v))
                for k, v in rec.get("probes", {}).items():
                    if isinstance(v, (int, float)):
                        probe_acc.setdefault(k, []).append(float(v))
            out["phase_means"] = {
                k: sum(v) / len(v) for k, v in sorted(phase_acc.items())}
            out["probe_medians"] = {
                k: sorted(v)[len(v) // 2]
                for k, v in sorted(probe_acc.items())}
        # whole-run per-link aggregates from the journal: a diff between
        # two RUNS must see a mid-run degradation even when the final
        # EWMA state has recovered by run end
        agg: Dict[str, dict] = {}
        for e in journal:
            a = agg.setdefault(f"{e['party']}->{e['peer']}", {
                "samples": 0, "failures": 0, "ok_timed": 0,
                "bytes": 0.0, "seconds": 0.0, "min_bps": None})
            a["samples"] += 1
            if not e.get("ok", True):
                a["failures"] += 1
                continue
            sec = e.get("seconds")
            if not sec:
                continue
            nb = float(e.get("nbytes") or 0.0)
            a["ok_timed"] += 1
            a["seconds"] += float(sec)
            a["bytes"] += nb
            if nb > 0:
                bps = nb / float(sec)
                if a["min_bps"] is None or bps < a["min_bps"]:
                    a["min_bps"] = bps
        out["links"] = {
            k: {
                "throughput_bps": (a["bytes"] / a["seconds"])
                if a["seconds"] and a["bytes"] else None,
                "rtt_s": (a["seconds"] / a["ok_timed"])
                if a["ok_timed"] else None,
                "loss_rate": a["failures"] / a["samples"],
                "min_throughput_bps": a["min_bps"],
                "samples": a["samples"],
            } for k, a in sorted(agg.items())}
        if self._observatory is not None:
            snap_now = now
            if snap_now is None and journal:
                snap_now = journal[-1]["t"]
            out["links_final"] = self._observatory.snapshot(now=snap_now)
        try:
            from geomx_tpu_torch.telemetry.ledger import get_round_ledger
            led_summary = get_round_ledger().summary(now=now)
            if "wire_honesty_ratio_mean" in led_summary:
                out["wire_honesty_ratio"] = \
                    led_summary["wire_honesty_ratio_mean"]
        except Exception:
            pass
        return out

    def write(self, now: Optional[float] = None,
              include_ledger: bool = True,
              include_events: bool = True,
              include_decisions: bool = True) -> str:
        """Write the whole archive atomically (safe to call repeatedly
        — a crash between writes leaves the previous complete capsule).
        ``now`` pins the clock-dependent summary fields in seeded
        replays."""
        with self._lock:
            steps = list(self._steps)
            journal = list(self._journal)
            traces = [{"label": label, "doc": doc}
                      for label, doc in self._traces.items()]
        doc: Dict[str, Any] = {
            "manifest": dict(self.manifest,
                             written_unix=round(time.time(), 6),
                             steps_dropped=self.steps_dropped,
                             journal_dropped=self.journal_dropped,
                             samples_dropped=self.sampler.dropped),
            "registry_samples": self.sampler.snapshot(),
            "steps": steps,
            "link_journal": journal,
            "traces": traces,
        }
        if include_ledger:
            try:
                from geomx_tpu_torch.telemetry.ledger import get_round_ledger
                led = get_round_ledger()
                doc["ledger"] = {"records": led.records(),
                                 "summary": led.summary(now=now)}
            except Exception:
                doc["ledger"] = {"records": [], "summary": {}}
        if include_events:
            try:
                from geomx_tpu_torch.telemetry.export import get_event_log
                log = get_event_log()
                doc["events"] = log.read() if log is not None else []
            except Exception:
                doc["events"] = []
        if include_decisions:
            try:
                from geomx_tpu_torch.control.actuators import \
                    get_decision_log
                doc["decisions"] = get_decision_log().snapshot()
            except Exception:
                doc["decisions"] = []
        doc["summary"] = self._summary(steps, journal, now=now)
        from geomx_tpu_torch.utils.atomicio import atomic_json_dump
        path = atomic_json_dump(self.path, doc,
                                default=_capsule_json_default)
        self.writes += 1
        return path

    def close(self, now: Optional[float] = None) -> str:
        """Stop the sampler, detach the tap and write the final
        archive."""
        self.sampler.stop()
        path = self.write(now=now)
        self.detach_observatory()
        return path


def _capsule_json_default(o):
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(o)


# ---------------------------------------------------------------------------
# loader / replay
# ---------------------------------------------------------------------------

class _GaugeView:
    __slots__ = ("value",)

    def __init__(self, value: float):
        self.value = float(value)


class _FamilyView:
    """Registry-family stand-in over one recorded mapping
    ``{label_value: float}`` — implements exactly the surface
    ``ControlSensors`` reads (``children()``)."""

    def __init__(self, mapping: Dict[str, float]):
        self._mapping = mapping

    def children(self):
        return sorted(((str(k),), _GaugeView(v))
                      for k, v in self._mapping.items())


class _StepRegistryView:
    """The registry as one recorded step saw it: the two gauge
    families the control sensors read, served from the step record."""

    def __init__(self, rec: dict):
        self._fams = {
            "geomx_step_probe": _FamilyView(
                {k: v for k, v in rec.get("probes", {}).items()
                 if isinstance(v, (int, float))}),
            "geomx_phase_fraction": _FamilyView(
                {k: float(v) for k, v in rec.get("phases", {}).items()}),
        }

    def get(self, name: str):
        return self._fams.get(name)


class _ReplayObservatory:
    """A :class:`LinkObservatory` fed lazily from the capsule's link
    journal: before every snapshot at ``now``, all journal entries
    with ``t <= now`` (in append order — which recorded fold order)
    are folded in, so the EWMA state at any replay instant is
    bit-identical to the live state at that instant.  Entries later
    than ``now`` stay pending — a replayed controller never sees the
    future."""

    def __init__(self, journal: List[dict], alpha: float,
                 stale_after_s: float):
        from geomx_tpu_torch.telemetry.links import LinkObservatory
        self._obs = LinkObservatory(alpha=alpha,
                                    stale_after_s=stale_after_s)
        self._journal = journal
        self._idx = 0

    def _feed_upto(self, now: Optional[float]) -> None:
        while self._idx < len(self._journal):
            e = self._journal[self._idx]
            if now is not None and e["t"] > now:
                return
            self._obs.observe(e["party"], e["peer"],
                              nbytes=e.get("nbytes", 0.0),
                              seconds=e.get("seconds"),
                              ok=e.get("ok", True), t=e["t"])
            self._idx += 1

    def snapshot(self, now: Optional[float] = None,
                 min_confidence: Optional[float] = None):
        self._feed_upto(now)
        return self._obs.snapshot(now=now, min_confidence=min_confidence)

    def best_relay_order(self, peer: str = "global",
                         now: Optional[float] = None,
                         min_confidence: float = 0.0):
        self._feed_upto(now)
        return self._obs.best_relay_order(peer=peer, now=now,
                                          min_confidence=min_confidence)


class Capsule:
    """A loaded run capsule: the archive's sections plus the offline
    reconstruction surfaces (replay observatory, per-step registry
    views, sensor stream, decision replay)."""

    def __init__(self, doc: dict, path: Optional[str] = None):
        manifest = doc.get("manifest") or {}
        if manifest.get("kind") != CAPSULE_KIND:
            raise ValueError(
                f"not a run capsule (kind={manifest.get('kind')!r})")
        if manifest.get("version") != CAPSULE_VERSION:
            raise ValueError(
                f"unsupported capsule version {manifest.get('version')!r}"
                f" (this build reads version {CAPSULE_VERSION})")
        self.doc = doc
        self.path = path
        self.manifest = manifest
        self.steps: List[dict] = doc.get("steps") or []
        self.link_journal: List[dict] = doc.get("link_journal") or []
        self.registry_samples: List[dict] = \
            doc.get("registry_samples") or []
        self.traces: List[dict] = doc.get("traces") or []
        self.ledger: dict = doc.get("ledger") or {}
        self.events: List[dict] = doc.get("events") or []
        self.decisions: List[dict] = doc.get("decisions") or []
        self.summary: dict = doc.get("summary") or {}

    @classmethod
    def load(cls, path: str) -> "Capsule":
        import json
        with open(path) as f:
            return cls(json.load(f), path=path)

    # ---- replay surfaces ---------------------------------------------------

    def _obs_params(self):
        p = self.manifest.get("observatory") or {}
        return float(p.get("alpha", 0.3)), \
            float(p.get("stale_after_s", 30.0))

    def observatory(self) -> _ReplayObservatory:
        """A fresh replay observatory over the link journal (nothing
        folded yet — feeds advance with each ``snapshot(now=...)``)."""
        alpha, stale = self._obs_params()
        return _ReplayObservatory(self.link_journal, alpha, stale)

    def link_snapshot(self, now: Optional[float] = None,
                      min_confidence: Optional[float] = None) -> dict:
        """The per-link snapshot at ``now`` (default: after the whole
        journal) — bit-identical to what the live observatory reported
        at that instant."""
        obs = self.observatory()
        if now is None and self.link_journal:
            now = self.link_journal[-1]["t"]
        return obs.snapshot(now=now, min_confidence=min_confidence)

    def registry_at(self, step: int):
        """The control-sensor registry view recorded at ``step`` (the
        latest record at or before it)."""
        best = None
        for rec in self.steps:
            if rec["step"] <= int(step):
                best = rec
            else:
                break
        if best is None:
            return _StepRegistryView({})
        return _StepRegistryView(best)

    def sensors(self, min_confidence: float = 0.5, compute_s_fn=None):
        """A :class:`~geomx_tpu_torch.control.sensors.ControlSensors`
        whose ``observe(step, now)`` reads the capsule instead of the
        live planes — the offline observation stream."""
        from geomx_tpu_torch.control.sensors import ControlSensors
        return ControlSensors(observatory=self.observatory(),
                              min_confidence=min_confidence,
                              compute_s_fn=compute_s_fn,
                              registry_fn=self.registry_at)

    def replay_decisions(self, pilot_factory,
                         min_confidence: float = 0.5,
                         compute_s_fn=None) -> List[dict]:
        """Re-tick a Pilot over the capsule: ``pilot_factory(sensors)``
        must build the same policy stack the live run used (policies
        are pure functions of their constructor args + observations,
        so identical observations reproduce the live decision sequence
        exactly).  Returns the decisions' JSON forms, comparable
        against the live ``DecisionLog.snapshot()``."""
        sensors = self.sensors(min_confidence=min_confidence,
                               compute_s_fn=compute_s_fn)
        pilot = pilot_factory(sensors)
        out: List[dict] = []
        for rec in self.steps:
            for dec in pilot.tick(rec["step"], now=rec.get("t")):
                out.append(dec.to_json())
        return out


# ---------------------------------------------------------------------------
# config surface
# ---------------------------------------------------------------------------

def capsule_enabled(config: Optional[Any] = None) -> bool:
    """``GeoConfig(capsule=True)`` or ``GEOMX_CAPSULE`` (same
    numeric-boolean parse as every GEOMX_* knob)."""
    if config is not None and getattr(config, "capsule", False):
        return True
    from geomx_tpu_torch.config import _env_bool
    return _env_bool(["GEOMX_CAPSULE"], False)


def capsule_from_config(config: Optional[Any] = None
                        ) -> Optional[RunCapsule]:
    """The trainer's constructor path: None when recording is off;
    otherwise a recorder at ``<GEOMX_CAPSULE_DIR>/run_capsule.json``
    sampling every ``GEOMX_CAPSULE_SAMPLE_S`` seconds."""
    if not capsule_enabled(config):
        return None
    from geomx_tpu_torch.config import _env
    cap_dir = getattr(config, "capsule_dir", "") or \
        _env(["GEOMX_CAPSULE_DIR"], "geomx_capsule", str)
    sample_s = getattr(config, "capsule_sample_s", 0.0) or \
        _env(["GEOMX_CAPSULE_SAMPLE_S"], DEFAULT_SAMPLE_S, float)
    return RunCapsule(os.path.join(cap_dir, "run_capsule.json"),
                      config=config, sample_s=sample_s)
