"""FleetScope: fleet-wide observability aggregation and freshness
tracing (port of geomx_tpu/telemetry/fleetscope.py).

Every observability surface of the host plane — the RoundLedger and the
per-process ``/metrics``/``/healthz``/``/ledger`` endpoints — is
per-process: no component answers "how healthy is the fleet right now"
or "how long does a gradient pushed by a party take to reach an
inference reply".  FleetScope is that component, three pieces in one
module that imports neither torch nor numpy (safe in the scheduler
process):

- :class:`FleetScope` — a scheduler-colocated aggregator that discovers
  every node from the scheduler roster (``serve`` nodes poll over HTTP;
  any other role opts in with an ``http=<port>`` tag field), polls
  ``/metrics`` (through the strict
  :func:`~geomx_tpu_torch.telemetry.export.parse_prometheus_text`),
  ``/healthz`` and ``/ledger?summary=1`` on a bounded interval, and
  folds the results into ONE versioned fleet document.  Dead or stale
  nodes are marked, never fatal: a node that stops answering keeps its
  last-known entry with the links.py staleness idiom
  (``confidence = 2^(-age/stale_after_s)``, ``stale`` below 0.5) and a
  named reason, and every other node's fold is identical to a fold
  without the failure;
- :class:`BurnRateMonitor` — a deterministic multi-window SLO burn-rate
  monitor: ``record(t, good, bad)`` appends to a bounded series and
  ``evaluate(now)`` is a pure fold over it, so the same series evaluated
  at the same instants gives the same breach list.  A breach onset emits
  a ``flight_anomaly`` event and bumps
  ``geomx_fleet_burn_breaches_total``;
- :class:`PropagationTracker` — the gradient-to-inference freshness
  join: training RoundLedger merge/journal hops, registry delta
  publish, replica apply and the first request served on that round,
  one wall-clock instant per (round, stage), folded into per-round
  propagation latency (p50/p99) and exported as the
  ``geomx_fleet_propagation_seconds`` histogram.

Fleet rollups (QPS, shed rate, request p50/p99, honesty max, replica
staleness max, node health counts) publish as the
``geomx_fleet_rollup{field}`` gauge family, the surface
:class:`~geomx_tpu_torch.control.sensors.ControlSensors` folds into
every observation.  The serve-node rollups fold whatever families and
health sections a node serves: a gateway (``serve/gateway.py``)
registers as a ``serve`` node whose HTTP port serves its
``geomx_serve_*`` families, its ``/healthz`` serving block and its
request ledger; on a training fleet without one those rollups stay at
zero.

``tools/gxtop.py`` renders the fleet document (snapshot / ``--watch`` /
``--json``).
"""

from __future__ import annotations

import collections
import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_INTERVAL_S = 2.0
DEFAULT_STALE_AFTER_S = 10.0
DEFAULT_BURN_WINDOWS = "60:14,300:6"
DEFAULT_SLO_TARGET = 0.99
DEFAULT_SLO_P99_S = 0.5
DEFAULT_PROPAGATION_ROUNDS = 512
DEFAULT_TRANSITIONS = 256

PROPAGATION_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 30.0)

# the propagation join's hop order: a round's latency is first-served
# minus the earliest training-side instant we know about (merge when
# the RoundLedger saw it, else the registry publish)
PROP_STAGES = ("merge", "publish", "apply", "served")


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (the
    RequestLedger's rule, duplicated so this module stays import-light)."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[rank]


# ---------------------------------------------------------------------------
# propagation tracker: the gradient-to-inference freshness join
# ---------------------------------------------------------------------------

class PropagationTracker:
    """One record per training round: the wall-clock instants of its
    merge/publish/apply hops and the first request served on it (per
    transport).  Writes are a dict hit under one lock; FIFO-bounded at
    ``capacity`` rounds.  ``note`` keeps the EARLIEST instant per
    (round, stage) — replays and re-applies never move a watermark
    backward in time."""

    def __init__(self, capacity: int = DEFAULT_PROPAGATION_ROUNDS):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._rounds: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self.noted_total = 0

    def note(self, round_id: int, stage: str, t: Optional[float] = None,
             transport: Optional[str] = None) -> None:
        if round_id is None or int(round_id) <= 0:
            return
        if stage not in PROP_STAGES:
            raise ValueError(f"unknown propagation stage {stage!r}")
        t = time.time() if t is None else float(t)
        served_fresh = False
        with self._lock:
            rec = self._rounds.get(int(round_id))
            if rec is None:
                rec = {"round": int(round_id), "served_by": {}}
                self._rounds[int(round_id)] = rec
                while len(self._rounds) > self.capacity:
                    self._rounds.popitem(last=False)
            if stage == "served":
                if "served" not in rec:
                    rec["served"] = t
                    served_fresh = True
                rec["served"] = min(rec["served"], t)
                if transport is not None:
                    lane = rec["served_by"]
                    lane[str(transport)] = min(
                        lane.get(str(transport), t), t)
            else:
                rec[stage] = min(rec.get(stage, t), t)
            self.noted_total += 1
            span = self._span(rec) if served_fresh else None
        if span is not None:
            self._publish_span(span)

    @staticmethod
    def _span(rec: dict) -> Optional[float]:
        """The round's propagation latency: first-served minus the
        earliest training-side instant (merge preferred, publish the
        fallback).  None until both ends exist."""
        if "served" not in rec:
            return None
        origin = rec.get("merge", rec.get("publish"))
        if origin is None:
            return None
        return max(0.0, rec["served"] - origin)

    def _publish_span(self, span: float) -> None:
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().histogram(
                "geomx_fleet_propagation_seconds",
                "Gradient-to-inference propagation latency per round "
                "(training merge/publish -> first request served)",
                buckets=PROPAGATION_BUCKETS).observe(float(span))
        except Exception:
            pass

    def rounds(self) -> List[dict]:
        with self._lock:
            out = []
            for rec in self._rounds.values():
                d = dict(rec)
                d["served_by"] = dict(rec["served_by"])
                span = self._span(rec)
                if span is not None:
                    d["propagation_s"] = span
                out.append(d)
            return out

    def ingest_round_records(self, records) -> int:
        """Fold RoundLedger record snapshots (``RoundLedger.records()``
        or a polled ``GET /ledger`` body's ``records``) into merge-stage
        notes: each record's earliest ``merge`` hop wall instant —
        ``journal`` as the fallback — anchors its round's join.
        Returns the number of rounds noted."""
        noted = 0
        for rec in records or ():
            try:
                round_id = int(rec.get("round", 0))
                hops = rec.get("hops") or ()
            except AttributeError:
                continue
            if round_id <= 0:
                continue
            best = None
            for hop in hops:
                if hop.get("hop") in ("merge", "journal") \
                        and "t" in hop:
                    t = float(hop["t"])
                    if best is None or t < best:
                        best = t
            if best is not None:
                self.note(round_id, "merge", t=best)
                noted += 1
        return noted

    def summary(self) -> Dict[str, Any]:
        """p50/p99 propagation over completed rounds + per-transport
        completion counts (the ``--fleetscope`` both-doors gate)."""
        recs = self.rounds()
        spans = sorted(r["propagation_s"] for r in recs
                       if "propagation_s" in r)
        by_transport: Dict[str, int] = {}
        for r in recs:
            if "propagation_s" not in r:
                continue
            for lane in r["served_by"]:
                by_transport[lane] = by_transport.get(lane, 0) + 1
        return {"rounds_tracked": len(recs),
                "rounds_completed": len(spans),
                "p50_s": _percentile(spans, 0.50),
                "p99_s": _percentile(spans, 0.99),
                "max_s": spans[-1] if spans else 0.0,
                "by_transport": by_transport}


_prop_tracker: Optional[PropagationTracker] = None
_prop_lock = threading.Lock()


def get_propagation_tracker() -> PropagationTracker:
    global _prop_tracker
    with _prop_lock:
        if _prop_tracker is None:
            _prop_tracker = PropagationTracker()
        return _prop_tracker


def reset_propagation_tracker(capacity: Optional[int] = None
                              ) -> PropagationTracker:
    """Fresh global tracker (test isolation, replays)."""
    global _prop_tracker
    with _prop_lock:
        _prop_tracker = PropagationTracker(
            capacity=capacity if capacity is not None
            else DEFAULT_PROPAGATION_ROUNDS)
        return _prop_tracker


def note_propagation(round_id: int, stage: str,
                     t: Optional[float] = None,
                     transport: Optional[str] = None) -> None:
    """Module-level forwarder the hop producers call (registry delta
    apply, replica apply, gateway serve) — lazy like the ledger's
    forwarders, and best-effort by design: freshness tracing must never
    take down the plane it traces."""
    try:
        get_propagation_tracker().note(round_id, stage, t=t,
                                       transport=transport)
    except ValueError:
        raise
    except Exception:
        pass


# ---------------------------------------------------------------------------
# deterministic multi-window SLO burn-rate monitor
# ---------------------------------------------------------------------------

def parse_burn_windows(spec: str) -> Tuple[Tuple[float, float], ...]:
    """``"60:14,300:6"`` -> ((60.0, 14.0), (300.0, 6.0)) — each pair is
    (window seconds, burn-rate threshold).  The multi-window AND rule
    (every window over its threshold) is the standard fast+slow pager
    pairing: the short window catches the spike, the long window proves
    it is not a blip."""
    out = []
    for part in (spec or DEFAULT_BURN_WINDOWS).split(","):
        part = part.strip()
        if not part:
            continue
        win, _, thr = part.partition(":")
        w, t = float(win), float(thr or 1.0)
        if w <= 0 or t <= 0:
            raise ValueError(f"bad burn window {part!r} in {spec!r}")
        out.append((w, t))
    if not out:
        raise ValueError(f"empty burn-window spec {spec!r}")
    return tuple(sorted(out))


class BurnRateMonitor:
    """Multi-window error-budget burn over a recorded (t, good, bad)
    series.  ``burn = bad_fraction / (1 - slo_target)``: burn 1.0
    consumes the budget exactly at the rate it refills; burn 14 over a
    60 s window eats an hour's budget in ~4 minutes.  A breach fires at
    the ONSET of every window simultaneously exceeding its threshold,
    and re-arms only after every window recovers — one event per
    episode, never a flap storm.

    Deterministic by construction: ``record`` stores explicit
    timestamps and ``evaluate(now)`` is a pure fold over the stored
    series — no clock is ever sampled inside the fold, so replaying the
    same series at the same instants yields a bit-identical breach list
    (the links.py/flight.py discipline)."""

    def __init__(self, windows=None, slo_target: float = DEFAULT_SLO_TARGET,
                 capacity: int = 4096):
        if isinstance(windows, str) or windows is None:
            windows = parse_burn_windows(windows or DEFAULT_BURN_WINDOWS)
        self.windows = tuple((float(w), float(t)) for w, t in windows)
        if not 0.0 < float(slo_target) < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1) (got {slo_target!r})")
        self.slo_target = float(slo_target)
        self.capacity = max(len(self.windows) + 1, int(capacity))
        self._series: "collections.deque" = \
            collections.deque(maxlen=self.capacity)
        self._breached = False
        self.breaches: List[dict] = []

    def record(self, t: float, good: float, bad: float) -> None:
        self._series.append((float(t), max(0.0, float(good)),
                             max(0.0, float(bad))))

    def burn_rates(self, now: float) -> List[dict]:
        """The pure per-window fold: bad fraction over the window's
        recorded ticks, scaled into budget-burn multiples."""
        now = float(now)
        out = []
        budget = 1.0 - self.slo_target
        for window_s, threshold in self.windows:
            good = bad = 0.0
            for t, g, b in self._series:
                if now - window_s < t <= now:
                    good += g
                    bad += b
            total = good + bad
            frac = (bad / total) if total > 0 else 0.0
            out.append({"window_s": window_s,
                        "threshold": threshold,
                        "good": good, "bad": bad,
                        "bad_fraction": frac,
                        "burn": frac / budget})
        return out

    def evaluate(self, now: float) -> Optional[dict]:
        """One deterministic tick: returns the breach dict at onset,
        None otherwise.  The onset emits ``flight_anomaly`` (rule
        ``fleet_burn_rate``) and bumps the breach counter best-effort —
        the returned/stored breach record itself is a pure function of
        the series, so determinism gates never see telemetry jitter."""
        rates = self.burn_rates(now)
        over = all(r["burn"] >= r["threshold"] and
                   (r["good"] + r["bad"]) > 0 for r in rates)
        if not over:
            if self._breached and all(
                    r["burn"] < r["threshold"] for r in rates):
                self._breached = False
            return None
        if self._breached:
            return None
        self._breached = True
        breach = {"rule": "fleet_burn_rate", "t": float(now),
                  "windows": rates,
                  "max_burn": max(r["burn"] for r in rates)}
        self.breaches.append(breach)
        try:
            from geomx_tpu_torch.telemetry.export import log_event
            log_event("flight_anomaly", rule="fleet_burn_rate",
                      t=float(now), max_burn=breach["max_burn"],
                      windows=[(r["window_s"], round(r["burn"], 4))
                               for r in rates])
        except Exception:
            pass
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().counter(
                "geomx_fleet_burn_breaches_total",
                "Fleet SLO burn-rate breach onsets").inc()
        except Exception:
            pass
        return breach

    def max_burn(self, now: float) -> float:
        rates = self.burn_rates(now)
        return max((r["burn"] for r in rates), default=0.0)


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

def _default_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8")


def roster_targets(roster: Dict[str, list],
                   dead_ids=()) -> List[dict]:
    """Roster entries -> FleetScope node descriptors.  ``serve`` nodes
    registered their HTTP port directly (satellite: gateways/replicas
    register as node kind ``serve``); any other role opts into HTTP
    polling with an ``http=<port>`` field in its tag (fields are
    ``;``-separated).  Nodes with no HTTP surface are still tracked —
    their health comes from the scheduler's heartbeat dead list."""
    dead = {int(d) for d in dead_ids}
    out = []
    for role in sorted(roster):
        for entry in sorted(roster[role]):
            node_id, host, port = int(entry[0]), str(entry[1]), \
                int(entry[2])
            tag = str(entry[3]) if len(entry) > 3 else ""
            # port 0 = no HTTP surface (heartbeat-covered only), the
            # registry's binary-wire-only registration shape
            http_port = port if role == "serve" and port else None
            for field in tag.split(";"):
                if field.startswith("http="):
                    try:
                        http_port = int(field[5:])
                    except ValueError:
                        pass
            label = tag.split(";")[0] if tag else ""
            name = f"{role}:{label}" if label else f"{role}:{node_id}"
            out.append({"name": name, "kind": role, "id": node_id,
                        "host": host, "port": port,
                        "http_port": http_port,
                        "dead": node_id in dead})
    return out


class FleetScope:
    """The scheduler-colocated fleet aggregator.

    ``scheduler``: a :class:`~geomx_tpu_torch.service.scheduler.GeoScheduler`
    to discover nodes from (roster + heartbeat dead list + its own
    metrics endpoint).  ``targets_fn``: the injectable alternative — a
    zero-arg callable returning node descriptor dicts (the
    :func:`roster_targets` shape); tests and replays drive this.
    ``fetch_fn(url, timeout_s) -> text`` is injectable the same way, so
    the degradation tests can serve torn bodies and timeouts without a
    socket.  All polling state is per node-name; a fold is a pure
    function of (fetch results, dead list, ``now``), which is what
    makes the one-node-dies degradation bit-identical for every other
    node."""

    def __init__(self, scheduler=None,
                 targets_fn: Optional[Callable[[], List[dict]]] = None,
                 interval_s: Optional[float] = None,
                 stale_after_s: float = DEFAULT_STALE_AFTER_S,
                 burn_windows=None,
                 slo_target: float = DEFAULT_SLO_TARGET,
                 slo_p99_s: float = DEFAULT_SLO_P99_S,
                 timeout_s: float = 1.0,
                 fetch_fn: Optional[Callable[[str, float], str]] = None,
                 tracker: Optional[PropagationTracker] = None):
        if scheduler is None and targets_fn is None:
            raise ValueError("need a scheduler or a targets_fn")
        self.scheduler = scheduler
        self._targets_fn = targets_fn
        if interval_s is None:
            from geomx_tpu_torch.config import _env
            interval_s = _env(("GEOMX_FLEETSCOPE_INTERVAL_S",),
                              DEFAULT_INTERVAL_S, float)
        self.interval_s = max(0.05, float(interval_s))
        if stale_after_s <= 0:
            raise ValueError(
                f"stale_after_s must be > 0 (got {stale_after_s!r})")
        self.stale_after_s = float(stale_after_s)
        if burn_windows is None:
            from geomx_tpu_torch.config import _env
            burn_windows = _env(("GEOMX_FLEETSCOPE_BURN_WINDOWS",),
                                DEFAULT_BURN_WINDOWS, str)
        self.burn = BurnRateMonitor(windows=burn_windows,
                                    slo_target=slo_target)
        self.slo_p99_s = float(slo_p99_s)
        self.timeout_s = float(timeout_s)
        self._fetch = fetch_fn or _default_fetch
        self.tracker = tracker or get_propagation_tracker()
        self._lock = threading.Lock()
        self._doc: Optional[dict] = None
        self._fleet_version = 0
        # per-node poll state: last successful poll instant + last
        # successful bodies + last failure reason
        self._node_state: Dict[str, dict] = {}
        self._health: Dict[str, str] = {}
        self._request_counts: Dict[str, Dict[str, float]] = {}
        self.transitions: List[dict] = []
        self.polls_total = 0
        self.poll_errors_total = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- discovery ---------------------------------------------------------

    def targets(self) -> List[dict]:
        if self._targets_fn is not None:
            return list(self._targets_fn())
        sched = self.scheduler
        with sched._lock:
            roster = {r: list(v) for r, v in sched._roster.items()}
        dead = [] if sched.in_restart_grace() \
            else sched.heartbeats.dead_nodes()
        nodes = roster_targets(roster, dead_ids=dead)
        if sched.metrics_port:
            nodes.insert(0, {"name": "scheduler", "kind": "scheduler",
                             "id": -1, "host": "127.0.0.1",
                             "port": sched.metrics_port,
                             "http_port": sched.metrics_port,
                             "dead": False})
        return nodes

    # ---- one poll sweep ----------------------------------------------------

    def _poll_node(self, node: dict) -> Tuple[Optional[dict], Optional[str]]:
        """Fetch one node's three surfaces.  Returns (bodies, error):
        any torn body — an exposition the strict parser rejects, a
        /healthz that is not JSON, a timeout — yields a named error and
        NO partial bodies (a half-believed node would poison rollups)."""
        base = f"http://{node['host']}:{node['http_port']}"
        try:
            metrics = self._fetch(f"{base}/metrics", self.timeout_s)
            from geomx_tpu_torch.telemetry.export import parse_prometheus_text
            families = parse_prometheus_text(metrics)
        except Exception as e:
            return None, f"metrics: {type(e).__name__}"
        try:
            healthz = json.loads(
                self._fetch(f"{base}/healthz", self.timeout_s))
        except Exception as e:
            return None, f"healthz: {type(e).__name__}"
        try:
            ledger = json.loads(
                self._fetch(f"{base}/ledger?summary=1", self.timeout_s))
        except Exception as e:
            return None, f"ledger: {type(e).__name__}"
        return {"families": families, "healthz": healthz,
                "ledger": ledger}, None

    @staticmethod
    def _counter_sum(families: dict, name: str,
                     label: Optional[str] = None,
                     value: Optional[str] = None) -> float:
        fam = families.get(name)
        if not fam:
            return 0.0
        total = 0.0
        for sname, labels, v in fam["samples"]:
            if sname != name:
                continue
            if label is not None and labels.get(label) != value:
                continue
            total += float(v)
        return total

    def poll_once(self, now: Optional[float] = None) -> dict:
        """One sweep + fold: poll every discoverable node, fold health
        and rollups, tick the burn monitor, version the document.
        ``now`` is injectable (virtual time in tests and replays) and is the
        only clock the fold reads."""
        now = time.time() if now is None else float(now)
        nodes = self.targets()
        entries: Dict[str, dict] = {}
        tick_good = tick_bad = 0.0
        rollup: Dict[str, Any] = {
            "qps": 0.0, "shed_rate": 0.0, "request_p50_s": 0.0,
            "request_p99_s": 0.0, "honesty_ratio_max": 0.0,
            "replica_staleness_max_s": 0.0, "propagation_p50_s": 0.0,
            "propagation_p99_s": 0.0}
        shed_num = shed_den = 0.0
        for node in nodes:
            name = node["name"]
            st = self._node_state.setdefault(
                name, {"last_ok": None, "bodies": None, "error": None})
            bodies = error = None
            if node.get("http_port") and not node.get("dead"):
                self.polls_total += 1
                bodies, error = self._poll_node(node)
                if bodies is not None:
                    st["last_ok"] = now
                    st["bodies"] = bodies
                    st["error"] = None
                else:
                    self.poll_errors_total += 1
                    st["error"] = error
            # ---- health: dead > stale > ok, reason always named -----
            if node.get("dead"):
                health, reason = "dead", "heartbeat_timeout"
                confidence = 0.0
            elif node.get("http_port") is None:
                # heartbeat-covered only: alive by the dead list
                health, reason, confidence = "ok", None, 1.0
            elif st["last_ok"] is None:
                health, reason = "stale", st["error"] or "never_polled"
                confidence = 0.0
            else:
                age = max(0.0, now - st["last_ok"])
                confidence = 2.0 ** (-age / self.stale_after_s)
                if confidence < 0.5:
                    health = "stale"
                    reason = st["error"] or "poll_age"
                else:
                    health, reason = "ok", None
            entry: Dict[str, Any] = {
                "kind": node["kind"], "id": node["id"],
                "host": node["host"], "port": node["port"],
                "http_port": node.get("http_port"),
                "health": health, "confidence": round(confidence, 4)}
            if reason is not None:
                entry["reason"] = reason
            if st["last_ok"] is not None:
                entry["age_s"] = round(max(0.0, now - st["last_ok"]), 3)
            # ---- fold the node's last-known surfaces ----------------
            known = st["bodies"]
            if known is not None:
                entry["healthz"] = known["healthz"]
                fams = known["families"]
                req = (known["ledger"].get("requests") or {}) \
                    .get("summary") or {}
                if isinstance(req.get("qps"), (int, float)) \
                        and health == "ok":
                    rollup["qps"] += float(req["qps"])
                for pk, rk in (("total_p50_s", "request_p50_s"),
                               ("total_p99_s", "request_p99_s")):
                    v = req.get(pk)
                    if isinstance(v, (int, float)):
                        rollup[rk] = max(rollup[rk], float(v))
                        entry[rk] = float(v)
                ok_n = self._counter_sum(
                    fams, "geomx_serve_requests_total", "status", "ok")
                bad_n = sum(self._counter_sum(
                    fams, "geomx_serve_requests_total", "status", s)
                    for s in ("shed", "error", "timeout"))
                shed_num += bad_n
                shed_den += ok_n + bad_n
                entry["requests"] = {"ok": ok_n, "bad": bad_n}
                honesty = self._counter_sum(
                    fams, "geomx_wire_honesty_ratio")
                rollup["honesty_ratio_max"] = max(
                    rollup["honesty_ratio_max"], honesty)
                serving = (known["healthz"] or {}).get("serving") or {}
                for prov in serving.values():
                    rep = prov.get("replica") if isinstance(prov, dict) \
                        else None
                    if isinstance(rep, dict) and isinstance(
                            rep.get("staleness_s"), (int, float)):
                        rollup["replica_staleness_max_s"] = max(
                            rollup["replica_staleness_max_s"],
                            float(rep["staleness_s"]))
                # burn inputs: this tick's request DELTAS per node; a
                # node whose p99 exceeds the latency SLO burns its ok
                # traffic too (slow is as bad as refused)
                if health == "ok":
                    prev = self._request_counts.get(name,
                                                    {"ok": 0.0,
                                                     "bad": 0.0})
                    d_ok = max(0.0, ok_n - prev["ok"])
                    d_bad = max(0.0, bad_n - prev["bad"])
                    p99 = req.get("total_p99_s")
                    if isinstance(p99, (int, float)) \
                            and float(p99) > self.slo_p99_s:
                        d_bad += d_ok
                        d_ok = 0.0
                    tick_good += d_ok
                    tick_bad += d_bad
                    self._request_counts[name] = {"ok": ok_n,
                                                  "bad": bad_n}
                # training-plane rounds: fold merge instants into the
                # propagation join when the node ships records
                recs = known["ledger"].get("records")
                if recs:
                    self.tracker.ingest_round_records(recs)
            entries[name] = entry
            # ---- health transitions, by name ------------------------
            prev_health = self._health.get(name)
            if prev_health is not None and prev_health != health:
                self.transitions.append(
                    {"node": name, "from": prev_health, "to": health,
                     "t": now, "reason": reason})
                del self.transitions[:-DEFAULT_TRANSITIONS]
            self._health[name] = health
        rollup["shed_rate"] = (shed_num / shed_den) if shed_den else 0.0
        prop = self.tracker.summary()
        rollup["propagation_p50_s"] = prop["p50_s"]
        rollup["propagation_p99_s"] = prop["p99_s"]
        counts = {"ok": 0, "stale": 0, "dead": 0}
        for e in entries.values():
            counts[e["health"]] += 1
        # ---- burn tick ------------------------------------------------
        self.burn.record(now, tick_good, tick_bad)
        breach = self.burn.evaluate(now)
        rollup["burn_rate_max"] = self.burn.max_burn(now)
        rollup["nodes_ok"] = counts["ok"]
        rollup["nodes_stale"] = counts["stale"]
        rollup["nodes_dead"] = counts["dead"]
        with self._lock:
            self._fleet_version += 1
            doc = {"kind": "geomx_fleet_document", "version": 1,
                   "fleet_version": self._fleet_version,
                   "now_unix": now,
                   "interval_s": self.interval_s,
                   "nodes": entries,
                   "rollups": rollup,
                   "burn": {
                       "windows": [{"window_s": w, "threshold": t}
                                   for w, t in self.burn.windows],
                       "slo_target": self.burn.slo_target,
                       "breached": self.burn._breached,
                       "breaches": [dict(b) for b in
                                    self.burn.breaches[-32:]]},
                   "propagation": prop,
                   "transitions": [dict(t) for t in
                                   self.transitions[-32:]]}
            if breach is not None:
                doc["breach"] = dict(breach)
            self._doc = doc
        self._publish_rollups(rollup)
        return doc

    def _publish_rollups(self, rollup: Dict[str, Any]) -> None:
        """The ControlSensors feed: every scalar rollup lands in the
        ``geomx_fleet_rollup{field}`` gauge family (first-label-keyed,
        the shape ``sensors._gauge_values`` reads)."""
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            fam = get_registry().gauge(
                "geomx_fleet_rollup",
                "FleetScope fleet-wide rollups, keyed by field",
                ("field",))
            for field, value in rollup.items():
                if isinstance(value, (int, float)):
                    fam.labels(field=field).set(float(value))
        except Exception:
            pass

    # ---- read side ---------------------------------------------------------

    def document(self) -> Optional[dict]:
        """The latest versioned fleet document (None before the first
        fold)."""
        with self._lock:
            return self._doc

    def document_route(self) -> Tuple[bytes, str]:
        """``GET /fleet`` body for the shared HTTP exporter."""
        doc = self.document()
        if doc is None:
            doc = {"kind": "geomx_fleet_document", "version": 1,
                   "fleet_version": 0, "nodes": {}}
        from geomx_tpu_torch.telemetry.export import _json_default
        return (json.dumps(doc, default=_json_default).encode("utf-8"),
                "application/json")

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetScope":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception:
                    # a broken fold must never kill the aggregator —
                    # the next interval retries from clean state
                    self.poll_errors_total += 1
        self._thread = threading.Thread(target=run, name="fleetscope",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def fleetscope_from_config(scheduler) -> Optional[FleetScope]:
    """Construct (not start) a FleetScope from the environment knobs —
    ``GEOMX_FLEETSCOPE=1`` arms it; interval and burn windows come from
    ``GEOMX_FLEETSCOPE_INTERVAL_S`` / ``GEOMX_FLEETSCOPE_BURN_WINDOWS``.
    None when disabled (the default: zero threads, zero polls, and the
    training step untouched — the knobs are host-plane only)."""
    from geomx_tpu_torch.config import GeoConfig
    cfg = GeoConfig.from_env()
    if not cfg.fleetscope:
        return None
    return FleetScope(scheduler=scheduler,
                      interval_s=cfg.fleetscope_interval_s,
                      burn_windows=cfg.fleetscope_burn_windows)
