"""WAN link estimation: per-(party, peer) EWMA throughput/RTT/loss (port of
geomx_tpu/telemetry/links.py).

A controller needs *measured* per-link quality before it can retune
compression ratio or re-form relay chains; the tracing plane records
the raw material (every ``RelayToGlobal:<key>`` span IS one party's
DCN round trip, with its payload bytes in the span args) but nothing folds the spans into estimates.  :class:`LinkObservatory`
is that fold — and its :meth:`~LinkObservatory.snapshot` is the stable
sensor interface the controller will consume:

- :meth:`~LinkObservatory.observe` takes one transfer observation
  (bytes, seconds, ok) for a ``party -> peer`` link;
- :meth:`~LinkObservatory.ingest_trace` replays a Chrome trace dump (a
  single profiler dump or a ``merge_traces`` document): WAN relay spans
  become throughput/RTT observations, ``RelayFailure:*`` instants
  become loss observations;
- estimates are EWMAs (the reference TSEngine smooths its measured
  throughput the same way, ``transport/tsengine.py``), and every
  snapshot entry carries an ``age_s`` + exponentially-decayed
  ``confidence`` so a controller can tell a fresh estimate from one
  that predates the last membership change (staleness decay).

Timestamps are explicit (``t=``) or derived from the trace's wall-clock
anchor, never sampled inside the fold — replaying the same rounds twice
produces the same snapshot, which is what makes chaos-schedule replays
usable as the controller's acceptance harness.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Optional, Tuple

_RELAY_PREFIXES = ("RelayToGlobal:", "RelayRowSparse:")
_FAILURE_PREFIX = "RelayFailure:"


class LinkEstimate:
    """EWMA state for one directed link."""

    __slots__ = ("throughput_bps", "rtt_s", "loss_rate", "samples",
                 "failures", "last_t", "bytes_total")

    def __init__(self):
        self.throughput_bps: Optional[float] = None
        self.rtt_s: Optional[float] = None
        self.loss_rate: float = 0.0
        self.samples: int = 0
        self.failures: int = 0
        self.bytes_total: float = 0.0
        self.last_t: Optional[float] = None

    def _ewma(self, old: Optional[float], new: float,
              alpha: float) -> float:
        return new if old is None else alpha * new + (1 - alpha) * old

    def update(self, *, nbytes: float, seconds: Optional[float],
               ok: bool, alpha: float, t: float) -> None:
        self.samples += 1
        self.last_t = t if self.last_t is None else max(self.last_t, t)
        if not ok:
            self.failures += 1
            self.loss_rate = self._ewma(self.loss_rate, 1.0, alpha)
            return
        self.loss_rate = self._ewma(self.loss_rate, 0.0, alpha)
        if seconds is not None and seconds > 0:
            self.rtt_s = self._ewma(self.rtt_s, seconds, alpha)
            if nbytes > 0:
                self.bytes_total += nbytes
                self.throughput_bps = self._ewma(
                    self.throughput_bps, nbytes / seconds, alpha)


def relay_order(records, peer: str = "global",
                min_confidence: float = 0.0) -> list:
    """Widest-uplink-first party order over snapshot records — THE
    relay ordering rule (throughput descending, unmeasured links last,
    ties broken by party name), shared by
    :meth:`LinkObservatory.best_relay_order` and the control plane's
    ``RelayPolicy`` so the published order and the policy's chain can
    never drift.  ``records``: snapshot-record dicts (``party`` /
    ``peer`` / ``throughput_bps`` / ``confidence``)."""
    entries = [r for r in records if r["peer"] == peer
               and r["confidence"] >= min_confidence]
    entries.sort(key=lambda r: (
        -(r["throughput_bps"]
          if r["throughput_bps"] is not None else -math.inf),
        r["party"]))
    return [r["party"] for r in entries]


class LinkObservatory:
    """Fold WAN round observations into per-link quality estimates.

    ``alpha``: EWMA smoothing factor (weight of the newest sample).
    ``stale_after_s``: confidence half-life — a snapshot taken
    ``stale_after_s`` after the last observation reports confidence
    0.5, two half-lives 0.25, ...; ``stale`` flips at < 0.5.
    """

    def __init__(self, alpha: float = 0.3, stale_after_s: float = 30.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1] (got {alpha!r})")
        if stale_after_s <= 0:
            raise ValueError(
                f"stale_after_s must be > 0 (got {stale_after_s!r})")
        self.alpha = float(alpha)
        self.stale_after_s = float(stale_after_s)
        self._lock = threading.Lock()
        self._links: Dict[Tuple[str, str], LinkEstimate] = {}
        self._tap = None

    def set_tap(self, fn) -> None:
        """Install (or clear, with None) an observation tap: ``fn``
        receives every :meth:`observe` call as one plain dict
        ``{party, peer, nbytes, seconds, ok, t}`` with the RESOLVED
        timestamp.  The run-capsule recorder
        (:mod:`geomx_tpu_torch.telemetry.capsule`) uses this as its link
        journal; replaying the journal through a fresh observatory in
        order reproduces the EWMA state bit-identically.  The tap is
        called under the observatory lock so journal order always
        equals fold order — it must be cheap and non-blocking (a list
        append)."""
        with self._lock:
            self._tap = fn

    # ---- write side --------------------------------------------------------

    def observe(self, party: str, peer: str = "global", *,
                nbytes: float = 0.0, seconds: Optional[float] = None,
                ok: bool = True, t: Optional[float] = None) -> None:
        """One transfer observation on the ``party -> peer`` link:
        ``nbytes`` moved in ``seconds`` (the span duration — RTT plus
        transfer, which is what the relay actually waits), ``ok=False``
        for a failed round (loss).  ``t`` is the observation's wall
        clock; pass it when replaying recorded rounds so the staleness
        clock is the replay's, not the fold's."""
        t = time.time() if t is None else float(t)
        key = (str(party), str(peer))
        with self._lock:
            if self._tap is not None:
                self._tap({
                    "party": key[0], "peer": key[1],
                    "nbytes": float(nbytes),
                    "seconds": None if seconds is None else float(seconds),
                    "ok": bool(ok), "t": t})
            est = self._links.get(key)
            if est is None:
                est = self._links[key] = LinkEstimate()
            est.update(nbytes=float(nbytes), seconds=seconds, ok=bool(ok),
                       alpha=self.alpha, t=t)

    def ingest_trace(self, doc: dict,
                     party: Optional[str] = None,
                     peer: str = "global") -> int:
        """Replay a Chrome trace document's WAN rounds into the
        estimators; returns the number of observations folded.

        Works on a single profiler dump (party from ``metadata.rank`` or
        the ``party`` argument) and on a ``merge_traces`` document
        (party from each pid's ``process_name`` row).  Spans named
        ``RelayToGlobal:*`` / ``RelayRowSparse:*`` contribute
        throughput+RTT (payload bytes from the span args); instants
        named ``RelayFailure:*`` contribute loss."""
        from geomx_tpu_torch.telemetry.tracing import process_names
        names = process_names(doc)
        meta = doc.get("metadata") or {}
        anchor_us = meta.get("anchor_unix_us")
        rank = meta.get("rank")
        default_party = party if party is not None else (
            f"rank{rank}" if rank is not None else "party0")

        folded = 0
        for ev in doc.get("traceEvents", []):
            name = ev.get("name", "")
            who = names.get(ev.get("pid"), default_party) \
                if names else default_party
            t = None
            if anchor_us is not None and "ts" in ev:
                t = (float(anchor_us) + float(ev["ts"])) / 1e6
            if ev.get("ph") == "X" and name.startswith(_RELAY_PREFIXES):
                args = ev.get("args") or {}
                self.observe(
                    who, peer,
                    nbytes=float(args.get("payload_bytes")
                                 or args.get("bytes") or 0.0),
                    seconds=float(ev.get("dur", 0.0)) / 1e6,
                    ok=True, t=t)
                folded += 1
            elif ev.get("ph") == "i" and name.startswith(_FAILURE_PREFIX):
                self.observe(who, peer, ok=False, t=t)
                folded += 1
        return folded

    def ingest_ledger(self, records, peer: str = "global") -> int:
        """Fold fleet-round-ledger records (``RoundLedger.records()``
        dicts, telemetry/ledger.py) into the link estimators — the
        on-wire-truth sensor path: unlike trace spans, ledger bytes
        are measured at the wire choke point, so the Pilot's
        throughput estimates see framing/retry overhead too.

        Per record: every ``relay`` hop is one throughput+RTT
        observation on its party's uplink; records WITHOUT a relay hop
        (a flat worker->shard fleet) contribute one observation per
        pushing party — that party's measured push bytes over the
        push->merge interval, which is what the round actually waited.
        Orphaned records count as one loss observation.  Timestamps
        come from the hops, never the fold — same records, same
        snapshot."""
        folded = 0
        for rec in records:
            hops = rec.get("hops") or []
            relays = [h for h in hops if h["hop"] == "relay"]
            orphaned = rec.get("status") == "orphaned"
            for h in relays:
                p = h.get("party")
                if p is None:
                    p = rec.get("origin_party") or 0
                self.observe(f"party{p}", peer,
                             nbytes=float(h.get("nbytes") or 0.0),
                             seconds=h.get("dur_s"), ok=not orphaned,
                             t=h.get("t"))
                folded += 1
            if relays:
                continue
            merge = next((h for h in hops if h["hop"] == "merge"), None)
            pushes: Dict[int, list] = {}
            for h in hops:
                if h["hop"] == "push" and h.get("party") is not None:
                    pushes.setdefault(int(h["party"]), []).append(h)
            for party, phops in sorted(pushes.items()):
                nbytes = float(sum(h.get("nbytes") or 0 for h in phops))
                t0 = min(h["t"] for h in phops)
                seconds = None
                if merge is not None and merge["t"] > t0:
                    seconds = merge["t"] - t0
                self.observe(f"party{party}", peer, nbytes=nbytes,
                             seconds=seconds, ok=not orphaned,
                             t=merge["t"] if merge is not None else t0)
                folded += 1
            if not pushes and orphaned:
                self.observe(f"party{rec.get('origin_party') or 0}",
                             peer, ok=False,
                             t=rec.get("closed_unix"))
                folded += 1
        return folded

    # ---- read side (the controller's sensor interface) ---------------------

    def snapshot(self, now: Optional[float] = None,
                 min_confidence: Optional[float] = None) -> Dict[str, dict]:
        """The current estimate per link, keyed ``"<party>-><peer>"``:
        ``throughput_bps`` / ``rtt_s`` / ``loss_rate`` EWMAs, sample and
        failure counts, and the staleness pair (``age_s``,
        ``confidence`` = 2^(-age/half-life), ``stale`` below 0.5).
        Deterministic for a given ``now``.

        ``min_confidence`` filters out links whose staleness-decayed
        confidence has fallen below the threshold — the one staleness
        gate every policy consumer shares instead of re-implementing
        (docs/control.md)."""
        now = time.time() if now is None else float(now)
        out: Dict[str, dict] = {}
        with self._lock:
            for (party, peer), est in sorted(self._links.items()):
                age = max(now - est.last_t, 0.0) \
                    if est.last_t is not None else math.inf
                conf = 2.0 ** (-age / self.stale_after_s) \
                    if math.isfinite(age) else 0.0
                if min_confidence is not None and conf < min_confidence:
                    continue
                out[f"{party}->{peer}"] = {
                    "party": party, "peer": peer,
                    "throughput_bps": est.throughput_bps,
                    "rtt_s": est.rtt_s,
                    "loss_rate": est.loss_rate,
                    "samples": est.samples,
                    "failures": est.failures,
                    "bytes_total": est.bytes_total,
                    "age_s": age,
                    "confidence": conf,
                    "stale": conf < 0.5,
                }
        return out

    def best_relay_order(self, peer: str = "global",
                         now: Optional[float] = None,
                         min_confidence: float = 0.0) -> list:
        """Parties ordered widest-uplink-first toward ``peer`` — the
        greedy widest-path relay chain the paper's TSEngine forms
        (ProcessAsk1Command pairs the lower-throughput node to send
        through the higher-throughput one; the widest link sits next to
        the sink).  Deterministic: throughput descending, unmeasured
        links last, ties broken by party name (:func:`relay_order` —
        the one ordering rule the control plane's RelayPolicy shares).
        Links below ``min_confidence`` are excluded up front (same
        staleness gate as :meth:`snapshot`)."""
        snap = self.snapshot(now=now, min_confidence=min_confidence or None)
        return relay_order(snap.values(), peer=peer)

    def publish(self, registry=None, now: Optional[float] = None) -> None:
        """Export the snapshot as registry gauges
        (``geomx_link_*{party,peer}``) for the scheduler's ``/metrics``
        surface."""
        from geomx_tpu_torch.telemetry.registry import get_registry
        reg = registry if registry is not None else get_registry()
        labels = ("party", "peer")
        fams = {
            "throughput_bps": reg.gauge(
                "geomx_link_throughput_bps",
                "EWMA WAN link throughput", labels),
            "rtt_s": reg.gauge(
                "geomx_link_rtt_seconds",
                "EWMA WAN relay round-trip time", labels),
            "loss_rate": reg.gauge(
                "geomx_link_loss_rate",
                "EWMA WAN relay failure rate", labels),
            "confidence": reg.gauge(
                "geomx_link_confidence",
                "Staleness-decayed estimate confidence", labels),
        }
        for rec in self.snapshot(now=now).values():
            for field, fam in fams.items():
                val = rec[field]
                if val is not None:
                    fam.labels(party=rec["party"],
                               peer=rec["peer"]).set(float(val))


# process-global observatory: the host plane (GeoPSServer relays) and
# the controller read/write one instance per process
_global: Optional[LinkObservatory] = None
_global_lock = threading.Lock()


def get_link_observatory() -> LinkObservatory:
    global _global
    with _global_lock:
        if _global is None:
            _global = LinkObservatory()
        return _global


def reset_link_observatory() -> LinkObservatory:
    """Fresh global observatory (test isolation)."""
    global _global
    with _global_lock:
        _global = LinkObservatory()
        return _global
