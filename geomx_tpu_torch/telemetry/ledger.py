"""Fleet round ledger: causal per-round tracing + byte-true wire accounting
(port of geomx_tpu/telemetry/ledger.py).

The host plane is a durable, key-range-sharded fleet, but without the
ledger its observability stayed per-process: counters count, spans span,
and nothing reconstructs what actually happened to gradient round 7 of
``conv1.weight`` — which parties pushed it (and in how many P3
chunks), which shard merged it, whether a redirect or a corrupted
frame or a session-resume replay touched it on the way, and how many
bytes it REALLY cost on the socket versus what the compressor claimed.

:class:`RoundLedger` is that reconstruction, one record per
``(key, round)``:

- a **hop chain**: every causally-ordered event of the round — client
  push (one hop per frame, so each P3 chunk and each reconnect replay
  is visible), ``wrong_shard`` redirects, session-resume /failover
  replays, chaos-injected corruption, the merge-gate close, the
  durable journal write, the WAN relay, and the pull replies — each
  hop carrying party, shard, wall-clock timestamp, duration and bytes;
- **byte-true wire accounting**: frame bytes are counted at the one
  ``Msg.encode``/``Msg.decode`` choke point every producer and
  consumer shares (``service/protocol.py``), attributed per round and
  direction, and reconciled against the sender-declared payload bytes
  (``meta["wire_declared"]``) into a per-round **honesty ratio** —
  GX-DTYPE-002's wire-honesty guarantee extended from the traced jaxpr
  to the physical wire, now covering P3 framing, the pair codec, the
  CRC prelude and pickled headers that no in-graph audit can see;
- **phase breakdown**: queue / gate-wait / merge / journal / reply
  seconds per round, also observed into the per-shard
  ``geomx_round_phase_seconds{shard,phase}`` histogram;
- bounded memory like every other ring: completed records evict FIFO
  past ``GEOMX_LEDGER_ROUNDS`` (default 256, counted in
  ``geomx_ledger_evictions_total``), and an abandoned open round (a
  failed shard, an evicted sender, a round id that never completed)
  closes as ``status="orphaned"`` instead of leaking.

Read surfaces: :meth:`RoundLedger.records` (dict snapshots — served as
``GET /ledger`` by the scheduler's and GeoPSServer's HTTP exporters),
:meth:`RoundLedger.to_doc` (a ``merge_traces``-compatible Chrome trace
document, so the merged timeline shows the full fleet round),
:meth:`RoundLedger.summary` (the scalars the FlightRecorder's
``stuck_round`` / ``honesty_ratio_drift`` rules and the Pilot's
sensors consume), and the bounded event log (one ``round_ledger``
event per completed/orphaned round).

Everything here is host-plane Python — no jax import, safe in the
jax-free scheduler process.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_ROUNDS = 256

# ---- hop catalog (docs/telemetry.md "Round ledger") ----------------------
PUSH = "push"                 # client: one PUSH frame submitted (P3 chunk
#                               detail in ``detail["chunk"]``)
REDIRECT = "redirect"         # client: a wrong_shard redirect absorbed
REPLAY = "replay"             # client: session-resume re-push after a
#                               server restart (generation changed)
FAILOVER_REPLAY = "failover_replay"   # sharded wrapper: re-push after a
#                               failover re-join (map re-point)
CORRUPT = "corrupt"           # chaos: a bit flip injected into this
#                               round's frame at the sender
MERGE = "merge"               # server: the sync gate closed and the
#                               round's contributions merged
JOURNAL = "journal"           # server: the round's durable journal write
RELAY = "relay"               # server: the WAN relay hop (local->global)
REPLY = "reply"               # server: pull replies for the round

FAULT_HOPS = (REDIRECT, REPLAY, FAILOVER_REPLAY, CORRUPT)

PHASES = ("queue", "gate_wait", "merge", "journal", "reply")

# wire-accounting kinds, from the frame's MsgType at the encode/decode
# choke point
_WIRE_KINDS = {"PUSH": "push", "PULL_REPLY": "reply", "RELAY": "relay"}

# documented clean-link framing bounds: one frame's overhead over its
# declared payload never exceeds these — the reconciliation gate's
# per-frame allowance.  512 B is the LEGACY pickled codec's bound
# (version+CRC prelude, length words, pickled header); the binary v0x02
# codec's exact header-size bound is much tighter (192 B, derived
# field-by-field in service/protocol.py as BIN_FRAME_OVERHEAD_BOUND)
# and :func:`active_frame_overhead_bound` resolves whichever codec is
# encoding.
FRAME_OVERHEAD_BOUND = 512

# clean-round honesty assertion under the binary codec: measured push
# bytes over declared payload bytes must stay within 2% — only asserted
# when the average frame payload clears the floor below (tiny control
# payloads are legitimately header-dominated and say nothing about wire
# honesty)
HONESTY_BOUND = 1.02
HONESTY_MIN_FRAME_PAYLOAD = 4096


def active_frame_overhead_bound() -> int:
    """The per-frame framing allowance for whichever codec
    ``Msg.encode`` is currently producing: the exact binary-frame
    header bound under the default v0x02 codec, the legacy 512 B
    pickled-header allowance under ``GEOMX_NATIVE_WIRE=0``."""
    from geomx_tpu_torch.service.protocol import (BIN_FRAME_OVERHEAD_BOUND,
                                                  binary_wire_enabled)
    return BIN_FRAME_OVERHEAD_BOUND if binary_wire_enabled() \
        else FRAME_OVERHEAD_BOUND


def _ledger_capacity() -> int:
    from geomx_tpu_torch.config import _env
    return max(1, _env(("GEOMX_LEDGER_ROUNDS",), DEFAULT_ROUNDS, int))


class RoundRecord:
    """One (key, round)'s accumulating state.  Mutated only under the
    owning ledger's lock; :meth:`snapshot` returns the plain-dict view
    every read surface serves."""

    __slots__ = ("key", "round", "origin_party", "status", "opened_unix",
                 "closed_unix", "hops", "wire", "declared_tx",
                 "declared_rx", "phases", "detail")

    def __init__(self, key: str, round_id: int):
        self.key = key
        self.round = int(round_id)
        self.origin_party: Optional[int] = None
        self.status = "open"
        self.opened_unix = time.time()
        self.closed_unix: Optional[float] = None
        self.hops: List[dict] = []
        self.wire: "collections.Counter" = collections.Counter()
        self.declared_tx = 0
        self.declared_rx = 0
        self.phases: Dict[str, float] = {}
        self.detail: Dict[str, Any] = {}

    # -- derived -----------------------------------------------------------

    def hop_kinds(self) -> List[str]:
        return [h["hop"] for h in self.hops]

    def fault_hops(self) -> List[dict]:
        return [h for h in self.hops if h["hop"] in FAULT_HOPS]

    def honesty_ratio(self) -> Optional[float]:
        """Measured push-frame bytes over sender-declared payload bytes.
        Prefers the receive side (it sees retransmitted frames the
        encode side only encoded once); falls back to the send side in
        a pure-sender process.  None before any declared push bytes."""
        if self.declared_rx > 0:
            return self.wire.get("push_rx_bytes", 0) / self.declared_rx
        if self.declared_tx > 0:
            return self.wire.get("push_tx_bytes", 0) / self.declared_tx
        return None

    def reconciles(self, per_frame_bound: Optional[int] = None,
                   honesty_bound: Optional[float] = None) -> bool:
        """The byte-true reconciliation gate for a CLEAN round (callers
        filter on :meth:`fault_hops`): measured push bytes cover the
        declared payload exactly once plus at most ``per_frame_bound``
        framing overhead per frame (docs/telemetry.md states the
        bounds; ``None`` resolves the active codec's bound via
        :func:`active_frame_overhead_bound`).  Under the binary codec
        the gate additionally ASSERTS declared ≈ measured — honesty
        ratio ≤ ``honesty_bound`` (default :data:`HONESTY_BOUND`) —
        whenever the average frame payload clears
        :data:`HONESTY_MIN_FRAME_PAYLOAD`; pass an explicit
        ``honesty_bound`` to force or loosen that check."""
        if per_frame_bound is None:
            per_frame_bound = active_frame_overhead_bound()
        if self.declared_rx > 0:
            measured = self.wire.get("push_rx_bytes", 0)
            frames = self.wire.get("push_rx_frames", 0)
            declared = self.declared_rx
        elif self.declared_tx > 0:
            measured = self.wire.get("push_tx_bytes", 0)
            frames = self.wire.get("push_tx_frames", 0)
            declared = self.declared_tx
        else:
            return False
        if not (declared <= measured
                <= declared + per_frame_bound * frames):
            return False
        if honesty_bound is None:
            from geomx_tpu_torch.service.protocol import binary_wire_enabled
            if not binary_wire_enabled():
                return True
            honesty_bound = HONESTY_BOUND
        if frames > 0 and declared >= HONESTY_MIN_FRAME_PAYLOAD * frames:
            return measured <= honesty_bound * declared
        return True

    def snapshot(self) -> dict:
        return {
            "key": self.key, "round": self.round,
            "origin_party": self.origin_party,
            "status": self.status,
            "opened_unix": self.opened_unix,
            "closed_unix": self.closed_unix,
            "hops": [dict(h) for h in self.hops],
            "wire": dict(self.wire),
            "declared_tx_bytes": self.declared_tx,
            "declared_rx_bytes": self.declared_rx,
            "honesty_ratio": self.honesty_ratio(),
            "phases": dict(self.phases),
            "faults": len(self.fault_hops()),
            "detail": dict(self.detail),
        }


class RoundLedger:
    """Fold host-plane hop events into one record per (key, round).

    Thread-safe; every write is a dict hit plus one lock, cheap enough
    to ride the data path.  Completed records keep accepting late
    ``reply`` hops and byte accounting (pulls of a round legitimately
    arrive after its merge) until FIFO eviction."""

    def __init__(self, capacity: Optional[int] = None,
                 open_capacity: Optional[int] = None):
        self.capacity = _ledger_capacity() if capacity is None \
            else max(1, int(capacity))
        # open rounds are bounded too: a client-only process (no server
        # to complete its rounds) must not leak one record per push
        self.open_capacity = self.capacity if open_capacity is None \
            else max(1, int(open_capacity))
        self._lock = threading.Lock()
        self._open: "collections.OrderedDict[Tuple[str, int], RoundRecord]" \
            = collections.OrderedDict()
        self._done: "collections.OrderedDict[Tuple[str, int], RoundRecord]" \
            = collections.OrderedDict()
        self.completed_total = 0
        self.evicted_total = 0
        self.orphaned_total = 0
        self._evictions_published = 0
        # records closed under the lock, awaiting registry/event-log
        # publication OUTSIDE it (see _flush_publish): the ledger lock
        # is contended by every Msg.encode/decode, and a slow event-log
        # disk write must never stall the wire
        self._to_publish: List[RoundRecord] = []

    # ---- write side -------------------------------------------------------

    def _get_locked(self, key: str, round_id: int,
                    create: bool = True) -> Optional[RoundRecord]:
        rk = (str(key), int(round_id))
        rec = self._open.get(rk)
        if rec is None:
            rec = self._done.get(rk)
        if rec is None and create:
            rec = RoundRecord(*rk)
            self._open[rk] = rec
            while len(self._open) > self.open_capacity:
                _, old = self._open.popitem(last=False)
                self._close_locked(old, "orphaned",
                                   reason="open_capacity")
        return rec

    def record_hop(self, key: str, round_id: int, hop: str, *,
                   party: Optional[int] = None,
                   shard: Optional[int] = None,
                   t: Optional[float] = None,
                   dur_s: Optional[float] = None,
                   nbytes: Optional[int] = None,
                   detail: Optional[dict] = None) -> None:
        """Append one hop to the round's causal chain (sequence numbers
        are assigned here, so the chain is gapless by construction and
        ordered by arrival within this process).  ``reply``/``journal``
        hops never OPEN a record: they always follow a merge (or a
        push, client-side) — a straggler reply for a round already
        FIFO-evicted must not resurrect it as a fresh open record that
        nothing will ever complete."""
        if key is None or round_id is None:
            return
        ent: Dict[str, Any] = {"hop": str(hop),
                               "t": time.time() if t is None else float(t)}
        if party is not None:
            ent["party"] = int(party)
        if shard is not None:
            ent["shard"] = int(shard)
        if dur_s is not None:
            ent["dur_s"] = float(dur_s)
        if nbytes is not None:
            ent["nbytes"] = int(nbytes)
        if detail:
            ent["detail"] = dict(detail)
        with self._lock:
            rec = self._get_locked(key, round_id,
                                   create=hop not in (REPLY, JOURNAL))
            if rec is None:
                return
            ent["seq"] = len(rec.hops)
            rec.hops.append(ent)
            if rec.origin_party is None and party is not None \
                    and hop == PUSH:
                rec.origin_party = int(party)
        self._flush_publish()

    def add_phase(self, key: str, round_id: int, phase: str,
                  seconds: float) -> None:
        if key is None or round_id is None:
            return
        with self._lock:
            # phases always follow the merge/relay that opened the
            # record — never resurrect an evicted round
            rec = self._get_locked(key, round_id, create=False)
            if rec is None:
                return
            rec.phases[str(phase)] = \
                rec.phases.get(str(phase), 0.0) + float(seconds)

    def account_frame(self, direction: str, kind: str, key: str,
                      round_id: int, nbytes: int,
                      declared: Optional[int] = None) -> None:
        """One wire frame's bytes, attributed to (key, round).  Called
        from the ``Msg.encode`` (direction ``tx``) / ``Msg.decode``
        (``rx``) choke point — the one place every producer (including
        the pre-encoded priority-queue send paths) and every consumer
        meet, so the count is the frame that actually crossed (or will
        cross) the socket, length prefix included.  Only push frames
        may open a record; reply/relay bytes for an already-evicted
        round are dropped rather than resurrecting it."""
        kind = _WIRE_KINDS.get(kind, "other")
        with self._lock:
            rec = self._get_locked(key, round_id, create=kind == "push")
            if rec is None:
                return
            rec.wire[f"{kind}_{direction}_bytes"] += int(nbytes)
            rec.wire[f"{kind}_{direction}_frames"] += 1
            if declared is not None and kind == "push":
                if direction == "tx":
                    rec.declared_tx += int(declared)
                else:
                    rec.declared_rx += int(declared)
        self._flush_publish()

    # ---- completion / eviction -------------------------------------------

    def _close_locked(self, rec: RoundRecord, status: str,
                      reason: Optional[str] = None) -> None:
        rec.status = status
        rec.closed_unix = time.time()
        if reason:
            rec.detail["close_reason"] = reason
        self._done[(rec.key, rec.round)] = rec
        if status == "orphaned":
            self.orphaned_total += 1
        else:
            self.completed_total += 1
        while len(self._done) > self.capacity:
            self._done.popitem(last=False)
            self.evicted_total += 1
        # publication happens OUTSIDE the lock (_flush_publish): the
        # registry and the event log must never be touched while every
        # Msg.encode/decode in the process is parked on this lock
        self._to_publish.append(rec)

    def _flush_publish(self) -> None:
        """Publish any rounds closed since the last flush, outside the
        ledger lock.  Called at the end of every mutating public
        method; losing a race just means another caller publishes."""
        while True:
            with self._lock:
                if not self._to_publish:
                    return
                recs, self._to_publish = self._to_publish, []
                # the eviction delta is claimed under the lock so two
                # racing flushes can never double-publish it
                ev_delta = self.evicted_total - self._evictions_published
                self._evictions_published = self.evicted_total
            if ev_delta > 0:
                try:
                    from geomx_tpu_torch.telemetry.registry import get_registry
                    get_registry().counter(
                        "geomx_ledger_evictions_total",
                        "Completed ledger records evicted FIFO past "
                        "GEOMX_LEDGER_ROUNDS").inc(ev_delta)
                except Exception:
                    pass
            for rec in recs:
                self._publish_close(rec)

    def _publish_close(self, rec: RoundRecord) -> None:
        """Registry + event-log fan-out for one closed round.  Resolved
        per call (like service/retry.count_retry) so test-time registry
        resets never orphan a cached child; best-effort by design.
        Runs WITHOUT the ledger lock."""
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            reg = get_registry()
            reg.counter(
                "geomx_ledger_rounds_total",
                "Ledger rounds closed", ("status",)).labels(
                status=rec.status).inc()
            reg.gauge(
                "geomx_ledger_open_rounds",
                "Ledger rounds currently open").set(len(self._open))
            ratio = rec.honesty_ratio()
            if ratio is not None:
                reg.gauge(
                    "geomx_wire_honesty_ratio",
                    "Latest per-round measured-vs-declared push byte "
                    "ratio").set(ratio)
            shard = next((h["shard"] for h in rec.hops
                          if h["hop"] == MERGE and "shard" in h), None)
            if rec.phases:
                fam = reg.histogram(
                    "geomx_round_phase_seconds",
                    "Per-round phase durations across the host plane",
                    ("shard", "phase"))
                for phase, secs in rec.phases.items():
                    fam.labels(shard=str(shard if shard is not None
                                         else -1),
                               phase=phase).observe(secs)
        except Exception:
            pass
        try:
            from geomx_tpu_torch.telemetry.export import log_event
            log_event("round_ledger", key=rec.key, round=rec.round,
                      status=rec.status, hops=rec.hop_kinds(),
                      origin_party=rec.origin_party,
                      honesty_ratio=rec.honesty_ratio(),
                      wire=dict(rec.wire), phases=dict(rec.phases))
        except Exception:
            pass

    def complete(self, key: str, round_id: int) -> None:
        """The round's server-side lifecycle finished (merge + journal
        + first reply batch): move it to the completed ring.  Late
        reply hops / byte accounting still append (pulls of a round
        arrive after its merge) until eviction."""
        with self._lock:
            rec = self._open.pop((str(key), int(round_id)), None)
            if rec is not None:
                self._close_locked(rec, "complete")
        self._flush_publish()

    def complete_through(self, key: str, round_id: int) -> int:
        """Close every open round of ``key`` with round <= ``round_id``
        as complete — the CLIENT-side completion path: a pull reply's
        ``pushed`` proof says the server journaled those rounds, which
        is all a worker process (whose ledger never sees the server's
        merge) can ever learn.  Returns the number closed."""
        closed = 0
        with self._lock:
            victims = [rk for rk in self._open
                       if rk[0] == str(key) and rk[1] <= int(round_id)]
            for rk in victims:
                self._close_locked(self._open.pop(rk), "complete")
                closed += 1
        self._flush_publish()
        return closed

    def orphan(self, key: Optional[str] = None,
               round_id: Optional[int] = None,
               reason: str = "") -> int:
        """Close open rounds as ``status="orphaned"`` — a failed shard,
        a migrated key, an evicted sender whose rounds can never
        complete.  ``key=None`` matches every key; ``round_id=None``
        every round of the key.  Returns the number closed."""
        with self._lock:
            victims = [rk for rk in self._open
                       if (key is None or rk[0] == str(key))
                       and (round_id is None or rk[1] == int(round_id))]
            for rk in victims:
                self._close_locked(self._open.pop(rk), "orphaned",
                                   reason=reason or None)
        self._flush_publish()
        return len(victims)

    # ---- read side --------------------------------------------------------

    def get(self, key: str, round_id: int) -> Optional[dict]:
        with self._lock:
            rec = self._get_locked(key, round_id, create=False)
            return None if rec is None else rec.snapshot()

    def records(self, status: Optional[str] = None) -> List[dict]:
        """Snapshot every retained record, oldest first (open rounds
        last); optionally filtered by status."""
        with self._lock:
            out = [r.snapshot() for r in self._done.values()]
            out.extend(r.snapshot() for r in self._open.values())
        if status is not None:
            out = [r for r in out if r["status"] == status]
        return out

    def summary(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The scalars the FlightRecorder's ledger rules and the
        Pilot's sensors consume.  Deterministic for a given ``now``."""
        now = time.time() if now is None else float(now)
        with self._lock:
            oldest = None
            for rec in self._open.values():
                if oldest is None or rec.opened_unix < oldest.opened_unix:
                    oldest = rec
            ratios = [r for r in
                      (rec.honesty_ratio()
                       for rec in self._done.values()) if r is not None]
            out: Dict[str, Any] = {
                "ledger_open_rounds": len(self._open),
                "ledger_completed_total": self.completed_total,
                "ledger_orphaned_total": self.orphaned_total,
                "ledger_evicted_total": self.evicted_total,
                "ledger_open_round_age_s":
                    max(0.0, now - oldest.opened_unix)
                    if oldest is not None else 0.0,
            }
            if oldest is not None:
                out["ledger_oldest_open"] = (oldest.key, oldest.round)
            if ratios:
                out["wire_honesty_ratio"] = ratios[-1]
                out["wire_honesty_ratio_mean"] = sum(ratios) / len(ratios)
            return out

    def to_doc(self, label: Optional[str] = None) -> dict:
        """The ledger as a ``merge_traces``-compatible Chrome trace
        document: one complete "X" span per round (first hop -> close)
        plus one instant per hop, all carrying ``args.round_id`` /
        ``args.key`` — merged with the per-process profiler dumps, the
        Chrome timeline shows the full fleet round, hop by hop."""
        events: List[dict] = []
        recs = self.records()   # ONE snapshot for anchor + events
        anchor_us: Optional[float] = None
        for rec in recs:
            hops = rec["hops"]
            t0 = hops[0]["t"] if hops else rec["opened_unix"]
            if anchor_us is None or t0 * 1e6 < anchor_us:
                anchor_us = t0 * 1e6
        anchor_us = anchor_us if anchor_us is not None else 0.0
        for rec in recs:
            hops = rec["hops"]
            t0 = hops[0]["t"] if hops else rec["opened_unix"]
            t1 = rec["closed_unix"] or (hops[-1]["t"] if hops else t0)
            args = {"key": rec["key"], "round_id": rec["round"],
                    "status": rec["status"]}
            events.append({
                "name": f"LedgerRound:{rec['key']}", "cat": "ledger",
                "ph": "X", "pid": 0, "tid": 0,
                "ts": t0 * 1e6 - anchor_us,
                "dur": max(0.0, (t1 - t0) * 1e6), "args": args})
            for h in hops:
                events.append({
                    "name": f"LedgerHop:{h['hop']}", "cat": "ledger",
                    "ph": "i", "s": "t", "pid": 0,
                    "tid": h.get("party", 0),
                    "ts": h["t"] * 1e6 - anchor_us,
                    "args": {**args, "hop": h["hop"],
                             "seq": h["seq"],
                             "shard": h.get("shard")}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"anchor_unix_us": anchor_us,
                             "ledger": True,
                             "label": label or "ledger"}}


# ---- process-global ledger (host plane writes, observatory reads) --------

_ledger: Optional[RoundLedger] = None
_ledger_lock = threading.Lock()


def get_round_ledger() -> RoundLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = RoundLedger()
        return _ledger


def reset_round_ledger(capacity: Optional[int] = None) -> RoundLedger:
    """Fresh global ledger (test isolation / bench runs)."""
    global _ledger
    with _ledger_lock:
        _ledger = RoundLedger(capacity=capacity)
        return _ledger


def account_frame(direction: str, kind: str, key: str, round_id: int,
                  nbytes: int, declared: Optional[int] = None) -> None:
    """Module-level forwarder the wire protocol calls (lazy, so the
    protocol module never imports telemetry at module scope and a
    test-time :func:`reset_round_ledger` takes effect immediately)."""
    get_round_ledger().account_frame(direction, kind, key, round_id,
                                     nbytes, declared=declared)


def record_hop(key: str, round_id: int, hop: str, **kw) -> None:
    """Module-level forwarder for hop producers (client/server/sharded
    call sites); same lazy-singleton contract as :func:`account_frame`."""
    get_round_ledger().record_hop(key, round_id, hop, **kw)


def add_phase(key: str, round_id: int, phase: str, seconds: float) -> None:
    get_round_ledger().add_phase(key, round_id, phase, seconds)


def complete_round(key: str, round_id: int) -> None:
    get_round_ledger().complete(key, round_id)


# ---------------------------------------------------------------------------
# per-request serving ledger (docs/serving.md): the RoundLedger traces
# gradient rounds; this traces inference requests through the gateway's
# causal chain — enqueue -> batch -> forward -> reply — with the same
# bounded-ring discipline, and summarizes p50/p99 per phase for the
# ``GET /ledger`` surface and the SLO policy's observation stream.
# ---------------------------------------------------------------------------

REQUEST_PHASES = ("queue", "forward", "reply")
DEFAULT_REQUESTS = 2048


def _request_capacity() -> int:
    from geomx_tpu_torch.config import _env
    return max(1, _env(("GEOMX_LEDGER_REQUESTS",), DEFAULT_REQUESTS, int))


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[rank]


class RequestLedger:
    """Bounded FIFO ring of completed inference requests.

    One record per request: the wall-clock enqueue instant, the three
    phase durations (queue = enqueue->batch, forward = the jit'd batch
    dispatch this request rode, reply = result fan-out), the dispatched
    batch size and padded bucket, and the terminal status (``ok`` /
    ``shed`` / ``error``).  Writes are a deque append under one lock —
    cheap enough for the request path; reads snapshot."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = _request_capacity() if capacity is None \
            else max(1, int(capacity))
        self._lock = threading.Lock()
        self._records: "collections.deque" = \
            collections.deque(maxlen=self.capacity)
        self.observed_total = 0
        # byte-true wire accounting per transport lane ("native" /
        # "http"): actual on-wire bytes (frame length prefixes
        # included) vs the sender-declared payload bytes — the same
        # honesty discipline the RoundLedger applies to gradient
        # frames, here for inference traffic (docs/serving.md
        # "Serving fast path").
        self._wire: Dict[str, Dict[str, int]] = {}

    def observe(self, rid: int, *, t_enqueue: float, queue_s: float,
                forward_s: float, reply_s: float, batch_size: int,
                bucket: int, status: str = "ok",
                transport: Optional[str] = None,
                model_version: Optional[str] = None,
                model_round: Optional[int] = None,
                staleness_s: Optional[float] = None) -> None:
        rec = {"rid": int(rid), "t_enqueue": float(t_enqueue),
               "queue_s": float(queue_s), "forward_s": float(forward_s),
               "reply_s": float(reply_s),
               "total_s": float(queue_s) + float(forward_s)
               + float(reply_s),
               "batch_size": int(batch_size), "bucket": int(bucket),
               "status": str(status)}
        if transport is not None:
            rec["transport"] = str(transport)
        # freshness provenance (gateway dispatch stamps these from the
        # weight set the batch actually ran on); optional so non-serving
        # observers and old call sites stay untouched
        if model_version is not None:
            rec["model_version"] = str(model_version)
        if model_round is not None:
            rec["model_round"] = int(model_round)
        if staleness_s is not None:
            rec["staleness_s"] = float(staleness_s)
        with self._lock:
            self._records.append(rec)
            self.observed_total += 1

    def account_wire(self, transport: str, direction: str, nbytes: int,
                     declared: Optional[int] = None) -> None:
        """One inference frame's on-wire bytes (``direction`` is
        ``"rx"`` or ``"tx"``).  ``declared`` is what the sender claimed
        for the payload; actual/declared is the honesty ratio
        `summary()` reports — PER DIRECTION, because the two directions
        have structurally different payload sizes (a feature batch in,
        a logits row out): the ≤ 1.02 acceptance bound applies to the
        payload-dominant request direction, where frame overhead
        amortizes over real payload bytes, while a tiny reply payload
        under a fixed frame header is reported, not gated (no wire
        format can frame 80 bytes inside 2% overhead)."""
        with self._lock:
            lane = self._wire.setdefault(str(transport), {
                "rx_bytes": 0, "tx_bytes": 0, "frames": 0,
                "rx_declared": 0, "rx_declared_actual": 0,
                "tx_declared": 0, "tx_declared_actual": 0})
            lane[f"{direction}_bytes"] = \
                lane.get(f"{direction}_bytes", 0) + int(nbytes)
            lane["frames"] += 1
            if declared is not None and int(declared) > 0:
                lane[f"{direction}_declared"] = \
                    lane.get(f"{direction}_declared", 0) + int(declared)
                lane[f"{direction}_declared_actual"] = \
                    lane.get(f"{direction}_declared_actual", 0) \
                    + int(nbytes)

    def records(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._records]

    def summary(self) -> Dict[str, Any]:
        """p50/p99 per phase + end-to-end, status counts, and the
        retained window's sustained QPS (completed ``ok`` requests over
        the window's enqueue span)."""
        with self._lock:
            recs = list(self._records)
            total = self.observed_total
            wire = {t: dict(lane) for t, lane in self._wire.items()}
        out: Dict[str, Any] = {"requests": len(recs),
                               "observed_total": total}
        by_status: Dict[str, int] = {}
        by_transport: Dict[str, int] = {}
        for r in recs:
            by_status[r["status"]] = by_status.get(r["status"], 0) + 1
            t = r.get("transport")
            if t is not None:
                by_transport[t] = by_transport.get(t, 0) + 1
        out["by_status"] = by_status
        if by_transport:
            out["by_transport"] = by_transport
        if wire:
            for lane in wire.values():
                for d in ("rx", "tx"):
                    decl = lane.get(f"{d}_declared", 0)
                    lane[f"honesty_ratio_{d}"] = (
                        round(lane[f"{d}_declared_actual"] / decl, 4)
                        if decl > 0 else None)
            out["wire"] = wire
        ok = [r for r in recs if r["status"] == "ok"]
        for phase in REQUEST_PHASES + ("total",):
            vals = sorted(r[f"{phase}_s"] for r in ok)
            out[f"{phase}_p50_s"] = _percentile(vals, 0.50)
            out[f"{phase}_p99_s"] = _percentile(vals, 0.99)
        if len(ok) >= 2:
            span = max(r["t_enqueue"] for r in ok) \
                - min(r["t_enqueue"] for r in ok)
            out["qps"] = len(ok) / span if span > 0 else None
        else:
            out["qps"] = None
        if ok:
            out["batch_size_mean"] = \
                sum(r["batch_size"] for r in ok) / len(ok)
            out["batch_size_max"] = max(r["batch_size"] for r in ok)
        # freshness rollup over records carrying provenance — what the
        # gateway's dispatch stamped, so "staleness served" not
        # "staleness now"
        prov = [r for r in ok if "model_round" in r]
        if prov:
            out["freshness"] = {
                "records": len(prov),
                "model_round_min": min(r["model_round"] for r in prov),
                "model_round_max": max(r["model_round"] for r in prov),
                "staleness_max_s": max(
                    (r["staleness_s"] for r in prov
                     if "staleness_s" in r), default=None)}
        return out


_request_ledger: Optional[RequestLedger] = None
_request_ledger_lock = threading.Lock()


def get_request_ledger() -> RequestLedger:
    global _request_ledger
    with _request_ledger_lock:
        if _request_ledger is None:
            _request_ledger = RequestLedger()
        return _request_ledger


def peek_request_ledger() -> Optional[RequestLedger]:
    """The current request ledger WITHOUT creating one — the /ledger
    HTTP route's probe, so a pure-training process never grows a
    serving section."""
    with _request_ledger_lock:
        return _request_ledger


def reset_request_ledger(capacity: Optional[int] = None) -> RequestLedger:
    """Fresh global request ledger (test isolation / bench runs)."""
    global _request_ledger
    with _request_ledger_lock:
        _request_ledger = RequestLedger(capacity=capacity)
        return _request_ledger
