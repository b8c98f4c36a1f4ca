"""Party-liveness control: heartbeats and roster signals -> membership
epochs (port of geomx_tpu/resilience/liveness.py, which imports no jax).

``PartyLivenessController`` folds per-node liveness (the port's
``utils.heartbeat.HeartbeatMonitor``, or the scheduler's cluster-wide
dead list) into a per-party verdict and publishes it as a versioned
:class:`MembershipEpoch`: the live-party mask and its renormalization
weight.  The Trainer binds an epoch with ``apply_membership``, and the
sync algorithms renormalize the dc-tier mean over the survivors.

Every published transition sets the ``geomx_membership_version``,
``geomx_live_parties`` and ``geomx_party_live`` gauges, bumps
``geomx_membership_transitions_total`` in the port's metric registry and
writes a ``membership_epoch`` record to the event log
(``telemetry/export.py``).

Re-admission catch-up: a returning party receives the authoritative
state (params, optimizer, model and sync state) before it rejoins the
collective.  :func:`pack_catchup`/:func:`unpack_catchup` use the port's
checkpoint tree format (``utils/checkpoint.py``), so catch-up and
restore share one format.  A JAX blob pickles flax/optax classes and
does not load here, nor a port blob in the JAX package: the restored
trees agree, not the bytes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class MembershipEpoch:
    """A versioned snapshot of which parties participate in the dc tier.

    ``version`` increases on every mask change (monotone, never reused),
    so consumers can order epochs and detect staleness; ``live_mask[p]``
    is True when party ``p`` contributes to the dc-tier aggregate."""

    version: int
    live_mask: Tuple[bool, ...]

    @property
    def num_parties(self) -> int:
        return len(self.live_mask)

    @property
    def num_live(self) -> int:
        return sum(self.live_mask)

    @property
    def all_live(self) -> bool:
        return all(self.live_mask)

    @property
    def renorm_weight(self) -> float:
        """The survivor-mean divisor's reciprocal: the dc-tier aggregate
        under this epoch is ``psum(g * mask) * renorm_weight``."""
        return 1.0 / self.num_live

    def live_parties(self) -> List[int]:
        return [p for p, ok in enumerate(self.live_mask) if ok]


class PartyLivenessController:
    """Publishes membership epochs from node-level liveness signals.

    A party maps to one or more node ids (its local server, its data
    feeder, ...) via :meth:`bind_party`; the party is declared dead when
    ANY of its bound nodes is dead — a party missing any member cannot
    complete its intra-party round.  Chaos / operator intervention uses
    :meth:`mark_dead` / :meth:`mark_live` directly (no node binding
    needed), which is how the deterministic fault-injection harness
    drives the controller in-process.

    ``min_live`` guards the floor: a transition that would leave fewer
    live parties raises instead of publishing an epoch the run cannot
    execute (an all-dead mesh has no survivor mean to renormalize to).
    """

    def __init__(self, num_parties: int,
                 monitor: Optional[Any] = None,
                 min_live: int = 1,
                 timeout_s: Optional[float] = None):
        if num_parties < 1:
            raise ValueError("num_parties must be >= 1")
        if not 1 <= min_live <= num_parties:
            raise ValueError(f"min_live must be in [1, {num_parties}]")
        self.num_parties = int(num_parties)
        self.monitor = monitor          # utils.heartbeat.HeartbeatMonitor
        self.min_live = int(min_live)
        self.timeout_s = timeout_s
        self._party_nodes: Dict[int, Set[int]] = {}
        self._forced_dead: Set[int] = set()
        self._mask: Tuple[bool, ...] = (True,) * num_parties
        self._version = 0
        self._subs: List[Callable[[MembershipEpoch], None]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg, monitor: Optional[Any] = None
                    ) -> "PartyLivenessController":
        """Build from a GeoConfig: ``num_parties``, the
        ``GEOMX_RESILIENCE_MIN_LIVE`` floor and the heartbeat timeout
        (``GEOMX_HEARTBEAT_TIMEOUT``) all come from the config."""
        return cls(num_parties=cfg.num_parties, monitor=monitor,
                   min_live=max(1, min(cfg.num_parties,
                                       int(getattr(cfg,
                                                   "resilience_min_live",
                                                   1)))),
                   timeout_s=getattr(cfg, "heartbeat_timeout_s", None))

    # ---- wiring ------------------------------------------------------------

    def bind_party(self, party: int, node_id: int) -> None:
        """Attach a heartbeat identity to a party (repeatable: a party
        may carry several nodes)."""
        self._check_party(party)
        with self._lock:
            self._party_nodes.setdefault(party, set()).add(int(node_id))
        if self.monitor is not None:
            self.monitor.register(int(node_id))

    def subscribe(self, cb: Callable[[MembershipEpoch], None]) -> None:
        """Call ``cb(epoch)`` on every epoch change (from the thread that
        triggered the transition)."""
        self._subs.append(cb)

    # ---- the published epoch ----------------------------------------------

    @property
    def epoch(self) -> MembershipEpoch:
        with self._lock:
            return MembershipEpoch(self._version, self._mask)

    # ---- transitions -------------------------------------------------------

    def mark_dead(self, party: int) -> MembershipEpoch:
        """Force a party dead (chaos blackout / operator eviction)."""
        self._check_party(party)
        with self._lock:
            self._forced_dead.add(party)
            epoch, changed = self._recompute_locked(
                self._monitor_dead_locked())
        return self._publish(epoch, changed)

    def mark_live(self, party: int) -> MembershipEpoch:
        """Clear a forced-dead mark (chaos re-admission).  The party
        rejoins the mask only if its bound nodes are also beating."""
        self._check_party(party)
        with self._lock:
            self._forced_dead.discard(party)
            epoch, changed = self._recompute_locked(
                self._monitor_dead_locked())
        return self._publish(epoch, changed)

    def poll(self, dead_nodes: Optional[Sequence[int]] = None,
             timeout_s: Optional[float] = None) -> MembershipEpoch:
        """Re-evaluate the mask from node liveness and publish.

        ``dead_nodes``: an externally-observed dead list (e.g. the
        scheduler's ``SchedulerClient.dead_nodes()`` — the roster-epoch
        consumer path); default consults the bound HeartbeatMonitor."""
        with self._lock:
            if dead_nodes is None:
                dead = self._monitor_dead_locked(timeout_s)
            else:
                dead = set(int(n) for n in dead_nodes)
            epoch, changed = self._recompute_locked(dead)
        return self._publish(epoch, changed)

    # ---- internals ---------------------------------------------------------

    def _check_party(self, party: int) -> None:
        if not 0 <= party < self.num_parties:
            raise ValueError(f"party {party} out of range "
                             f"[0, {self.num_parties})")

    def _monitor_dead_locked(self,
                             timeout_s: Optional[float] = None) -> Set[int]:
        if self.monitor is None:
            return set()
        return set(self.monitor.dead_nodes(
            timeout_s if timeout_s is not None else self.timeout_s))

    def _recompute_locked(self, dead_nodes: Set[int]):
        mask = tuple(
            p not in self._forced_dead
            and not (self._party_nodes.get(p, set()) & dead_nodes)
            for p in range(self.num_parties))
        if sum(mask) < self.min_live:
            raise RuntimeError(
                f"membership floor violated: {sum(mask)} live parties < "
                f"min_live={self.min_live} (mask {mask}) — the run cannot "
                "degrade further; restore a party or abort")
        changed = mask != self._mask
        if changed:
            self._mask = mask
            self._version += 1
        return MembershipEpoch(self._version, self._mask), changed

    def _publish(self, epoch: MembershipEpoch,
                 changed: bool) -> MembershipEpoch:
        # subscribers run OUTSIDE the lock: a callback is free to read
        # .epoch or trigger further transitions without deadlocking
        if changed:
            try:
                self._record_epoch(epoch)
            except Exception:
                # telemetry must never abort the membership publish: a
                # failure there would skip every subscriber and leave
                # degraded sync unconfigured
                pass
            for cb in list(self._subs):
                cb(epoch)
        return epoch

    def _record_epoch(self, epoch: MembershipEpoch) -> None:
        """Membership telemetry: the epoch version and live-party gauges
        answer "is the mesh degraded right now, and since which
        transition" without scraping logs, and the event log keeps the
        transition history with masks."""
        from geomx_tpu_torch.telemetry import get_registry, log_event
        reg = get_registry()
        reg.gauge("geomx_membership_version",
                  "Version of the current membership epoch"
                  ).set(epoch.version)
        reg.gauge("geomx_live_parties",
                  "Parties contributing to the dc-tier aggregate"
                  ).set(epoch.num_live)
        per_party = reg.gauge("geomx_party_live",
                              "Per-party liveness (1 = live)", ("party",))
        for p, ok in enumerate(epoch.live_mask):
            per_party.labels(party=str(p)).set(1.0 if ok else 0.0)
        reg.counter("geomx_membership_transitions_total",
                    "Published membership epoch changes").inc()
        log_event("membership_epoch", version=epoch.version,
                  live_mask=list(epoch.live_mask),
                  num_live=epoch.num_live)


# ---- re-admission catch-up ------------------------------------------------

def pack_catchup(state: Any) -> bytes:
    """Serialize the authoritative state a re-admitted party receives
    before it rejoins the collective, in the checkpoint tree format
    (``utils/checkpoint.py``): params, optimizer state, model state and
    sync state (compressor residuals, pipeline buffers), which keeps the
    error-feedback trajectory consistent across a membership change."""
    from geomx_tpu_torch.utils.checkpoint import tree_to_bytes
    return tree_to_bytes(state)


def unpack_catchup(blob: bytes, target: Any = None) -> Any:
    """Inverse of :func:`pack_catchup`; with ``target`` the leaves are
    placed like the target's (its devices and dtypes), as
    ``load_checkpoint`` places them."""
    from geomx_tpu_torch.utils.checkpoint import tree_from_bytes
    return tree_from_bytes(blob, target=target)
