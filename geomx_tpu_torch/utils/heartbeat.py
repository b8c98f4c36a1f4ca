"""Failure detection: heartbeats and dead-node tracking (port of
geomx_tpu/utils/heartbeat.py).

Parity with the reference's liveness machinery (van.cc:1147-1160 heartbeat
thread -> scheduler; Postoffice::GetDeadNodes postoffice.h:187 surfaced to
python as kv.get_num_dead_node, kvstore_dist.h:226-235).  In the
single-controller SPMD world this guards the *host-side* participants of
the async store and any external data feeders; device failures surface as
XLA errors handled by the restore path.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 15.0):
        # PS_HEARTBEAT_TIMEOUT default (van.h:304-305)
        self.timeout_s = float(timeout_s)
        self._last: Dict[int, float] = {}
        self._lock = threading.Lock()

    def register(self, node_id: int):
        with self._lock:
            self._last[node_id] = time.monotonic()

    def heartbeat(self, node_id: int):
        with self._lock:
            self._last[node_id] = time.monotonic()

    def unregister(self, node_id: int):
        """Forget a node entirely (server-side eviction, resilience/):
        an evicted node must stop counting as dead — its absence is now
        policy, not failure."""
        with self._lock:
            self._last.pop(node_id, None)

    def _snapshot(self) -> List[tuple]:
        """Copy the beat table under the lock, WITHOUT evaluating it:
        the dead/alive sweeps run over the snapshot outside the lock, so
        a 32-party ``/healthz`` or ``num_dead_nodes`` scan can never
        stall concurrent ``heartbeat()``/``register()`` RPCs behind an
        O(N) pass (they share this lock)."""
        with self._lock:
            return list(self._last.items())

    def dead_nodes(self, timeout_s: Optional[float] = None) -> List[int]:
        """Nodes silent for longer than the timeout
        (reference GetDeadNodes(t))."""
        t = timeout_s if timeout_s is not None else self.timeout_s
        snap = self._snapshot()
        now = time.monotonic()
        return sorted(n for n, ts in snap if now - ts > t)

    def alive_nodes(self, timeout_s: Optional[float] = None) -> List[int]:
        """Complement of dead_nodes over the registered set — what the
        PartyLivenessController folds into a live-party mask."""
        t = timeout_s if timeout_s is not None else self.timeout_s
        snap = self._snapshot()
        now = time.monotonic()
        return sorted(n for n, ts in snap if now - ts <= t)

    @property
    def num_dead_nodes(self) -> int:
        return len(self.dead_nodes())

    def start_beating(self, node_id: int, interval_s: float,
                      stop_event: threading.Event) -> threading.Thread:
        """Spawn a daemon heartbeat thread (reference Van::Heartbeat loop)."""
        self.register(node_id)

        def run():
            while not stop_event.wait(interval_s):
                self.heartbeat(node_id)

        th = threading.Thread(target=run, daemon=True,
                              name=f"heartbeat-{node_id}")
        th.start()
        return th
