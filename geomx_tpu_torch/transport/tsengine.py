"""TSEngine — throughput-adaptive communication-overlay scheduling (port
of geomx_tpu/transport/tsengine.py).

Reference semantics (3rdparty/ps-lite/src/van.cc:1192-1551): a central
scheduler holds

- ``A[i][j]`` — measured throughput from node i to node j (reported
  piggy-backed on each ASK),
- ``B[j]``   — busy flags: nodes already reached this dissemination round,
- ``lifetime[i][j]`` — the round a measurement was taken (staleness),
- ``iters``  — the dissemination round counter.

*Pull/dissemination* (ProcessAskCommand, van.cc:1358-1435): when a node
holding fresh data ASKs for a receiver, the scheduler answers with an
epsilon-greedy choice: with probability ``min(known/(known+unknown),
max_greed_rate)`` pick the non-busy receiver with the highest measured
throughput from the asker; otherwise pick a random non-busy receiver
(exploration).  When every worker is marked busy the round is over, flags
reset, ``iters`` advances, and askers on an old version are told -1 (stop).

*Push/aggregation* (ProcessAsk1Command, van.cc:1240-1296): nodes that
finished local work queue up; the scheduler pairs them two at a time and
directs the lower-throughput one to send to the higher-throughput one
(relay merge), with node 0 (the server) as the final sink — a dynamically
chosen aggregation tree replacing static fan-in.

This module is the pure scheduling brain (deterministic, seedable,
testable); the host-side async store drives it with real transfer
measurements.
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

STOP = -1


class TSEngineScheduler:
    def __init__(self, num_nodes: int, max_greed_rate: float = 0.9,
                 seed: Optional[int] = None):
        """``num_nodes`` counts the participating receivers (workers in the
        intra-party instance, parties in the global instance).
        ``max_greed_rate`` mirrors MAX_GREED_RATE_TS (van.cc:447-454)."""
        if num_nodes < 1:
            raise ValueError("num_nodes must be >= 1")
        self.n = num_nodes
        self.max_greed_rate = float(max_greed_rate)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # A[i][j]: last measured throughput i -> j; None = never measured
        self.A: List[List[Optional[float]]] = [
            [None] * num_nodes for _ in range(num_nodes)]
        self.lifetime: List[List[int]] = [[-1] * num_nodes for _ in range(num_nodes)]
        self.busy: List[bool] = [False] * num_nodes
        self.iters = 0
        # push pairing queue (ASK1)
        self._ask_q: deque = deque()
        self._push_done: List[bool] = [False] * num_nodes
        # per-key ASK1 round state (ask1_key)
        self._push_keys: Dict = {}

    # ---- dissemination (pull) ---------------------------------------------

    def report(self, sender: int, receiver: int, throughput: float,
               version: int) -> None:
        """Record a measured transfer (piggy-backed on ASK in the reference)."""
        with self._lock:
            self.A[sender][receiver] = float(throughput)
            self.lifetime[sender][receiver] = version

    def ask(self, sender: int, version: int) -> int:
        """Next receiver for `sender`'s fresh update, or STOP.

        Mirrors ProcessAskCommand: round bookkeeping, then epsilon-greedy
        receiver choice among non-busy nodes.
        """
        with self._lock:
            if all(self.busy):
                self.busy = [False] * self.n
                self.iters += 1
            if version <= self.iters:
                return STOP
            known = [j for j in range(self.n)
                     if not self.busy[j] and self.A[sender][j] is not None]
            unknown = [j for j in range(self.n)
                       if not self.busy[j] and self.A[sender][j] is None]
            if not known and not unknown:
                return STOP
            greed = len(known) / (len(known) + len(unknown))
            greed = min(greed, self.max_greed_rate)
            if known and self._rng.random() < greed:
                receiver = max(known, key=lambda j: self.A[sender][j])
            else:
                receiver = self._rng.choice(unknown or known)
            self.busy[receiver] = True
            return receiver

    # ---- aggregation pairing (push) ---------------------------------------

    def ask1_key(self, node: int, key,
                 num_pushers: int) -> Optional[Tuple[int, int]]:
        """Per-key Ask1 pairing round (ProcessAsk1Command, van.cc:1238-1296,
        redesigned with per-key state instead of the reference's global
        FIFO so concurrent keys cannot cross-pair).

        ``node`` (1-based; 0 is the sink/server) announces it holds a
        partial aggregate of ``key``.  Returns a directive (sender,
        receiver) when a pairing is decided, else None (wait).  Each
        pairing removes one holder; after num_pushers-1 pairings the last
        holder is directed to the sink (0) and the round resets.  Repeat
        asks while a node is already queued are ignored (reference's
        ask_q dedup), so one directive disposes a node's whole merged
        buffer."""
        with self._lock:
            st = self._push_keys.setdefault(
                key, {"q": deque(), "pairs": 0})
            if node in st["q"]:
                return None
            if st["pairs"] >= num_pushers - 1:
                # the final merged holder: everything reduces to the sink
                st["pairs"] = 0
                st["q"].clear()
                return (node, 0)
            st["q"].append(node)
            if len(st["q"]) < 2:
                return None
            a = st["q"].popleft()
            b = st["q"].popleft()
            ab = self.A[a][b] if self.A[a][b] is not None else -1.0
            ba = self.A[b][a] if self.A[b][a] is not None else -1.0
            # the node with the better measured path to its partner sends
            sender, receiver = (a, b) if ab > ba else (b, a)
            st["pairs"] += 1
            return (sender, receiver)

    def drain_key(self, key) -> List[int]:
        """Abort the key's pairing round (a relay failed): return every
        still-queued node — the caller directs them straight to the sink
        — and reset the round state so the next round starts clean."""
        with self._lock:
            st = self._push_keys.get(key)
            if st is None:
                return []
            queued = list(st["q"])
            st["q"].clear()
            st["pairs"] = 0
            return queued

    def ask1(self, node: int) -> Optional[Tuple[int, int]]:
        """Node reports its partial aggregate is ready; returns a directed
        pair (sender, receiver) once two nodes are queued, else None.

        Node 0 is the sink: anything paired with 0 sends to 0
        (ProcessAsk1Command, van.cc:1254-1271); otherwise the
        lower-measured-throughput node sends to the other.
        """
        with self._lock:
            if len(self._ask_q) == 1 and self._ask_q[0] == node:
                return None
            self._ask_q.append(node)
            if len(self._ask_q) < 2:
                return None
            a = self._ask_q.popleft()
            b = self._ask_q.popleft()
            if a == 0 or b == 0:
                sender, receiver = (b, a) if a == 0 else (a, b)
            else:
                ab = self.A[a][b] if self.A[a][b] is not None else -1.0
                ba = self.A[b][a] if self.A[b][a] is not None else -1.0
                sender, receiver = (a, b) if ab > ba else (b, a)
            self._push_done[sender] = True
            if all(self._push_done[1:]):
                self._push_done = [False] * self.n
            return sender, receiver
