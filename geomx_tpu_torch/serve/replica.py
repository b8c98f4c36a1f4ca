"""Per-party serving replica: the local dense copy deltas stream into
(port of geomx_tpu/serve/replica.py).

A :class:`ServingReplica` holds the dense fp32 params one party serves
inference from.  It is fed two ways: a full base install (once, at
version publish) and O(k) sparse pair deltas (every training round
after).  Three properties matter more than anything else here:

- **atomic swap, zero downtime**: a delta is applied to a COPY of the
  target layer and the params dict reference swaps once under the
  lock — the gateway's forward pass always reads a complete,
  internally-consistent weight set, never a torn refresh (and a
  restarting replica keeps serving its stale copy while it re-syncs);
- **idempotent apply**: the replica dedups on the same ``(layer,
  round)`` key the registry journals, so a refresh stream replayed
  after a registry failover (or a session resume re-push) cannot
  double-apply — with add semantics a double-apply is silent weight
  corruption, not an error;
- **restart detection**: every refresh reply carries the registry's
  generation token; a change means the registry restarted, and
  :meth:`sync` re-pulls from the replica's own watermarks — the
  replica's dedup absorbs whatever the fresh registry re-sends;
- **per-layer watermarks**: a training round is one PUSH per layer,
  so the registry can transiently hold round N for layer A but not
  yet layer B.  :meth:`sync` therefore sends a per-layer ``since``
  map (last round applied to THAT layer), and the registry filters
  its pending plan per layer — a sync landing mid-round re-pulls the
  straggler layer's round-N delta on the next refresh instead of
  filtering it out behind a global round cursor forever.

Freshness is tracked as both the last applied round and wall-clock
seconds since the last successful refresh (``staleness_s``) — the
numbers the scheduler's ``/healthz`` serving surface and the
``geomx_serve_replica_staleness_seconds`` gauge report.

Host-plane Python only (numpy): the gateway copies the weights to the
device at its own boundary.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from geomx_tpu_torch.compression.sparseagg import (decode_pairs_payload,
                                             densify_pairs_host)
from geomx_tpu_torch.serve.registry import RegistryClient


def _scatter_inplace(flat: np.ndarray, vals: np.ndarray,
                     idx: np.ndarray) -> None:
    """In-order pair scatter-add into ``flat`` — np.add.at semantics
    (sentinels idx<0 dropped, duplicates sum sequentially).  Routed
    through the nogil native runtime when built; the numpy fallback is
    bit-identical float32 by construction (same sequential fold)."""
    try:
        from geomx_tpu_torch.runtime.native import scatter_pairs
        if scatter_pairs(flat, vals, idx) is not None:
            return
    except (ImportError, ValueError):
        pass
    densify_pairs_host(vals, idx, flat.size, out=flat)


class ServingReplica:
    """One party's serving copy of one published version."""

    def __init__(self, version: str, party: int = 0):
        self.version = str(version)
        self.party = int(party)
        self._lock = threading.Lock()
        self._params: Dict[str, np.ndarray] = {}    # layer -> shaped fp32
        self._order: List[str] = []
        self._applied: set = set()                  # {(layer, round)}
        self._layer_rounds: Dict[str, int] = {}     # layer -> last applied
        self._last_round = 0
        self._gen: Optional[int] = None
        self._refresh_mono = 0.0     # monotonic: wall steps must not
        #                              corrupt the staleness bound
        # O(k) refresh fast path:
        # the flat buffer WE allocated backing the published view (None
        # when the layer came straight from a base install — that array
        # may alias a read-only wire buffer we must never scatter into),
        # and the retired previous buffer, which lags the published
        # value by EXACTLY the one delta recorded next to it.
        self._pub_flat: Dict[str, Optional[np.ndarray]] = {}
        self._spare: Dict[str, Tuple[np.ndarray, np.ndarray,
                                     np.ndarray]] = {}
        self.refreshes = 0
        self.deltas_applied = 0
        self.replays_deduped = 0
        self.restarts_detected = 0
        self.o1_applies = 0          # O(k) scatter-into-spare refreshes
        self.dense_copies = 0        # O(n) copy fallbacks

    # ---- feeds -------------------------------------------------------------

    def install_base(self, layer: str, arr: np.ndarray, order: int,
                     shape: Optional[Tuple[int, ...]] = None) -> None:
        arr = np.asarray(arr, np.float32)
        if shape is not None:
            arr = arr.reshape(tuple(shape))
        with self._lock:
            if layer not in self._params:
                while len(self._order) <= order:
                    self._order.append(None)
                self._order[order] = layer
            self._params = dict(self._params)       # copy-on-write swap
            self._params[layer] = np.ascontiguousarray(arr)
            # the base may alias the (read-only) wire buffer: not ours
            # to scatter into, and any retired spare is now stale
            self._pub_flat[layer] = None
            self._spare.pop(layer, None)
            self._layer_rounds.setdefault(layer, 0)
            self._refresh_mono = time.monotonic()

    def apply_delta(self, layer: str, round_id: int, vals: np.ndarray,
                    idx: np.ndarray) -> bool:
        """One pair delta onto a private copy of the layer, then swap.
        False = deduped replay (already applied, nothing changed).

        The hot path is O(k), not O(n): every publish retires the
        previous flat buffer next to the one delta it is missing, so
        the NEXT apply replays that single delta into the retired
        buffer (O(k)), scatters the new delta (O(k)), and republishes
        it — two buffers ping-pong per layer, no per-delta dense copy.
        Safety gate: the retired buffer is reused only when its
        refcount proves no reader still holds the old params dict (a
        forward pass mid-batch, a snapshot in a test) — otherwise this
        apply falls back to the O(n) dense copy, counted in
        ``dense_copies``.  Both paths run the identical sequence of
        in-order float32 scatter-adds, so the served weights are
        bit-exact against a dense checkpoint either way."""
        with self._lock:
            if (layer, int(round_id)) in self._applied:
                self.replays_deduped += 1
                return False
            cur = self._params[layer]
            vals = np.ascontiguousarray(vals, np.float32).reshape(-1)
            idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
            if idx.size and int(idx.max()) >= cur.size:
                raise ValueError(
                    f"delta index {int(idx.max())} out of range for "
                    f"size-{cur.size} layer {layer!r}")
            new_flat = None
            sp = self._spare.pop(layer, None)
            if sp is not None:
                flat, mv, mi = sp
                # refs on flat right now: the sp tuple, the local name,
                # and getrefcount's own argument = 3.  Anything above
                # that is the retired published view (alive inside a
                # reader-held params dict) still pinning its base —
                # writing would tear that reader's forward pass.
                if flat.size == cur.size \
                        and sys.getrefcount(flat) <= 3:
                    _scatter_inplace(flat, mv, mi)   # catch up: the one
                    #                                  delta it missed
                    _scatter_inplace(flat, vals, idx)
                    new_flat = flat
                    self.o1_applies += 1
                # else: drop the blocked spare — the buffer retired
                # below replaces it (missing exactly this delta)
            if new_flat is None:
                new_flat = cur.reshape(-1).copy()
                _scatter_inplace(new_flat, vals, idx)
                self.dense_copies += 1
            prev = self._pub_flat.get(layer)
            if prev is not None and prev.size == cur.size \
                    and prev is not new_flat:
                self._spare[layer] = (prev, vals.copy(), idx.copy())
            self._pub_flat[layer] = new_flat
            self._params = dict(self._params)
            self._params[layer] = new_flat.reshape(cur.shape)
            self._applied.add((layer, int(round_id)))
            self._layer_rounds[layer] = max(
                self._layer_rounds.get(layer, 0), int(round_id))
            self._last_round = max(self._last_round, int(round_id))
            self.deltas_applied += 1
            self._refresh_mono = time.monotonic()
        # telemetry outside the lock: the per-layer watermark gauge is
        # how any scrape reader sees sync progress (the map itself was
        # invisible outside the lock until now), and the propagation
        # tracker's "apply" hop anchors the gradient-to-inference join
        try:
            from geomx_tpu_torch.telemetry.registry import get_registry
            get_registry().gauge(
                "geomx_serve_replica_round",
                "Last training round applied to each serving layer",
                ("layer",)).labels(layer=layer).set(int(round_id))
        except Exception:
            pass
        try:
            from geomx_tpu_torch.telemetry.fleetscope import note_propagation
            note_propagation(int(round_id), "apply")
        except Exception:
            pass
        return True

    def sync(self, client: RegistryClient) -> dict:
        """One refresh round-trip: pull everything after our per-layer
        watermarks (plus the base if we have nothing yet), apply with
        dedup, adopt the registry's generation token.  A token change
        is a detected restart — counted, and harmless, because the
        pull already asked from OUR watermarks, not the registry's.

        The since map is per layer — a train-while-serving sync that
        lands mid-round (registry holds round N for layer A, layer B
        still in flight) leaves layer B's watermark at N-1, so B's
        round-N delta is still pending on the next pull even though
        the replica's global round already reads N."""
        with self._lock:
            since_layers = dict(self._layer_rounds)
            since = min(since_layers.values(), default=0)
            need_base = not self._params
            prev_gen = self._gen
        frames, tail = client.pull_updates(self.version, since,
                                           need_base=need_base,
                                           since_layers=since_layers)
        applied = deduped = 0
        for msg in frames:
            _v, _, layer = (msg.key or "").partition("/")
            if msg.meta.get("base"):
                self.install_base(layer, msg.array,
                                  int(msg.meta.get("order", 0)),
                                  shape=tuple(msg.meta.get("shape", ())))
                applied += 1
            else:
                vals, idx = decode_pairs_payload(msg.array)
                if self.apply_delta(layer, int(msg.meta["round"]),
                                    vals, idx):
                    applied += 1
                else:
                    deduped += 1
        gen = tail.get("gen")
        with self._lock:
            if prev_gen is not None and gen is not None \
                    and gen != prev_gen:
                self.restarts_detected += 1
            self._gen = gen
            self._refresh_mono = time.monotonic()
            self.refreshes += 1
        return {"frames": len(frames), "applied": applied,
                "deduped": deduped, "gen": gen,
                "registry_last_round": tail.get("last_round"),
                "restart_detected": prev_gen is not None
                and gen is not None and gen != prev_gen}

    # ---- reads -------------------------------------------------------------

    def params(self) -> Dict[str, np.ndarray]:
        """The CURRENT complete weight set (an immutable-by-convention
        dict reference — the swap discipline means a caller may keep
        using it for a whole forward pass)."""
        with self._lock:
            return self._params

    def params_stamp(self) -> Tuple[Dict[str, np.ndarray], int,
                                    Dict[str, int]]:
        """``(params(), last_round(), layer_rounds())`` read under one
        lock: the weight set and the rounds it holds, consistent with
        each other (a refresh swaps one layer at a time, so three
        separate reads can straddle a swap)."""
        with self._lock:
            return self._params, self._last_round, dict(self._layer_rounds)

    def layer_order(self) -> List[str]:
        with self._lock:
            return [l for l in self._order if l is not None]

    def last_round(self) -> int:
        with self._lock:
            return self._last_round

    def layer_rounds(self) -> Dict[str, int]:
        """Per-layer applied-round watermarks (a copy) — the freshness
        provenance both inference doors stamp onto replies."""
        with self._lock:
            return dict(self._layer_rounds)

    def generation(self) -> Optional[int]:
        with self._lock:
            return self._gen

    def staleness_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last successful refresh, on the MONOTONIC
        clock (``now``, when given, must be a ``time.monotonic()``
        instant) — an NTP wall-clock step mid-run must not fake a
        freshness violation or mask a real one."""
        with self._lock:
            if not self._refresh_mono:
                return float("inf")
            return max(0.0, (time.monotonic() if now is None else now)
                       - self._refresh_mono)

    def snapshot(self) -> dict:
        """The ``/healthz`` serving-surface row for this replica."""
        with self._lock:
            staleness = (float("inf") if not self._refresh_mono
                         else max(0.0,
                                  time.monotonic() - self._refresh_mono))
            return {"version": self.version, "party": self.party,
                    "layers": len(self._params),
                    "last_round": self._last_round,
                    "layer_rounds": dict(self._layer_rounds),
                    "generation": self._gen,
                    "staleness_s": (None if staleness == float("inf")
                                    else round(staleness, 3)),
                    "refreshes": self.refreshes,
                    "deltas_applied": self.deltas_applied,
                    "replays_deduped": self.replays_deduped,
                    "restarts_detected": self.restarts_detected,
                    "o1_applies": self.o1_applies,
                    "dense_copies": self.dense_copies}
