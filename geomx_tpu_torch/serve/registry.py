"""Published-model registry: dense base once, sparse pair deltas forever
(port of geomx_tpu/serve/registry.py; its frames are byte-identical to
the JAX package's, so either package's client talks to either server).

The registry is the serving plane's source of truth for model weights.  ``publish(version, params)``
journals one dense fp32 base snapshot per version into a
:class:`~geomx_tpu_torch.resilience.durability.DurableStateStore`; every
training round after that appends a **sparse pair-format delta** —
``(values, indices)`` through the pair codec
(:func:`~geomx_tpu_torch.compression.sparseagg.encode_pairs_payload`) — so a
replica refresh applies O(k) work per round
(:func:`~geomx_tpu_torch.compression.sparseagg.densify_pairs_host` add
semantics, never a full checkpoint), and ``materialize()`` reconstructs
the dense params bit-exactly by replaying the same adds in the same
order.

Crash story (identical to the durable host-plane PS tier): every
base layer and delta is a journal record; a restart replays snapshot +
journal, a torn tail truncates, and the persisted **generation token**
bumps once per process start — refresh replies carry it, so a replica
detects the restart and re-syncs from its last applied round instead
of trusting a reset peer.  A replayed delta push (session resume or
failover re-push) dedups on BOTH the ``(sender, rid)`` pair and the
``(layer, round)`` pair — double-apply would silently corrupt weights
with add semantics, so idempotence is load-bearing here, not polish.

Refresh ordering is P3-style (PAPER.md §5): the pending-delta plan is
**layer-major, publish order first** — early layers land before late
ones, so a pipelined consumer can start its forward pass while the
tail of the model is still on the wire.

The wire is the binary codec (:class:`~geomx_tpu_torch.service.protocol.Msg`
frames — no pickle anywhere on this path, GX-WIRE-001 clean); every
PUSH/PULL_REPLY carries ``meta["round"]`` + ``meta["wire_declared"]``
so the fleet round ledger's byte-true accounting covers model refresh
exactly like gradient rounds.  Host-plane Python only (numpy, sockets).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from geomx_tpu_torch.compression.sparseagg import (PAIR_WIRE_MAX_N,
                                             decode_pairs_payload,
                                             densify_pairs_host,
                                             encode_pairs_payload)
from geomx_tpu_torch.resilience.durability import DurableStateStore
from geomx_tpu_torch.service.protocol import (Msg, MsgType, connect_retry,
                                        recv_frame, send_frame)

STORE_NAME = "registry"


class _VersionState:
    """One published version's accumulating state (registry-lock owned)."""

    __slots__ = ("base", "shapes", "order", "deltas", "applied", "rids",
                 "last_round", "published_unix", "delta_frames")

    def __init__(self):
        self.base: Dict[str, np.ndarray] = {}       # layer -> flat fp32
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.order: List[str] = []                  # publish order == P3
        self.deltas: Dict[str, List[Tuple[int, np.ndarray, np.ndarray]]] \
            = {}                                    # layer -> [(round, v, i)]
        self.applied: set = set()                   # {(layer, round)}
        self.rids: set = set()                      # {(sender, rid)}
        self.last_round = 0
        self.published_unix = 0.0
        self.delta_frames = 0

    def to_state(self) -> dict:
        return {"base": dict(self.base), "shapes": dict(self.shapes),
                "order": list(self.order),
                "deltas": {k: list(v) for k, v in self.deltas.items()},
                "applied": sorted(self.applied),
                "rids": sorted(self.rids),
                "last_round": self.last_round,
                "published_unix": self.published_unix,
                "delta_frames": self.delta_frames}

    @classmethod
    def from_state(cls, st: dict) -> "_VersionState":
        vs = cls()
        vs.base = dict(st["base"])
        vs.shapes = {k: tuple(v) for k, v in st["shapes"].items()}
        vs.order = list(st["order"])
        vs.deltas = {k: [tuple(d) for d in v]
                     for k, v in st["deltas"].items()}
        vs.applied = {tuple(a) for a in st["applied"]}
        vs.rids = {tuple(r) for r in st["rids"]}
        vs.last_round = int(st["last_round"])
        vs.published_unix = float(st["published_unix"])
        vs.delta_frames = int(st.get("delta_frames", 0))
        return vs


class ModelRegistry:
    """The in-process registry core: versions, deltas, dedup, recovery.

    ``durable_dir=None`` runs memory-only (generation fixed at 1 — no
    restart to detect); with a directory every mutation journals BEFORE
    it applies, so the in-memory state is always reconstructible."""

    def __init__(self, durable_dir: Optional[str] = None,
                 name: str = STORE_NAME):
        self._lock = threading.Lock()
        self._versions: Dict[str, _VersionState] = {}
        self.replays_deduped = 0
        self._store: Optional[DurableStateStore] = None
        self.generation = 1
        if durable_dir:
            self._store = DurableStateStore(durable_dir, name)
            snap, records = self._store.load()
            if snap is not None:
                self._versions = {v: _VersionState.from_state(st)
                                  for v, st in snap["versions"].items()}
            for rec in records:
                self._replay(rec)
            self.generation = self._store.bump_generation()

    # ---- recovery ----------------------------------------------------------

    def _replay(self, rec: dict) -> None:
        if rec.get("kind") == "base":
            self._apply_base_locked(rec["v"], rec["l"], rec["arr"],
                                    rec["shape"], rec["order"])
        elif rec.get("kind") == "delta":
            self._apply_delta_locked(rec["v"], rec["l"], rec["r"],
                                     rec["vals"], rec["idx"],
                                     rec.get("s", -1), rec.get("rid"))

    # ---- publish (dense base, once per version) ----------------------------

    def publish_layer(self, version: str, layer: str, arr: np.ndarray,
                      order: int) -> None:
        """One dense base layer.  ``order`` is the layer's position in
        the P3 refresh priority (publish order: early layers first)."""
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        shape = tuple(int(d) for d in np.shape(arr))
        with self._lock:
            if self._store is not None:
                self._store.append({"kind": "base", "v": str(version),
                                    "l": str(layer), "arr": flat,
                                    "shape": list(shape),
                                    "order": int(order)})
            self._apply_base_locked(str(version), str(layer), flat,
                                    shape, int(order))

    def _apply_base_locked(self, version, layer, flat, shape, order):
        vs = self._versions.setdefault(version, _VersionState())
        flat = np.asarray(flat, np.float32).reshape(-1)
        if layer not in vs.base:
            while len(vs.order) <= order:
                vs.order.append(None)
            vs.order[order] = layer
        vs.base[layer] = flat
        vs.shapes[layer] = tuple(shape)
        vs.published_unix = time.time()

    def publish(self, version: str, params: Dict[str, np.ndarray]) -> dict:
        """Publish a whole version: dict insertion order IS the P3
        layer priority.  Returns ``{"layers": n, "dense_bytes": b}``."""
        total = 0
        for i, (layer, arr) in enumerate(params.items()):
            self.publish_layer(version, layer, arr, i)
            total += int(np.asarray(arr).size) * 4
        return {"layers": len(params), "dense_bytes": total}

    # ---- sparse deltas -----------------------------------------------------

    def apply_delta(self, version: str, layer: str, round_id: int,
                    vals: np.ndarray, idx: np.ndarray,
                    sender: int = -1, rid: Optional[int] = None) -> bool:
        """Append one pair-format delta; False when the dedup rejects a
        replay ((sender, rid) already seen, or this (layer, round)
        already applied) — the idempotence every re-push path leans on."""
        version, layer = str(version), str(layer)
        with self._lock:
            vs = self._versions.get(version)
            if vs is None:
                raise KeyError(f"unpublished version {version!r}")
            if layer not in vs.base:
                raise KeyError(f"{version!r} has no base layer {layer!r}")
            if (layer, int(round_id)) in vs.applied or \
                    (rid is not None and (int(sender), str(rid)) in vs.rids):
                self.replays_deduped += 1
                return False
            if int(np.asarray(vals).size) and \
                    vs.base[layer].size > PAIR_WIRE_MAX_N:
                raise ValueError(
                    f"layer {layer!r} exceeds PAIR_WIRE_MAX_N "
                    f"({vs.base[layer].size} > {PAIR_WIRE_MAX_N}); "
                    "publish a fresh dense base instead")
            vals = np.asarray(vals, np.float32).reshape(-1)
            idx = np.asarray(idx).reshape(-1).astype(np.int64)
            if self._store is not None:
                self._store.append({"kind": "delta", "v": version,
                                    "l": layer, "r": int(round_id),
                                    "vals": vals, "idx": idx,
                                    "s": int(sender), "rid": rid})
            self._apply_delta_locked(version, layer, int(round_id),
                                     vals, idx, int(sender), rid)
        # fresh apply = the round's "publish" hop in the gradient-to-
        # inference propagation join (outside the lock, best-effort)
        try:
            from geomx_tpu_torch.telemetry.fleetscope import note_propagation
            note_propagation(int(round_id), "publish")
        except Exception:
            pass
        return True

    def _apply_delta_locked(self, version, layer, round_id, vals, idx,
                            sender, rid):
        vs = self._versions.setdefault(version, _VersionState())
        if (layer, round_id) in vs.applied:
            return  # journal replay of a record the snapshot also covers
        vs.deltas.setdefault(layer, []).append(
            (round_id, np.asarray(vals, np.float32).reshape(-1),
             np.asarray(idx).reshape(-1).astype(np.int64)))
        vs.applied.add((layer, round_id))
        if rid is not None:
            vs.rids.add((sender, str(rid)))
        vs.last_round = max(vs.last_round, round_id)
        vs.delta_frames += 1

    # ---- reads -------------------------------------------------------------

    def materialize(self, version: str) -> Dict[str, np.ndarray]:
        """Dense params: base copy + every delta replayed in application
        order with :func:`densify_pairs_host` add semantics — the same
        scatter-adds a replica ran incrementally, so the bits match a
        dense checkpoint maintained alongside exactly."""
        with self._lock:
            vs = self._versions.get(str(version))
            if vs is None:
                raise KeyError(f"unpublished version {version!r}")
            out: Dict[str, np.ndarray] = {}
            for layer in vs.order:
                if layer is None:
                    continue
                flat = vs.base[layer].copy()
                for _r, vals, idx in vs.deltas.get(layer, ()):
                    densify_pairs_host(vals, idx, flat.size, out=flat)
                out[layer] = flat.reshape(vs.shapes[layer])
            return out

    def pending(self, version: str, since_round: int,
                need_base: bool = False,
                since_layers: Optional[Dict[str, int]] = None
                ) -> List[dict]:
        """The P3 refresh plan: layer-major in publish order (early
        layers first), rounds ascending within a layer; optional dense
        base frames (same priority order) ahead of the deltas.

        ``since_layers`` (replica watermarks, layer -> last applied
        round) filters each layer against ITS OWN cursor; a layer the
        map doesn't mention falls back to ``since_round``.  This is
        what makes a partially-landed round safe: a replica that
        already applied layer A's round N still has layer B at N-1 in
        its map, so B's round-N delta stays pending instead of being
        dropped behind a global ``r > N`` filter."""
        with self._lock:
            vs = self._versions.get(str(version))
            if vs is None:
                return []
            plan: List[dict] = []
            layers = [l for l in vs.order if l is not None]
            if need_base:
                for i, layer in enumerate(layers):
                    plan.append({"layer": layer, "base": True, "order": i,
                                 "round": 0,
                                 "shape": list(vs.shapes[layer]),
                                 "arr": vs.base[layer]})
            for layer in layers:
                cut = int(since_round) if since_layers is None \
                    else int(since_layers.get(layer, since_round))
                for r, vals, idx in vs.deltas.get(layer, ()):
                    if r > cut:
                        plan.append({"layer": layer, "base": False,
                                     "round": r, "vals": vals,
                                     "idx": idx,
                                     "n": int(vs.base[layer].size)})
            plan.sort(key=lambda f: (0 if f["base"] else 1,
                                     layers.index(f["layer"]),
                                     f["round"]))
            return plan

    def info(self) -> dict:
        with self._lock:
            versions = {}
            for v, vs in self._versions.items():
                versions[v] = {
                    "layers": len(vs.base),
                    "last_round": vs.last_round,
                    "delta_frames": vs.delta_frames,
                    "dense_bytes": int(sum(a.size for a in
                                           vs.base.values())) * 4,
                    "published_unix": vs.published_unix,
                }
            return {"versions": versions, "generation": self.generation,
                    "replays_deduped": self.replays_deduped}

    def last_round(self, version: str) -> int:
        with self._lock:
            vs = self._versions.get(str(version))
            return 0 if vs is None else vs.last_round

    # ---- durability --------------------------------------------------------

    def compact(self) -> None:
        """Fold the journal into a snapshot (the registry's equivalent
        of the PS tier's round-gate compaction)."""
        with self._lock:
            if self._store is None:
                return
            self._store.compact({"versions": {
                v: vs.to_state() for v, vs in self._versions.items()}})

    def journal_bytes(self) -> int:
        return 0 if self._store is None else self._store.journal_bytes()

    def close(self) -> None:
        if self._store is not None:
            self._store.close()


# ---------------------------------------------------------------------------
# the replicated wire: RegistryServer serves publish/delta/refresh over
# binary Msg frames; RegistryClient is the training- and replica-side
# stub.  No pickle on this path (GX-WIRE-001).
# ---------------------------------------------------------------------------

class RegistryServer:
    """TCP front for a :class:`ModelRegistry` shard.

    Frames in: PUSH (base layer or pair delta), PULL (refresh since a
    round), COMMAND (``serve_info`` / ``serve_compact``), STOP.  Every
    reply carries ``meta["gen"]`` — the restart token replicas compare.
    ``crash()`` severs sockets abruptly (chaos kill); a replacement
    constructed on the same durable dir is the failover."""

    def __init__(self, durable_dir: Optional[str] = None, port: int = 0,
                 bind_host: Optional[str] = None,
                 registry: Optional[ModelRegistry] = None):
        self.registry = registry if registry is not None \
            else ModelRegistry(durable_dir)
        if bind_host is None:
            # host-plane bind knob, parity with GeoPSServer/GeoScheduler
            # graftlint: disable=GXL006 — host-plane knob
            bind_host = os.environ.get("GEOMX_PS_BIND_HOST", "127.0.0.1")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        from geomx_tpu_torch.service.server import GeoPSServer
        GeoPSServer._bind_with_retry(self._srv, bind_host, int(port))
        self._srv.listen(64)
        self._srv.settimeout(0.2)
        self.addr = self._srv.getsockname()
        self.port = self.addr[1]
        self._running = True
        self._conns: set = set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="registry-accept", daemon=True)

    @property
    def generation(self) -> int:
        return self.registry.generation

    def start(self) -> "RegistryServer":
        self._accept_thread.start()
        return self

    # ---- networking --------------------------------------------------------

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while self._running:
                msg = recv_frame(conn)
                if msg is None:
                    return
                if not self._dispatch(conn, msg):
                    return
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._conns.discard(conn)
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn: socket.socket, msg: Msg) -> bool:
        reg = self.registry
        if msg.type == MsgType.PUSH:
            version, _, layer = (msg.key or "").partition("/")
            meta = msg.meta
            # a bad PUSH (unpublished version/layer, oversized pair
            # payload, garbage frame) must answer with an ERROR frame,
            # not a torn-down socket — the client would otherwise
            # retry the identical frame and surface an opaque
            # ConnectionError instead of the real cause
            try:
                if meta.get("base"):
                    reg.publish_layer(version, layer, msg.array,
                                      int(meta.get("order", 0)))
                    applied = True
                else:
                    vals, idx = decode_pairs_payload(msg.array)
                    applied = reg.apply_delta(
                        version, layer, int(meta["round"]), vals, idx,
                        sender=msg.sender, rid=meta.get("rid"))
            except (KeyError, ValueError, TypeError) as e:
                send_frame(conn, Msg(
                    MsgType.ERROR, sender=-1,
                    meta={"error": f"{type(e).__name__}: {e}",
                          "gen": reg.generation,
                          "rid": meta.get("rid", 0)}))
                return True
            send_frame(conn, Msg(
                MsgType.ACK, sender=-1,
                meta={"gen": reg.generation, "applied": int(applied),
                      "rid": meta.get("rid", 0),
                      "last_round": reg.last_round(version)}))
            return True
        if msg.type == MsgType.PULL:
            version = msg.key or ""
            try:
                since_layers = msg.meta.get("since_layers")
                plan = reg.pending(
                    version, int(msg.meta.get("since", 0)),
                    need_base=bool(msg.meta.get("need_base")),
                    since_layers=since_layers)
                for f in plan:
                    if f["base"]:
                        arr = f["arr"]
                        meta = {"version": version, "base": 1,
                                "order": f["order"], "round": 0,
                                "shape": f["shape"],
                                "wire_declared": int(arr.nbytes)}
                    else:
                        arr = encode_pairs_payload(f["vals"], f["idx"])
                        meta = {"version": version, "base": 0,
                                "round": f["round"], "n": f["n"],
                                "comp": "pairs",
                                "wire_declared": int(arr.nbytes)}
                    send_frame(conn, Msg(MsgType.PULL_REPLY,
                                         key=f"{version}/{f['layer']}",
                                         sender=-1, meta=meta, array=arr))
            except (KeyError, ValueError, TypeError) as e:
                send_frame(conn, Msg(
                    MsgType.ERROR, sender=-1,
                    meta={"error": f"{type(e).__name__}: {e}",
                          "gen": reg.generation,
                          "rid": msg.meta.get("rid", 0)}))
                return True
            send_frame(conn, Msg(
                MsgType.ACK, sender=-1,
                meta={"gen": reg.generation, "frames": len(plan),
                      "rid": msg.meta.get("rid", 0),
                      "last_round": reg.last_round(version)}))
            return True
        if msg.type == MsgType.COMMAND:
            cmd = msg.meta.get("cmd")
            if cmd == "serve_info":
                send_frame(conn, Msg(MsgType.ACK, sender=-1,
                                     meta={"gen": reg.generation,
                                           "info": reg.info()}))
            elif cmd == "serve_compact":
                reg.compact()
                send_frame(conn, Msg(MsgType.ACK, sender=-1,
                                     meta={"gen": reg.generation}))
            else:
                send_frame(conn, Msg(MsgType.ERROR, sender=-1,
                                     meta={"error": f"unknown cmd {cmd!r}"}))
            return True
        if msg.type == MsgType.STOP:
            send_frame(conn, Msg(MsgType.ACK, sender=-1,
                                 meta={"gen": reg.generation}))
            self.stop()
            return False
        send_frame(conn, Msg(MsgType.ERROR, sender=-1,
                             meta={"error": f"unhandled {msg.type.name}"}))
        return True

    # ---- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
        self.registry.close()

    def crash(self) -> None:
        """Chaos kill: sever every socket abruptly — no drains, nothing
        graceful.  Only the durable dir survives, as for a real kill."""
        self._running = False
        for sock in [self._srv] + list(self._conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.registry.close()

    def join(self, timeout: Optional[float] = None) -> None:
        self._accept_thread.join(timeout)


class RegistryClient:
    """Training- and replica-side stub.  One socket, synchronous
    request/reply; a send that dies mid-flight reconnects and REPLAYS
    the same ``rid`` — the registry's dedup makes the retry exactly-once
    (the kill-mid-refresh chaos case)."""

    def __init__(self, addr: Tuple[str, int], sender: int = 0,
                 timeout_s: float = 30.0):
        self.addr = (str(addr[0]), int(addr[1]))
        self.sender = int(sender)
        self.timeout_s = float(timeout_s)
        # reentrant: publish/push_delta/pull_updates hold it across the
        # whole exchange and mint rids (next_rid) from inside
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._rid = 0
        self.replays_sent = 0

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = connect_retry(self.addr,
                                       total_timeout_s=self.timeout_s)
            self._sock.settimeout(self.timeout_s)
        return self._sock

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, msg: Msg, retries: int = 1) -> Msg:
        """Send one frame, read one reply; on a dead socket reconnect
        and resend the SAME frame (same rid — dedup absorbs it)."""
        for attempt in range(retries + 1):
            try:
                sock = self._conn()
                send_frame(sock, msg)
                rep = recv_frame(sock)
                if rep is None:
                    raise ConnectionError("registry closed mid-reply")
                return rep
            except (ConnectionError, OSError, TimeoutError):
                self._drop_conn()
                if attempt >= retries:
                    raise
                self.replays_sent += 1
        raise ConnectionError("unreachable")

    def next_rid(self) -> int:
        with self._lock:
            self._rid += 1
            return self._rid

    # ---- operations --------------------------------------------------------

    def publish(self, version: str, params: Dict[str, np.ndarray],
                retries: int = 1) -> dict:
        """Dense base snapshot, one PUSH per layer in dict order (the
        P3 priority order)."""
        ack = {}
        with self._lock:
            for i, (layer, arr) in enumerate(params.items()):
                arr = np.ascontiguousarray(arr, np.float32)
                rep = self._roundtrip(Msg(
                    MsgType.PUSH, key=f"{version}/{layer}",
                    sender=self.sender,
                    meta={"base": 1, "order": i, "round": 0,
                          "rid": self.next_rid(),
                          "wire_declared": int(arr.nbytes)},
                    array=arr), retries=retries)
                if rep.type == MsgType.ERROR:
                    raise RuntimeError(
                        rep.meta.get("error", "publish failed"))
                ack = dict(rep.meta)
        return ack

    def push_delta(self, version: str, round_id: int,
                   layers: Dict[str, Tuple[np.ndarray, np.ndarray]],
                   retries: int = 1) -> dict:
        """One training round's sparse delta: one pair-payload PUSH per
        layer.  Returns the last ACK meta (``gen``, ``applied``,
        ``last_round``); raises on an un-retryable wire death."""
        ack = {}
        applied = 0
        with self._lock:
            for layer, (vals, idx) in layers.items():
                payload = encode_pairs_payload(vals, idx)
                rep = self._roundtrip(Msg(
                    MsgType.PUSH, key=f"{version}/{layer}",
                    sender=self.sender,
                    meta={"base": 0, "round": int(round_id),
                          "rid": self.next_rid(), "comp": "pairs",
                          "wire_declared": int(payload.nbytes)},
                    array=payload), retries=retries)
                if rep.type == MsgType.ERROR:
                    raise RuntimeError(rep.meta.get("error", "push failed"))
                ack = dict(rep.meta)
                applied += int(ack.get("applied", 0))
        ack["applied_layers"] = applied
        return ack

    def pull_updates(self, version: str, since_round: int,
                     need_base: bool = False,
                     since_layers: Optional[Dict[str, int]] = None
                     ) -> Tuple[List[Msg], dict]:
        """Refresh stream: every pending frame (base first when asked,
        then deltas in P3 order) plus the terminal ACK meta.
        ``since_layers`` carries the replica's per-layer watermarks so
        a partially-landed round is never filtered out (see
        :meth:`ModelRegistry.pending`)."""
        with self._lock:
            sock = self._conn()
            meta = {"since": int(since_round),
                    "need_base": int(bool(need_base)),
                    "rid": self.next_rid()}
            if since_layers:
                meta["since_layers"] = {str(k): int(v)
                                        for k, v in since_layers.items()}
            send_frame(sock, Msg(
                MsgType.PULL, key=str(version), sender=self.sender,
                meta=meta))
            frames: List[Msg] = []
            while True:
                rep = recv_frame(sock)
                if rep is None:
                    self._drop_conn()
                    raise ConnectionError("registry died mid-refresh")
                if rep.type == MsgType.ACK:
                    return frames, dict(rep.meta)
                if rep.type == MsgType.ERROR:
                    raise RuntimeError(rep.meta.get("error", "pull failed"))
                frames.append(rep)

    def info(self) -> dict:
        rep = self._roundtrip(Msg(MsgType.COMMAND, sender=self.sender,
                                  meta={"cmd": "serve_info"}))
        return dict(rep.meta)

    def compact(self) -> dict:
        rep = self._roundtrip(Msg(MsgType.COMMAND, sender=self.sender,
                                  meta={"cmd": "serve_compact"}))
        return dict(rep.meta)

    def close(self) -> None:
        with self._lock:
            self._drop_conn()
