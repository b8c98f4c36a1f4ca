"""GeoScheduler — the central registration/discovery service (port of
geomx_tpu/service/scheduler.py).

The reference's scheduler role (3rdparty/ps-lite/src/van.cc:41-163,
postoffice.h:104-116): every node sends ADD_NODE at startup; the
scheduler assigns node ids centrally (servers even, workers odd, starting
at kOffset=100; global tier ids 8,10,... / 9,11,...), keeps the cluster
roster, and on a node's re-registration marks it ``is_recovery`` and
re-sends the cluster state (van.cc:165-212) so a restarted process can
resume without a fresh barrier.

Here the same capability as a small TCP service speaking the framework's
COMMAND protocol:

- ``register`` assigns an id per role (stable across re-registration:
  the same (role, host, port) — or an explicit ``prev_id`` — gets its
  old id back with ``is_recovery=True``), records the node's serving
  address, and returns the current roster;
- ``cluster`` returns the roster (role -> [(id, host, port, tag)];
  ``tag`` carries e.g. the party id so workers can find THEIR server) —
  how nodes discover each other instead of hard-wired env addressing;
- ``barrier`` blocks until ``expect`` nodes enter (the per-tier Barrier);
- heartbeats feed the shared dead-node detector;
- the key-range sharded global tier's versioned shard map lives here
  (``init_shard_map``, ``shard_map``, ``shard_failover``,
  ``rebalance_shards``): clients fetch it, a failover re-points a
  shard's address, and a rebalance moves range bounds from the shards'
  observed load and migrates the key state shard to shard.

Durability (``durable_dir``/``GEOMX_DURABLE_DIR``): the roster, the id
table, the epoch and every shard-map install persist through a
``resilience.durability.DurableStateStore`` named ``scheduler``, so a
restarted scheduler hands every re-registering node its old id and the
epoch keeps counting.  For ``restart_grace_s`` (``GEOMX_RESTART_GRACE_S``,
default the heartbeat timeout) after such a restart the dead list stays
empty, so live nodes that have not re-dialed yet are not read as dead.

Telemetry: roster churn (registrations, evictions, epoch bumps) is
recorded as registry gauges/counters and as profiler instants carrying
the roster epoch; a restart is announced to the registry, the event log
and the flight recorders.  ``metrics_port=0`` (or ``GEOMX_METRICS_PORT``)
starts an HTTP endpoint answering ``GET /metrics`` (Prometheus text),
``/healthz`` and ``/ledger``, and the ``metrics`` command returns the
same exposition over the wire protocol; ``geomx_build_info`` carries
the build identity.  ``GET /control`` answers the control plane's
decision log (``control/actuators.py``).  With ``GEOMX_FLEETSCOPE=1``
the fleet aggregator (``telemetry/fleetscope.py``) runs beside the
endpoint and ``GET /fleet`` serves its document.  The health document
carries the serving surface (``serve/``: published versions, replica
freshness, queue depth) under ``"serving"`` when a gateway or replica
runs in this process, and a gateway joins the roster as a ``serve``
node (``InferenceGateway.register_with_scheduler``).

`geomx_tpu_torch/launch.py` starts one per job when GEOMX_USE_SCHEDULER=1
and `geomx_tpu_torch/examples/dist_ps.py` then discovers every address
through it.
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
import time
from typing import Dict, Optional, Tuple

from geomx_tpu_torch.config import _env
from geomx_tpu_torch.service.protocol import (Msg, MsgType, connect_retry,
                                              recv_frame, send_frame)
from geomx_tpu_torch.utils.heartbeat import HeartbeatMonitor

KOFFSET = 100  # reference base.h:36: intra-party ids start here


class GeoScheduler:
    """Role-based id assignment (servers even, workers odd — the
    reference's scheme) + roster + barrier."""

    def __init__(self, port: int = 0, bind_host: Optional[str] = None,
                 heartbeat_timeout: float = 15.0,
                 metrics_port: Optional[int] = None,
                 durable_dir: Optional[str] = None,
                 restart_grace_s: Optional[float] = None):
        """``metrics_port``: the HTTP endpoint's port (explicit wins,
        else ``GEOMX_METRICS_PORT``, 0 = ephemeral; unset = none).
        ``durable_dir`` (default ``GEOMX_DURABLE_DIR``) arms the durable
        roster; ``restart_grace_s`` shapes its restart."""
        self._lock = threading.Lock()
        # (role, host, port, tag) -> assigned id; survives re-registration
        # (tag disambiguates nodes with no serving port, e.g. workers
        # registering with port 0 and tag "<party>.<rank>")
        self._assigned: Dict[Tuple[str, str, int, str], int] = {}
        self._roster: Dict[str, list] = {}   # role -> [(id, host, port)]
        self._next = {"server": KOFFSET, "worker": KOFFSET + 1,
                      "global_server": 8, "global_worker": 9,
                      # serving plane (gateways/replicas/registries):
                      # heartbeat-covered like every other role, id
                      # range far above the training tiers
                      "serve": 900}
        self._barriers: Dict[str, list] = {}
        # roster epoch (resilience/): bumps on every membership-visible
        # roster mutation — registration (fresh or recovery) and
        # eviction — so liveness consumers can order roster snapshots
        # and detect changes without diffing them
        self._epoch = 0
        self.heartbeats = HeartbeatMonitor(timeout_s=heartbeat_timeout)
        # key-range sharded global tier: the scheduler OWNS the
        # versioned shard map — clients fetch it here, failover
        # re-points a shard's address, and rebalance_shards moves range
        # boundaries from observed per-shard load (migrating the key
        # state shard-to-shard).  One rebalance at a time; the roster
        # lock is never held across the shard RPCs a rebalance performs.
        self._shard_map = None
        self._rebalance_lock = threading.Lock()
        # ---- durability: roster, id table and epoch persist through
        # the shared DurableStateStore, so a restarted scheduler hands
        # every re-registering node its OLD id (is_recovery) and the
        # epoch keeps counting instead of resetting under the liveness
        # plane.  The generation token rides every reply (the clients'
        # restart detector): the store's counter, else a fresh draw
        import random as _rnd
        self.generation = _rnd.getrandbits(31) | 1
        self._durable = None
        self._grace_until = 0.0
        from geomx_tpu_torch.resilience.durability import (
            DurableStateStore, durable_dir_from_env)
        ddir = durable_dir_from_env(durable_dir)
        restored = False
        if ddir:
            self._durable = DurableStateStore(ddir, "scheduler")
            self.generation = self._durable.bump_generation()
            restored = self._restore_durable()
            if restored and self.generation > 1:
                # re-registration grace window: live nodes whose
                # heartbeats predate the restart must not be mass-
                # evicted while they re-dial — seed their heartbeat
                # identities fresh AND hold the dead list shut until
                # the window passes
                if restart_grace_s is None:
                    restart_grace_s = _env(("GEOMX_RESTART_GRACE_S",),
                                           float(heartbeat_timeout), float)
                self._grace_until = time.monotonic() + \
                    max(0.0, float(restart_grace_s))
                for entries in self._roster.values():
                    for e in entries:
                        self.heartbeats.heartbeat(int(e[0]))

        self._started_monotonic = time.monotonic()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if bind_host is None:
            # graftlint: disable=GXL006 — host-plane knob
            bind_host = os.environ.get("GEOMX_PS_BIND_HOST", "127.0.0.1")
        # a restart onto the crashed predecessor's port races its
        # teardown — wait it out like a supervisor would
        from geomx_tpu_torch.service.server import GeoPSServer
        GeoPSServer._bind_with_retry(self._srv, bind_host, port)
        self._srv.listen(64)
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._conns: set = set()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)

        # ---- telemetry plane -------------------------------------------
        from geomx_tpu_torch.telemetry import get_registry
        reg = get_registry()
        self._m_epoch = reg.gauge(
            "geomx_scheduler_roster_epoch",
            "Roster epoch: bumps on every membership-visible mutation")
        self._m_nodes = reg.gauge(
            "geomx_scheduler_nodes",
            "Nodes currently in the roster, per role", ("role",))
        self._m_regs = reg.counter(
            "geomx_scheduler_registrations_total",
            "Node registrations handled (incl. recoveries)", ("role",))
        self._m_evicts = reg.counter(
            "geomx_scheduler_evictions_total",
            "Nodes evicted from the roster")
        self._m_barriers = reg.counter(
            "geomx_scheduler_barrier_releases_total",
            "Barrier groups released")
        self._m_hb = reg.counter(
            "geomx_scheduler_heartbeats_total",
            "Heartbeats received")
        self._m_req_s = reg.histogram(
            "geomx_scheduler_request_seconds",
            "Scheduler request handling latency")
        self._m_shard_ver = reg.gauge(
            "geomx_scheduler_shard_map_version",
            "Version of the scheduler-owned global shard map")
        self._m_rebalances = reg.counter(
            "geomx_scheduler_shard_rebalances_total",
            "Shard-map rebalances applied (boundary moves + migration)")
        self._m_failovers = reg.counter(
            "geomx_scheduler_shard_failovers_total",
            "Shard failovers applied (address re-points)")
        if self._shard_map is not None:
            self._m_shard_ver.set(self._shard_map.version)
        # build-info gauge (the Prometheus idiom for version labels:
        # constant 1, identity in the labels)
        import torch

        from geomx_tpu_torch import __version__
        self.build_info = {"version": __version__,
                           "torch_version": torch.__version__}
        reg.gauge("geomx_build_info",
                  "Constant 1; the build identity lives in the labels",
                  ("version", "torch_version")).labels(
            **self.build_info).set(1.0)
        # Prometheus scrape endpoint: explicit metrics_port wins, else
        # GEOMX_METRICS_PORT (0 = ephemeral), else no HTTP surface
        self._metrics_srv = None
        self.metrics_port: Optional[int] = None
        self.fleetscope = None   # set by _start_metrics_http when armed
        if metrics_port is None:
            # graftlint: disable=GXL006 — host-plane knob
            raw = os.environ.get("GEOMX_METRICS_PORT")
            if raw not in (None, ""):
                try:
                    metrics_port = int(raw)
                except ValueError:
                    raise ValueError(
                        f"Bad value for env var GEOMX_METRICS_PORT: {raw!r}")
        if metrics_port is not None:
            self._start_metrics_http(bind_host, int(metrics_port))
        if restored and self.generation > 1:
            self._announce_restart()

    # ---- durability --------------------------------------------------------

    def _announce_restart(self):
        from geomx_tpu_torch.resilience.durability import \
            record_host_restart
        record_host_restart(
            "scheduler", self.generation, "scheduler_restart",
            epoch=self._epoch,
            nodes=sum(len(v) for v in self._roster.values()))
        from geomx_tpu_torch.utils.profiler import get_profiler
        get_profiler().instant(
            "SchedulerRestart", "scheduler",
            args={"generation": self.generation, "epoch": self._epoch})

    def _durable_state_locked(self) -> dict:
        return {"assigned": [[list(k), v]
                             for k, v in self._assigned.items()],
                "roster": {r: [list(e) for e in v]
                           for r, v in self._roster.items()},
                "next": dict(self._next),
                "epoch": self._epoch,
                "shard_map": None if self._shard_map is None
                else self._shard_map.to_meta()}

    def _journal(self, rec: dict) -> None:
        """Append one roster mutation; caller holds self._lock.  The
        roster is tiny, so compaction is cheap and frequent."""
        if self._durable is None:
            return
        self._durable.append(rec)
        if self._durable.records_appended % 64 == 0:
            self._durable.compact(self._durable_state_locked())

    def _restore_durable(self) -> bool:
        snap, records = self._durable.load()
        if snap is None and not records:
            return False
        state = snap or {"assigned": [], "roster": {}, "next": {},
                         "epoch": 0}
        self._assigned = {tuple(k): int(v)
                          for k, v in state.get("assigned", [])}
        self._roster = {r: [tuple(e) for e in v]
                        for r, v in state.get("roster", {}).items()}
        self._next.update({k: int(v)
                           for k, v in state.get("next", {}).items()})
        self._epoch = int(state.get("epoch", 0))
        if state.get("shard_map") is not None:
            from geomx_tpu_torch.service.shardmap import ShardMap
            self._shard_map = ShardMap.from_meta(state["shard_map"])
        for rec in records:
            self._apply_durable_record(rec)
        return True

    def _apply_durable_record(self, rec: dict) -> None:
        kind = rec.get("k")
        if kind == "register":
            key = tuple(rec["key"])
            node_id = int(rec["id"])
            # an id claimed under a NEW key releases its old binding
            # (explicit prev_id recovery moved the identity)
            for k0, v0 in list(self._assigned.items()):
                if v0 == node_id and k0 != key:
                    del self._assigned[k0]
            self._assigned[key] = node_id
            role = key[0]
            entries = [e for e in self._roster.get(role, [])
                       if e[0] != node_id]
            entries.append(tuple(rec["entry"]))
            self._roster[role] = sorted(entries)
            self._next[role] = max(self._next.get(role, 0),
                                   node_id + 2)
            self._epoch = max(self._epoch, int(rec.get("epoch", 0)))
        elif kind == "evict":
            node = int(rec["node"])
            for role, entries in list(self._roster.items()):
                self._roster[role] = [e for e in entries
                                      if e[0] != node]
            for k0, v0 in list(self._assigned.items()):
                if v0 == node:
                    del self._assigned[k0]
            self._epoch = max(self._epoch, int(rec.get("epoch", 0)))
        elif kind == "shard_map":
            from geomx_tpu_torch.service.shardmap import ShardMap
            m = ShardMap.from_meta(rec["map"])
            if self._shard_map is None or m.version >= \
                    self._shard_map.version:
                self._shard_map = m

    def in_restart_grace(self) -> bool:
        """True while the post-restart re-registration grace window is
        open: the dead list stays shut so a restart cannot mass-evict
        live parties that simply haven't re-heartbeated yet."""
        return time.monotonic() < self._grace_until

    def _start_metrics_http(self, bind_host: Optional[str],
                            port: int) -> None:
        """Serve ``GET /metrics`` (Prometheus text exposition of the
        process-global registry), ``GET /healthz`` (:meth:`health_snapshot`
        as JSON), ``GET /ledger`` (the fleet round ledger) and ``GET
        /control`` (the control plane's decision log) from a daemon HTTP
        thread — the shared exporter the server's
        ``GEOMX_SERVER_METRICS_PORT`` surface runs too.  With
        ``GEOMX_FLEETSCOPE=1`` the fleet aggregator is colocated here
        (the one process that knows every node): ``GET /fleet`` serves
        its versioned document and its poller starts with the
        endpoint."""
        import json as _json

        from geomx_tpu_torch.telemetry.export import start_http_exporter

        def _control():
            # the bounded process-global log of applied actuations: what
            # the controller changed, when, and why
            from geomx_tpu_torch.control.actuators import get_decision_log
            log = get_decision_log()
            return (_json.dumps({
                "decisions": log.snapshot(),
                "total": log.total,
                "capacity": log.capacity}).encode("utf-8"),
                "application/json")

        routes = {"/control": _control}
        from geomx_tpu_torch.telemetry.fleetscope import \
            fleetscope_from_config
        self.fleetscope = fleetscope_from_config(self)
        if self.fleetscope is not None:
            routes["/fleet"] = self.fleetscope.document_route
        if bind_host is None:
            # graftlint: disable=GXL006 — host-plane knob
            bind_host = os.environ.get("GEOMX_PS_BIND_HOST", "127.0.0.1")
        self._metrics_srv = start_http_exporter(
            bind_host, port, health_fn=self.health_snapshot,
            routes=routes, thread_name="sched-metrics-http")
        self.metrics_port = self._metrics_srv.server_address[1]
        if self.fleetscope is not None:
            self.fleetscope.start()

    def _close_metrics_http(self) -> None:
        if self.fleetscope is not None:
            self.fleetscope.stop()
        if self._metrics_srv is None:
            return
        try:
            self._metrics_srv.shutdown()
            self._metrics_srv.server_close()
        except OSError:
            pass
        self._metrics_srv = None

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        try:
            self._srv.close()
        except OSError:
            pass
        if self._durable is not None:
            self._durable.close()
        self._close_metrics_http()

    def crash(self):
        """In-process emulation of a scheduler process death (chaos
        ``kill@...node=scheduler``): sever the listener AND every live
        connection abruptly so clients see exactly what a SIGKILL gives
        them.  Only the durable store survives; a replacement built on
        the same durable dir (and port) is the restart."""
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
        if self._durable is not None:
            self._durable.close()
        self._close_metrics_http()

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout)

    def health_snapshot(self) -> dict:
        """The ``GET /healthz`` body: roster epoch, per-role roster
        sizes, live/dead counts from the heartbeat monitor (none inside
        the restart grace window), the shard map's version and width,
        generation, uptime, the build identity and, when a gateway or
        replica registered in this process, the serving surface."""
        with self._lock:
            epoch = self._epoch
            roster = {role: len(nodes)
                      for role, nodes in sorted(self._roster.items())}
            by_id = {int(e[0]): (role, e)
                     for role, nodes in self._roster.items() for e in nodes}
            shard_map_version = None if self._shard_map is None \
                else self._shard_map.version
            num_shards = None if self._shard_map is None \
                else self._shard_map.num_shards
        alive = self.heartbeats.alive_nodes()
        dead = [] if self.in_restart_grace() \
            else self.heartbeats.dead_nodes()
        dead_nodes = []
        for nid in dead:
            role, e = by_id.get(int(nid), (None, None))
            dead_nodes.append({
                "id": int(nid), "role": role,
                "tag": (str(e[3]) if e is not None and len(e) > 3
                        else None)})
        out = {
            "status": "ok",
            "roster_epoch": epoch,
            "roster": roster,
            "live_parties": len(alive),
            "dead_parties": len(dead),
            "dead_node_ids": dead,
            "dead_nodes": dead_nodes,
            "restart_grace": self.in_restart_grace(),
            "shard_map_version": shard_map_version,
            "num_shards": num_shards,
            "generation": self.generation,
            "uptime_s": round(time.monotonic() - self._started_monotonic,
                              3),
            "build": dict(self.build_info),
        }
        # serving surface (serve/): published model versions, replica
        # freshness, infer queue depth — present only when a gateway/
        # replica registered in this process.  Lazy and best-effort: a
        # broken snapshot provider must never 500 the liveness probe
        try:
            from geomx_tpu_torch.serve import serving_surface
            serving = serving_surface()
            if serving is not None:
                out["serving"] = serving
        except Exception:
            pass
        return out

    # ---- key-range sharded global tier (scheduler-owned placement) ---------

    @staticmethod
    def _shard_cmd(addr, meta: dict, timeout: float = 60.0) -> dict:
        """One synchronous COMMAND round-trip to a shard server (the
        scheduler's admin line for range installs and key migration)."""
        sock = connect_retry(tuple(addr), total_timeout_s=15.0)
        try:
            sock.settimeout(timeout)
            msg = Msg(MsgType.COMMAND, meta=dict(meta))
            msg.meta.setdefault("rid", 0)
            send_frame(sock, msg)
            rep = recv_frame(sock)
            if rep is None:
                raise ConnectionError(f"shard {addr} closed")
            if rep.type == MsgType.ERROR:
                raise RuntimeError(rep.meta.get("error", "shard error"))
            return dict(rep.meta)
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def rebalance_shards(self, min_gain=None) -> dict:
        """Move range boundaries toward the observed load and migrate
        the affected key state.  Three phases, each safe against a
        client racing with a stale map:

        1. every shard's range shrinks to the INTERSECTION of its old
           and new range (version = new) — all moved segments are
           quiesced tier-wide: requests for them redirect, so no merge
           can land on a shard mid-migration;
        2. each moved segment's key state is COPIED from the old owner
           (``export_keys remove=False`` — including the open round's
           per-sender contributions), imported into the new owner, and
           only THEN dropped at the old owner (``drop_keys``) — a failed
           import between copy and drop leaves the keys intact on the
           quiesced loser, so a re-run of the rebalance (or the
           no-change range re-assert below) converges with nothing
           lost;
        3. every shard installs its final range, then the scheduler
           installs the bumped map.

        A client redirected during the window retries after a map
        re-fetch; its replayed pushes are idempotent under the migrated
        per-sender round counts.  ``min_gain`` defaults to
        ``GEOMX_SHARD_REBALANCE_MIN_GAIN`` (0.10).  Returns
        ``{"changed", "map", "moved_keys", "segments"}``."""
        from geomx_tpu_torch.service.shardmap import (moved_segments,
                                                      rebalance_bounds)
        if min_gain is None:
            min_gain = _env(("GEOMX_SHARD_REBALANCE_MIN_GAIN",), 0.10,
                            float)
        with self._rebalance_lock:
            with self._lock:
                cur = self._shard_map
            if cur is None:
                raise RuntimeError("no shard map installed")
            if cur.num_shards < 2:
                return {"changed": False, "map": cur.to_meta(),
                        "moved_keys": 0, "segments": 0}
            key_loads: dict = {}
            for i in range(cur.num_shards):
                load = self._shard_cmd(
                    cur.addr_of(i),
                    {"cmd": "shard_load", "reset": True})["load"]
                for k, c in dict(load.get("keys", {})).items():
                    key_loads[k] = key_loads.get(k, 0.0) + float(c)
            bounds = rebalance_bounds(cur, key_loads,
                                      min_gain=float(min_gain))
            if tuple(bounds) == tuple(cur.bounds):
                # no boundary move — but RE-ASSERT the current map's
                # ranges anyway: a rebalance that failed between its
                # quiesce and its final installs left shards holding
                # shrunk intersection ranges at a version the map never
                # reached, and this is the re-run that heals them
                for i in range(cur.num_shards):
                    lo, hi = cur.range_of(i)
                    self._shard_cmd(cur.addr_of(i), {
                        "cmd": "set_shard_range", "lo": lo, "hi": hi,
                        "version": cur.version})
                return {"changed": False, "map": cur.to_meta(),
                        "moved_keys": 0, "segments": 0}
            new = cur.with_bounds(bounds)
            segs = moved_segments(cur, new)
            # phase 1: quiesce every moved segment
            for i in range(new.num_shards):
                olo, ohi = cur.range_of(i)
                nlo, nhi = new.range_of(i)
                ilo, ihi = max(olo, nlo), min(ohi, nhi)
                if ilo >= ihi:
                    ilo = ihi = nlo  # disjoint: own nothing until ph. 3
                self._shard_cmd(new.addr_of(i), {
                    "cmd": "set_shard_range", "lo": ilo, "hi": ihi,
                    "version": new.version})
            # phase 2: migrate each quiesced segment — copy, import,
            # and only then drop
            moved = 0
            for lo, hi, old_owner, new_owner in segs:
                recs = self._shard_cmd(cur.addr_of(old_owner), {
                    "cmd": "export_keys", "lo": lo, "hi": hi,
                    "remove": False})["records"]
                if recs:
                    self._shard_cmd(new.addr_of(new_owner), {
                        "cmd": "import_keys", "records": dict(recs)})
                    self._shard_cmd(cur.addr_of(old_owner), {
                        "cmd": "drop_keys", "lo": lo, "hi": hi})
                moved += len(recs)
            # phase 3: final ranges, then the map
            for i in range(new.num_shards):
                nlo, nhi = new.range_of(i)
                self._shard_cmd(new.addr_of(i), {
                    "cmd": "set_shard_range", "lo": nlo, "hi": nhi,
                    "version": new.version})
            with self._lock:
                self._shard_map = new
                self._journal({"k": "shard_map", "map": new.to_meta()})
                self._m_shard_ver.set(new.version)
            self._m_rebalances.inc()
            from geomx_tpu_torch.utils.profiler import get_profiler
            get_profiler().instant(
                "ShardRebalance", "scheduler",
                args={"map_version": new.version, "moved_keys": moved,
                      "segments": len(segs)})
            return {"changed": True, "map": new.to_meta(),
                    "moved_keys": moved, "segments": len(segs)}

    # ---- service loop ------------------------------------------------------

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
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            self._serve_loop(conn)
        finally:
            # close actively (see GeoPSServer._serve_conn): a frame-
            # integrity drop must read as a dead socket on the peer
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            self._conns.discard(conn)

    def _serve_loop(self, conn: socket.socket):
        while True:
            try:
                msg = recv_frame(conn)
            except (OSError, pickle.UnpicklingError, ValueError):
                return
            if msg is None:
                return
            t0 = time.monotonic()
            try:
                if self._handle(conn, msg):
                    return
            except Exception as e:
                self._reply(conn, msg, Msg(MsgType.ERROR,
                                           meta={"error": repr(e)}))
            finally:
                # barrier waits park the CONNECTION, not this handler, so
                # the latency histogram measures real handling time
                self._m_req_s.observe(time.monotonic() - t0)

    def _reply(self, conn, req: Msg, reply: Msg):
        rid = req.meta.get("rid")
        if rid is not None:
            reply.meta["rid"] = rid
        # restart detector: same token discipline as GeoPSServer
        reply.meta.setdefault("gen", self.generation)
        send_frame(conn, reply)

    def _roster_gauges_locked(self) -> None:
        """Refresh the per-role node gauges (caller holds self._lock)."""
        for role, entries in self._roster.items():
            self._m_nodes.labels(role=role).set(len(entries))

    def _handle(self, conn, msg: Msg) -> bool:
        if msg.type == MsgType.HEARTBEAT:
            if msg.sender >= 0:
                self.heartbeats.heartbeat(msg.sender)
            self._m_hb.inc()
            self._reply(conn, msg, Msg(MsgType.ACK))
            return False
        if msg.type == MsgType.STOP:
            self._reply(conn, msg, Msg(MsgType.ACK))
            self.stop()
            return True
        if msg.type != MsgType.COMMAND:
            self._reply(conn, msg, Msg(MsgType.ERROR,
                                       meta={"error": f"bad {msg.type}"}))
            return False
        cmd = msg.meta.get("cmd")
        if cmd == "register":
            role = msg.meta["role"]
            host = msg.meta.get("host", "127.0.0.1")
            port = int(msg.meta.get("port", 0))
            tag = str(msg.meta.get("tag", ""))
            prev = msg.meta.get("prev_id")
            with self._lock:
                key = (role, host, port, tag)
                node_id = self._assigned.get(key)
                if node_id is None and prev is not None:
                    # explicit recovery claim (e.g. restarted on a new
                    # ephemeral port): take the old identity back
                    for k, v in list(self._assigned.items()):
                        if v == int(prev) and k[0] == role:
                            del self._assigned[k]
                            self._roster[role] = [
                                e for e in self._roster.get(role, [])
                                if e[0] != v]
                            node_id = int(prev)
                            break
                recovery = node_id is not None and any(
                    e[0] == node_id for e in self._roster.get(role, [])) \
                    or (node_id is not None and prev is not None)
                if node_id is None:
                    node_id = self._next[role]
                    self._next[role] += 2   # keep parity per role
                self._assigned[key] = node_id
                entries = [e for e in self._roster.setdefault(role, [])
                           if e[0] != node_id]
                entries.append((node_id, host, port, tag))
                self._roster[role] = sorted(entries)
                self._epoch += 1
                epoch = self._epoch
                self._journal({"k": "register", "key": list(key),
                               "id": node_id,
                               "entry": [node_id, host, port, tag],
                               "epoch": epoch})
                roster = {r: list(v) for r, v in self._roster.items()}
                self._roster_gauges_locked()
                # inside the lock: concurrent register/evict handlers
                # must publish epochs in bump order, or the scraped
                # gauge can regress behind the real epoch
                self._m_epoch.set(epoch)
            self._m_regs.labels(role=role).inc()
            from geomx_tpu_torch.utils.profiler import get_profiler
            get_profiler().instant(
                "SchedulerRegister", "scheduler",
                args={"node": node_id, "role": role, "epoch": epoch,
                      "recovery": bool(recovery)})
            self.heartbeats.heartbeat(node_id)
            self._reply(conn, msg, Msg(MsgType.ACK, meta={
                "node_id": node_id, "is_recovery": bool(recovery),
                "cluster": roster, "epoch": epoch}))
        elif cmd == "cluster":
            with self._lock:
                roster = {r: list(v) for r, v in self._roster.items()}
                epoch = self._epoch
            self._reply(conn, msg, Msg(MsgType.ACK,
                                       meta={"cluster": roster,
                                             "epoch": epoch}))
        elif cmd == "evict":
            # operator/controller-driven removal (resilience/): take the
            # node out of the roster AND the id table so discovery and
            # liveness stop counting it; a later return re-registers as
            # a fresh node (re-admission, not recovery)
            node = int(msg.meta["node"])
            with self._lock:
                evicted = False
                for role, entries in list(self._roster.items()):
                    kept = [e for e in entries if e[0] != node]
                    if len(kept) != len(entries):
                        self._roster[role] = kept
                        evicted = True
                for k, v in list(self._assigned.items()):
                    if v == node:
                        del self._assigned[k]
                if evicted:
                    self._epoch += 1
                    self._journal({"k": "evict", "node": node,
                                   "epoch": self._epoch})
                epoch = self._epoch
                self._roster_gauges_locked()
                if evicted:
                    self._m_epoch.set(epoch)  # in-lock: bump order
            if evicted:
                self._m_evicts.inc()
            from geomx_tpu_torch.utils.profiler import get_profiler
            get_profiler().instant(
                "SchedulerEvict", "scheduler",
                args={"node": node, "epoch": epoch,
                      "evicted": bool(evicted)})
            self.heartbeats.unregister(node)
            self._reply(conn, msg, Msg(MsgType.ACK, meta={
                "evicted": evicted, "epoch": epoch}))
        elif cmd == "barrier":
            group = str(msg.meta.get("group", ""))
            expect = int(msg.meta["expect"])
            with self._lock:
                waiters = self._barriers.setdefault(group, [])
                waiters.append((conn, msg.meta.get("rid")))
                if len(waiters) >= expect:
                    for c, rid in waiters:
                        rel = Msg(MsgType.BARRIER_RELEASE)
                        if rid is not None:
                            rel.meta["rid"] = rid
                        try:
                            send_frame(c, rel)
                        except OSError:
                            pass
                    self._barriers[group] = []
                    self._m_barriers.inc()
        elif cmd == "metrics":
            # the wire-protocol twin of GET /metrics: the same Prometheus
            # exposition, for clients already speaking COMMAND frames
            from geomx_tpu_torch.telemetry import render_prometheus
            self._reply(conn, msg, Msg(MsgType.ACK, meta={
                "text": render_prometheus()}))
        elif cmd == "num_dead_nodes":
            # restart grace: a freshly restored scheduler answers an
            # empty dead list until live nodes had time to re-dial —
            # otherwise one scheduler restart would read as a mass
            # party death to every liveness consumer
            dead = [] if self.in_restart_grace() else \
                self.heartbeats.dead_nodes(msg.meta.get("timeout"))
            self._reply(conn, msg, Msg(MsgType.ACK, meta={
                "dead": dead, "grace": self.in_restart_grace()}))
        elif cmd == "init_shard_map":
            # install the version-1 even-bounds map over the given shard
            # addresses.  Idempotent: a second init (a racing bring-up)
            # returns the installed map unchanged.
            from geomx_tpu_torch.service.shardmap import ShardMap
            with self._lock:
                if self._shard_map is None:
                    self._shard_map = ShardMap.initial(
                        (h, int(p)) for h, p in msg.meta["shards"])
                    self._journal({"k": "shard_map",
                                   "map": self._shard_map.to_meta()})
                    self._m_shard_ver.set(self._shard_map.version)
                m = self._shard_map.to_meta()
            self._reply(conn, msg, Msg(MsgType.ACK, meta={"map": m}))
        elif cmd == "shard_map":
            with self._lock:
                m = None if self._shard_map is None \
                    else self._shard_map.to_meta()
            self._reply(conn, msg, Msg(MsgType.ACK, meta={"map": m}))
        elif cmd == "shard_failover":
            # a shard missed its restart window: its journal replayed
            # into a replacement server on a NEW port — re-point the
            # map entry and bump the version so clients redirect
            idx = int(msg.meta["index"])
            host, port = msg.meta["host"], int(msg.meta["port"])
            with self._lock:
                if self._shard_map is None:
                    raise RuntimeError("no shard map installed")
                self._shard_map = self._shard_map.with_address(
                    idx, host, port)
                self._journal({"k": "shard_map",
                               "map": self._shard_map.to_meta()})
                self._m_shard_ver.set(self._shard_map.version)
                m = self._shard_map.to_meta()
            self._m_failovers.inc()
            from geomx_tpu_torch.utils.profiler import get_profiler
            get_profiler().instant(
                "ShardFailover", "scheduler",
                args={"shard": idx, "port": port,
                      "map_version": m["version"]})
            self._reply(conn, msg, Msg(MsgType.ACK, meta={"map": m}))
        elif cmd == "rebalance_shards":
            result = self.rebalance_shards(
                min_gain=msg.meta.get("min_gain"))
            self._reply(conn, msg, Msg(MsgType.ACK, meta=result))
        else:
            self._reply(conn, msg, Msg(MsgType.ERROR,
                                       meta={"error": f"bad cmd {cmd}"}))
        return False


class SchedulerClient:
    """A node's line to the scheduler: register, discover, barrier."""

    def __init__(self, addr: Tuple[str, int]):
        self._addr = addr
        self._sock = connect_retry(addr)
        self._lock = threading.Lock()
        self.node_id: Optional[int] = None
        self.is_recovery = False
        self.roster_epoch = 0   # last roster epoch seen (resilience/)
        # restart detection (generation token in every scheduler reply)
        self.scheduler_generation: Optional[int] = None
        self.saw_scheduler_restart = False
        self._hb_stop: Optional[threading.Event] = None
        self._hb_sock: Optional[socket.socket] = None

    def _rpc(self, msg: Msg, retry: bool = True) -> Msg:
        """One synchronous exchange.  ``retry=True`` (everything except
        barrier, which must not enter a group twice) re-dials a dead
        scheduler once — register/cluster/evict/heartbeat are
        idempotent, and a RESTARTED scheduler restored its roster from
        the durable store, so the retried call lands on continuous
        state (docs/resilience.md "Host-plane recovery")."""
        for attempt in (0, 1):
            try:
                with self._lock:
                    send_frame(self._sock, msg)
                    reply = recv_frame(self._sock)
                if reply is None:
                    raise ConnectionError("scheduler closed")
                break
            except (OSError, ConnectionError, ValueError,
                    pickle.UnpicklingError):
                if not retry or attempt:
                    raise
                from geomx_tpu_torch.service.retry import count_retry
                count_retry("scheduler_rpc")
                with self._lock:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = connect_retry(self._addr,
                                               total_timeout_s=15.0)
        gen = reply.meta.get("gen")
        if gen is not None:
            if self.scheduler_generation is not None \
                    and gen != self.scheduler_generation:
                self.saw_scheduler_restart = True
            self.scheduler_generation = gen
        if reply.type == MsgType.ERROR:
            raise RuntimeError(reply.meta.get("error", "scheduler error"))
        return reply

    def register(self, role: str, host: str = "127.0.0.1", port: int = 0,
                 tag: str = "", prev_id: Optional[int] = None) -> dict:
        reply = self._rpc(Msg(MsgType.COMMAND, meta={
            "cmd": "register", "role": role, "host": host, "port": port,
            "tag": tag,
            **({"prev_id": prev_id} if prev_id is not None else {})}))
        self.node_id = int(reply.meta["node_id"])
        self.is_recovery = bool(reply.meta["is_recovery"])
        self.roster_epoch = int(reply.meta.get("epoch", 0))
        return reply.meta

    def cluster(self) -> dict:
        reply = self._rpc(Msg(MsgType.COMMAND, meta={"cmd": "cluster"}))
        self.roster_epoch = int(reply.meta.get("epoch", self.roster_epoch))
        return dict(reply.meta["cluster"])

    def evict(self, node_id: int) -> dict:
        """Remove a node from the roster (resilience/): the scheduler
        bumps the roster epoch and forgets the node's heartbeat identity.
        Returns {"evicted": bool, "epoch": int}."""
        reply = self._rpc(Msg(MsgType.COMMAND,
                              meta={"cmd": "evict", "node": int(node_id)}))
        self.roster_epoch = int(reply.meta.get("epoch", self.roster_epoch))
        return {"evicted": bool(reply.meta.get("evicted")),
                "epoch": self.roster_epoch}

    def wait_for(self, role: str, count: int, timeout: float = 60.0,
                 tag: Optional[str] = None) -> list:
        """Poll the roster until `count` nodes of `role` (optionally with
        the given tag) registered; returns them sorted by node id."""
        import time
        deadline = time.monotonic() + timeout
        while True:
            entries = [e for e in self.cluster().get(role, [])
                       if tag is None or (len(e) > 3 and e[3] == tag)]
            if len(entries) >= count:
                return sorted(entries)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {len(entries)}/{count} {role} nodes registered")
            time.sleep(0.1)

    def barrier(self, group: str, expect: int,
                timeout: float = 120.0) -> None:
        old = self._sock.gettimeout()
        self._sock.settimeout(timeout)
        try:
            reply = self._rpc(Msg(MsgType.COMMAND, meta={
                "cmd": "barrier", "group": group, "expect": expect}),
                retry=False)  # re-entering a barrier would double-count
            if reply.type != MsgType.BARRIER_RELEASE:
                raise ConnectionError(f"barrier failed: {reply}")
        finally:
            self._sock.settimeout(old)

    def heartbeat(self) -> None:
        msg = Msg(MsgType.HEARTBEAT)
        msg.sender = self.node_id if self.node_id is not None else -1
        self._rpc(msg)

    def start_heartbeat(self, interval_s: Optional[float] = None
                        ) -> "SchedulerClient":
        """Run the node->scheduler heartbeat loop on a daemon thread (the
        reference Van::Heartbeat timer, van.cc:1147-1160) so the
        scheduler's cluster-wide dead-node detection sees this node live.
        Call after register(); close() stops it.  Interval defaults to
        GEOMX_HEARTBEAT_INTERVAL (PS_HEARTBEAT_INTERVAL alias) seconds."""
        if interval_s is None:
            interval_s = float(
                # graftlint: disable=GXL006 — host-plane knob
                os.environ.get("GEOMX_HEARTBEAT_INTERVAL")
                # graftlint: disable=GXL006 — host-plane knob
                or os.environ.get("PS_HEARTBEAT_INTERVAL") or "3")
        if self._hb_stop is not None:
            return self
        stop = self._hb_stop = threading.Event()
        node_id = self.node_id if self.node_id is not None else -1

        def run():
            # DEDICATED connection: the main socket's lock is held for the
            # whole of a blocking barrier() wait, which would starve the
            # heartbeat and get a live waiting node declared dead
            sock = None
            failures = 0
            while not stop.wait(interval_s):
                try:
                    if sock is None:
                        sock = connect_retry(self._addr,
                                             total_timeout_s=5.0)
                        sock.settimeout(10.0)
                        self._hb_sock = sock
                    msg = Msg(MsgType.HEARTBEAT)
                    msg.sender = node_id
                    send_frame(sock, msg)
                    if recv_frame(sock) is None:
                        raise ConnectionError("scheduler closed")
                    failures = 0
                except (OSError, ConnectionError, ValueError,
                        pickle.UnpicklingError):
                    # transient: reconnect next tick; give up only after
                    # sustained failure (scheduler genuinely gone)
                    try:
                        if sock is not None:
                            sock.close()
                    except OSError:
                        pass
                    sock = None
                    failures += 1
                    if failures > 10:
                        return
            try:
                if sock is not None:
                    sock.close()
            except OSError:
                pass
        threading.Thread(target=run, daemon=True,
                         name=f"sched-heartbeat-{node_id}").start()
        return self

    def dead_nodes(self, timeout: Optional[float] = None) -> list:
        """The scheduler's cluster-wide dead list (reference
        Postoffice::GetDeadNodes surfaced via the scheduler role)."""
        return list(self._rpc(Msg(MsgType.COMMAND, meta={
            "cmd": "num_dead_nodes", "timeout": timeout})).meta["dead"])

    def metrics_text(self) -> str:
        """The scheduler process's Prometheus exposition over the wire
        protocol (the COMMAND twin of its GET /metrics endpoint)."""
        return str(self._rpc(Msg(MsgType.COMMAND,
                                 meta={"cmd": "metrics"})).meta["text"])

    # ---- key-range sharded global tier ------------------------------------

    def init_shard_map(self, addrs) -> dict:
        """Install (idempotently) the version-1 even-bounds shard map
        over ``addrs`` = [(host, port), ...]; returns the map meta."""
        return dict(self._rpc(Msg(MsgType.COMMAND, meta={
            "cmd": "init_shard_map",
            "shards": [[h, int(p)] for h, p in addrs]})).meta["map"])

    def shard_map(self) -> Optional[dict]:
        """The current shard-map meta, or None before init."""
        m = self._rpc(Msg(MsgType.COMMAND,
                          meta={"cmd": "shard_map"})).meta.get("map")
        return None if m is None else dict(m)

    def wait_shard_map(self, timeout: float = 60.0,
                       min_version: int = 0) -> dict:
        """Poll until a map with ``version >= min_version`` is
        installed — the client-side half of a map-bump redirect."""
        deadline = time.monotonic() + timeout
        while True:
            m = self.shard_map()
            if m is not None and int(m["version"]) >= int(min_version):
                return m
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no shard map at version >= {min_version} within "
                    f"{timeout}s")
            time.sleep(0.05)

    def shard_failover(self, index: int, host: str, port: int) -> dict:
        """Re-point shard ``index`` at a replacement server (journal
        replayed on a new port); returns the bumped map meta."""
        return dict(self._rpc(Msg(MsgType.COMMAND, meta={
            "cmd": "shard_failover", "index": int(index),
            "host": host, "port": int(port)})).meta["map"])

    def rebalance_shards(self, min_gain: Optional[float] = None) -> dict:
        """Ask the scheduler to rebalance ranges from observed load;
        returns {"changed", "map", "moved_keys", "segments"}."""
        meta = {"cmd": "rebalance_shards"}
        if min_gain is not None:
            meta["min_gain"] = float(min_gain)
        return dict(self._rpc(Msg(MsgType.COMMAND, meta=meta)).meta)

    def stop_scheduler(self) -> None:
        try:
            # no retry: re-dialing a scheduler that just honored the
            # STOP would burn the whole connect window at teardown
            self._rpc(Msg(MsgType.STOP), retry=False)
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_sock is not None:
            try:
                self._hb_sock.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
