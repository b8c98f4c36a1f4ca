"""GeoPSServer — one PS tier as a process (port of
geomx_tpu/service/server.py).

Runs the role of the reference's KVStoreDistServer
(src/kvstore/kvstore_dist_server.h): accepts worker connections, merges
pushes per key, gates on the sync count, optionally applies a server-side
optimizer, and answers pulls.  Configured as a **local** server it also
acts as a client of a **global** server (the dual identity of reference
server nodes, ps.h:52-58): once its own workers' pushes are merged it
relays the aggregate up and refreshes its store from the global reply
before releasing its workers' pulls — the HiPS push-through
(DataPushToGlobalServers*, kvstore_dist_server.h:745-780).

Sync modes:
- "sync"  — wait for all expected workers each round (FSA tier);
- "async" — apply each push on arrival (MixedSync tier).

Compression: the upward hop can be compressed ("fp16" / "bsc,r"); BSC
payloads travel as (2k,) value+index vectors exactly like the reference's
wire buffers, decompressed here (server-side BSCDecompress).

The store, the merges and the wire stay numpy, as in the JAX package.
Two steps run on the server's ``device`` (``resolve_device``: the card
unless the caller passes ``"cpu"``): the relay compressor (BSC's
select/pack, a CUDA kernel on the card; a key's u/v stay there between
rounds) and a server-side optimizer other than the native SGD.

Configured with ``shard_range`` it is one shard of the key-range
sharded global tier (``sharded.py``): it owns a hash range of the keys,
redirects the rest, and exports, imports and drops key state when the
scheduler rebalances the ranges.

``durable_dir`` (``GEOMX_DURABLE_DIR``) arms the crash-recovery plane:
the key store, the per-sender merged-round counts, the optimizer config
and state and the eviction roster persist through an atomic-snapshot +
append-journal ``resilience.durability.DurableStateStore``.  A restarted
process replays to its last durable state, and every reply carries the
store's generation token so clients detect the restart and resume.  The
journal holds host bytes: a key's optimizer state goes through the
port's tree format (numpy leaves) and is put back on the server's device
at restore; the relay compressor's u/v likewise.

Telemetry (``telemetry/``): the fleet round ledger records every
round's merge, journal, relay and reply hops and its phases; a restart
is announced to the registry, the event log and the flight recorders;
``metrics_port``/``GEOMX_SERVER_METRICS_PORT`` serves ``GET /metrics``,
``/healthz`` and ``/ledger``, and the ``metrics`` command answers the
same Prometheus text over the wire.
"""

from __future__ import annotations

import itertools
import os
import pickle
import queue
import socket
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from geomx_tpu_torch.device import resolve_device
from geomx_tpu_torch.service.protocol import (BATCH_DRAIN_MAX_BYTES,
                                              BATCH_DRAIN_MAX_FRAMES, Msg,
                                              MsgType, _log_msg,
                                              _verbose_level,
                                              batch_drain_enabled, env_int,
                                              recv_frame, send_frame,
                                              should_drop, wire_stats)
from geomx_tpu_torch.tree import state_map
from geomx_tpu_torch.utils.heartbeat import HeartbeatMonitor


class _SparsePairs:
    """A compressed (value, index) contribution held WITHOUT densifying
    (docs/performance.md "Compressed-domain aggregation"): the global
    tier's sparse merge keeps per-sender pushes in this form and merges
    them by sorted-index at the round gate — O(k log k) host work per
    round instead of an O(n) densify per push."""

    __slots__ = ("vals", "idx", "n", "shape")

    def __init__(self, vals: np.ndarray, idx: np.ndarray, n: int, shape):
        self.vals = np.asarray(vals, np.float32).reshape(-1)
        self.idx = np.asarray(idx).reshape(-1).astype(np.int64)
        self.n = int(n)
        self.shape = tuple(shape)

    def densify(self) -> np.ndarray:
        from geomx_tpu_torch.compression.sparseagg import densify_pairs_host
        return densify_pairs_host(self.vals, self.idx,
                                  self.n).reshape(self.shape)


def _contrib_dense(c) -> np.ndarray:
    return c.densify() if isinstance(c, _SparsePairs) else c


class _KeyState:
    def __init__(self, value: np.ndarray):
        self._value = value.copy()
        # a sparse-merged round's OVERWRITE-pending (vals, idx) pair
        # set: the dense form materializes lazily on first dense read
        # (`value` property), so rounds whose only consumers pull
        # sparse never pay the O(n) densify
        self._sparse: "Optional[tuple]" = None
        # this round's per-sender contributions.  Kept SEPARATE (not a
        # running sum) so the round merge sums in sorted-sender order:
        # float addition is commutative but not associative, and at
        # 16+ parties an arrival-ordered running sum would make the
        # merged bits depend on thread scheduling — the many-party
        # bit-exact chaos gate (bench --compare-manyparty) and shard
        # migration both need arrival-order-independent merges.
        # Cost: up to num_workers gradients per key held for the open
        # round (vs one accumulated array before) — a deliberate
        # host-plane trade; key-range sharding divides it by the shard
        # count, and the buffers free at every round gate.
        self.contribs: Dict[int, np.ndarray] = {}
        self.count = 0
        self.round = 0            # completed merge rounds
        self.pushed: Dict[int, int] = {}   # sender -> rounds pushed
        self.waiting_pulls = []   # (conn, request Msg, round_needed)
        # HFA: last globally-agreed value (the reference's stored_milestone,
        # kvstore_dist_server.h:988-1017)
        self.milestone: Optional[np.ndarray] = None
        # a WAN relay for this key failed: its round can never complete,
        # so pulls that would wait on it must fail fast with the reason
        self.relay_error: Optional[str] = None
        # this round's row-sparse contributions, accumulated sparsely
        # (densified at most once, at the round gate)
        self.rs_rows: list = []
        self.rs_vals: list = []
        # fleet round ledger (telemetry/ledger.py): when the open round
        # started filling (monotonic — the gate-wait phase's zero), the
        # client round ids contributing to it (the ledger keys rounds
        # by the CLIENT's numbering, which survives re-routing), and
        # the ledger id of the last completed round (pull replies carry
        # it as meta["round"])
        self.open_t: Optional[float] = None
        self.open_rids: set = set()
        self.led_rid: Optional[int] = None
        # ALL client rounds the last gate close covered: after a crash
        # replay, a lost round's re-pushes legitimately coalesce with
        # the next round's fresh pushes into ONE merge (each gradient
        # still sums exactly once under the per-sender round dedup) —
        # the ledger attributes that merge to every round it closed
        self.led_rids: list = []

    @property
    def value(self) -> np.ndarray:
        if self._sparse is not None:
            from geomx_tpu_torch.compression.sparseagg import densify_pairs_host
            mvals, midx = self._sparse
            dense = densify_pairs_host(mvals, midx, self._value.size)
            self._value = dense.reshape(self._value.shape).astype(
                self._value.dtype, copy=False)
            self._sparse = None
        return self._value

    @value.setter
    def value(self, v: np.ndarray) -> None:
        self._value = v
        self._sparse = None

    @property
    def sparse_value(self) -> "Optional[tuple]":
        """(vals, idx) when the latest round is sparse-pending, else
        None.  Indices are unique and sorted; absent coordinates are
        zero (overwrite-store semantics)."""
        return self._sparse

    def set_sparse_value(self, mvals: np.ndarray, midx: np.ndarray) -> None:
        """Install a sparse-merged round as the store value without
        densifying (overwrite-mode stores only; `value` reads fold it
        lazily)."""
        self._sparse = (np.asarray(mvals, np.float32),
                        np.asarray(midx, np.int64))

    @property
    def dense_shape(self) -> tuple:
        return tuple(self._value.shape)

    @property
    def dense_size(self) -> int:
        return int(self._value.size)

    @property
    def dense_dtype(self) -> str:
        return self._value.dtype.str


class GeoPSServer:
    _next_gid = 1000
    _gid_lock = threading.Lock()

    def __init__(self, port: int = 0, num_workers: int = 1,
                 mode: str = "sync", optimizer=None,
                 global_addr: Optional[tuple] = None,
                 global_addrs: Optional[list] = None,
                 compression: Optional[str] = None,
                 heartbeat_timeout: float = 15.0,
                 accumulate: bool = False,
                 global_sender_id: Optional[int] = None,
                 rank: int = 0,
                 bind_host: Optional[str] = None,
                 auto_pull: Optional[bool] = None,
                 max_greed_rate: Optional[float] = None,
                 hfa_k2: Optional[int] = None,
                 num_global_workers: int = 1,
                 bigarray_bound: Optional[int] = None,
                 inter_ts: Optional[bool] = None,
                 global_ts_node: Optional[int] = None,
                 durable_dir: Optional[str] = None,
                 durable_name: Optional[str] = None,
                 reconnect: Optional[bool] = None,
                 shard_range: Optional[tuple] = None,
                 shard_index: Optional[int] = None,
                 shard_map_version: int = 0,
                 metrics_port: Optional[int] = None,
                 device=None):
        """``accumulate=True`` makes the no-optimizer store add pushes into
        the value instead of overwriting it — the ps-lite default server
        handle (KVServerDefaultHandle), used by its micro-tests; overwrite
        is the GeoMX local-tier behavior (CopyFromTo merged->store).

        ``reconnect`` arms the session-resume handshake on this
        server's OWN upstream clients (the WAN relay to the global tier).

        ``shard_range=(lo, hi)`` makes this server ONE SHARD of a
        key-range sharded global tier: it owns keys with
        ``lo <= key_hash(key) < hi`` and answers any other key with a
        ``wrong_shard`` redirect carrying ``shard_map_version`` — a
        client holding a stale map re-fetches the scheduler's map
        instead of merging into the wrong store.  The range/version can
        be updated live (``set_shard_range``) and key state migrates
        between shards via ``export_keys``/``import_keys`` (the
        scheduler's rebalance drives both).

        ``durable_dir`` (``GEOMX_DURABLE_DIR``) arms the crash-recovery
        plane (module docstring) in a store named ``durable_name``
        (default ``ps_server_r<rank>``).

        ``device``: where the relay compressor and a non-native
        server-side optimizer run (``resolve_device``: the card unless
        ``"cpu"``).  ``metrics_port`` (default
        ``GEOMX_SERVER_METRICS_PORT``; unset or 0 disables, an explicit 0
        binds an ephemeral port) serves ``GET /metrics``, ``/healthz``
        and ``/ledger`` (``telemetry/export.py``)."""
        self.device = resolve_device(device)
        self.num_workers = num_workers
        self.mode = mode
        self.accumulate = accumulate
        # HFA at the PS tier (reference kvstore_dist_server.h:988-1017,
        # 1327-1346): workers push party-averaged *parameters* every K1
        # local steps; the local server applies every merge so pulls stay
        # fresh, and only every K2-th completed round crosses the WAN,
        # relaying the milestone delta (store - milestone)/num_global_workers
        # — the reference's stored/stored_milestone scheme.  K1, the
        # local-step period, lives in the workers' loop.  ``hfa_k2=None``
        # disables HFA; any value >= 1 enables it (K2=1 still means
        # param-push semantics, just with every local sync crossing the WAN).
        self.hfa_k2 = None if hfa_k2 is None else max(1, int(hfa_k2))
        # global-tier width (the reference's NumGlobalWorkers) for the HFA
        # delta pre-division
        self.num_global_workers = max(1, int(num_global_workers))
        self._tx = optimizer
        self._tx_config = None
        self._native_sgd = None
        self._opt_state: Dict[str, Any] = {}
        self._store: Dict[str, _KeyState] = {}
        self._lock = threading.Lock()
        self._barrier_waiters = []
        self._stops = 0
        # set when stop() has fully completed (incl. forwarding STOP up
        # the tier); join() gates on it so the process cannot exit with
        # the forward half-done (see stop())
        self._stop_done = threading.Event()
        self._seen_pushes: Dict[Any, bool] = {}
        # MultiGPS placement per key: key -> (owner, bounds); bounds is a
        # cumulative split across all global servers for big tensors,
        # None for hash-placed whole tensors
        self._gplace: Dict[str, tuple] = {}
        # P3 reassembly buffers: (sender, key) -> partial state for an
        # in-flight chunked push (server side of kvstore_dist.h:835-872)
        self._p3_partial: Dict[Any, dict] = {}
        # best-effort DGT pushes awaiting their deadline: (sender, key)
        # -> {round, required_got, num_required, timer}
        self._dgt_pending: Dict[Any, dict] = {}
        # arrival order of (sender, key, chunk) — TCP preserves the
        # client's send order, so tests/demos can assert P3 interleaving
        self.push_log: list = []
        # sender ids removed from the sync gate (resilience/): guards
        # against double-eviction shrinking the gate twice for one death
        self._evicted: set = set()
        self.heartbeats = HeartbeatMonitor(timeout_s=heartbeat_timeout)
        self.rank = rank
        self._conn_wlocks: Dict[int, threading.Lock] = {}
        self._conns: set = set()
        # TSEngine AutoPull (reference ENABLE_INTRA_TS, van.cc:447-454):
        # after each sync round the server pushes the fresh value to
        # registered workers in throughput-scheduled order instead of
        # waiting for their pulls (DefaultAutoPull -> AutoPullUpdate,
        # kvstore_dist_server.h:1372-1395, kv_app.h:658-691)
        if auto_pull is None:
            # graftlint: disable=GXL006 — host-plane knob
            auto_pull = bool(int(os.environ.get(
                "GEOMX_ENABLE_INTRA_TS",
                # graftlint: disable=GXL006 — host-plane knob
                os.environ.get("ENABLE_INTRA_TS", "0")) or 0))
        self.ts_sched = None
        if auto_pull:
            from geomx_tpu_torch.transport.tsengine import TSEngineScheduler
            if max_greed_rate is None:
                # graftlint: disable=GXL006 — host-plane knob
                max_greed_rate = float(os.environ.get(
                    "GEOMX_MAX_GREED_RATE",
                    # graftlint: disable=GXL006 — host-plane knob
                    os.environ.get("MAX_GREED_RATE_TS", "0.9")) or 0.9)
            self.ts_sched = TSEngineScheduler(num_workers,
                                              max_greed_rate=max_greed_rate,
                                              seed=rank)
        # TSEngine push-side (ASK1) scheduler: pairs nodes holding ready
        # partials into a relay-merge tree with this server as sink 0
        # (van.cc:1238-1296).  On whenever intra- or inter-TS is enabled —
        # the worker tier and the global tier run the same machinery.
        self.ts_push_sched = None
        if auto_pull or env_int(("GEOMX_ENABLE_INTRA_TS",
                                 "ENABLE_INTRA_TS"), 0) \
                or env_int(("GEOMX_ENABLE_INTER_TS", "ENABLE_INTER_TS"), 0):
            from geomx_tpu_torch.transport.tsengine import TSEngineScheduler
            self.ts_push_sched = TSEngineScheduler(num_workers + 1,
                                                   seed=100 + rank)
        self._ts_nodes: Dict[int, dict] = {}   # ts node id -> conn/addr
        self._ap_conns: Dict[int, Any] = {}   # scheduler index -> conn
        self._ap_ids: Dict[int, int] = {}     # sender id -> scheduler index
        self._ap_queue: "queue.Queue" = queue.Queue()
        self._ap_thread: Optional[threading.Thread] = None
        # WAN relay workers: a bounded pool of FIFO shards with key-hash
        # affinity — all of a key's jobs land on one shard (round order
        # preserved) while distinct keys mostly proceed independently, so
        # a straggler party's barrier on one key doesn't serialize the
        # rest (the reference's per-key engine-async push-through) — see
        # _relay_loop.  Lazily spawned; guarded by self._lock.
        self._relay_shards = 8
        self._relay_qs: Dict[int, "queue.Queue"] = {}
        # P3 pull-side chunking (reference P3_ZPull, kv_app.h:246-306):
        # big PULL replies leave through a per-connection PRIORITY queue
        # as chunk messages, so a front-layer reply overtakes a queued
        # back-layer reply on the return path.  Gates are test hooks
        # (pause_pull_stream command) making the reorder deterministic.
        self._out_qs: Dict[int, Any] = {}
        self._out_gates: Dict[int, threading.Event] = {}
        # serializes queue creation against connection teardown so a
        # completion thread can't install a queue for a conn whose serve
        # thread is mid-cleanup (stale-queue / id-reuse hazard)
        self._outq_lock = threading.Lock()
        self._pull_gen = itertools.count(1)
        # remotely-controllable profiler (reference kSetProfilerParams,
        # kvstore_dist_server.h:383-430)
        from geomx_tpu_torch.utils.profiler import Profiler
        self.profiler = Profiler(rank=rank)
        # telemetry plane (docs/telemetry.md): per-rank series in the
        # process-global registry, children bound once here so the push
        # hot path pays a method call, not a label lookup
        from geomx_tpu_torch.telemetry import get_registry
        _reg = get_registry()
        _r = str(rank)
        self._m_pushes = _reg.counter(
            "geomx_server_pushes_total",
            "PUSH messages merged or relayed", ("rank",)).labels(_r)
        self._m_pulls = _reg.counter(
            "geomx_server_pulls_total",
            "PULL requests answered or parked", ("rank",)).labels(_r)
        self._m_rounds = _reg.counter(
            "geomx_server_rounds_total",
            "Completed sync rounds (per key)", ("rank",)).labels(_r)
        self._m_relay_fail = _reg.counter(
            "geomx_server_relay_failures_total",
            "WAN relays that failed terminally", ("rank",)).labels(_r)
        self._m_relay_s = _reg.histogram(
            "geomx_server_relay_seconds",
            "WAN relay round-trip (push-through + pull-back)",
            ("rank",)).labels(_r)
        self._m_evictions = _reg.counter(
            "geomx_server_evictions_total",
            "Workers evicted from the sync gate", ("rank",)).labels(_r)
        self._m_workers = _reg.gauge(
            "geomx_server_num_workers",
            "Current sync-gate width", ("rank",)).labels(_r)
        self._m_workers.set(num_workers)
        self._m_sparse_merges = _reg.counter(
            "geomx_server_sparse_merges_total",
            "Rounds merged in the compressed (value, index) domain",
            ("rank",)).labels(_r)

        # ---- key-range sharding: owned hash range + the map version
        # redirects carry, plus the windowed load counters the
        # scheduler's rebalance reads (per-key push counts since the last
        # window reset — observation-driven placement)
        self._shard_range = None if shard_range is None else \
            (int(shard_range[0]), int(shard_range[1]))
        self.shard_index = shard_index
        self.shard_map_version = int(shard_map_version)
        self._load_pushes = 0
        self._load_pulls = 0
        self._load_key_pushes: Dict[str, int] = {}
        self._m_shard_ver = _reg.gauge(
            "geomx_shard_map_version",
            "Shard-map version this server last installed",
            ("rank",)).labels(_r)
        self._m_shard_keys = _reg.gauge(
            "geomx_shard_keys",
            "Keys currently owned by this server/shard",
            ("rank",)).labels(_r)
        self._m_shard_ver.set(self.shard_map_version)

        # MultiGPS: N global servers with reference placement (hash small
        # tensors whole, split big ones across all servers —
        # kvstore_dist.h:792-833, kvstore_dist_server.h:1786-1826)
        if global_addrs is None:
            global_addrs = [global_addr] if global_addr is not None else []
        self._global_addrs = list(global_addrs)
        self._gclients: list = []
        if bigarray_bound is None:
            bigarray_bound = env_int(("GEOMX_BIGARRAY_BOUND",
                                      "MXNET_KVSTORE_BIGARRAY_BOUND"),
                                     1_000_000)
        self.bigarray_bound = int(bigarray_bound)
        # this server's identity at the global tier (the reference's second
        # node identity my_node_global_, van.h:100); must be unique per party
        if global_sender_id is None:
            with GeoPSServer._gid_lock:
                global_sender_id = GeoPSServer._next_gid
                GeoPSServer._next_gid += 1
        self._global_sender_id = global_sender_id
        # inter-party TSEngine (ENABLE_INTER_TS): this server joins the
        # global tier's ASK1 relay overlay as node `global_ts_node`
        # (default: its rank, which dist_ps assigns as 1+party_id), so
        # party aggregates relay-merge across parties before the sink.
        # Requires a single uncompressed global link (relay merges are
        # additive sums).
        if inter_ts is None:
            inter_ts = bool(env_int(("GEOMX_ENABLE_INTER_TS",
                                     "ENABLE_INTER_TS"), 0))
        if inter_ts and compression is not None:
            import warnings
            warnings.warn(
                "ENABLE_INTER_TS requires an uncompressed global link "
                "(relay merges are additive sums); running the PLAIN "
                "direct topology instead. Drop the compression spec to "
                "get the inter-party relay overlay.", RuntimeWarning,
                stacklevel=2)
        self.inter_ts = inter_ts and compression is None
        # DGT on the WAN hop (the reference's DataPushToGlobalServers ->
        # DGT_Send path): uncompressed dense relays go through the global
        # client's contribution-ranked block scheduler
        self.enable_dgt = bool(env_int(("GEOMX_ENABLE_DGT", "ENABLE_DGT"),
                                       0)) and compression is None
        self._global_ts_node = global_ts_node if global_ts_node is not None \
            else max(1, rank)
        self._ground: Dict[str, int] = {}   # key -> global rounds joined
        self._compressor = None
        if compression:
            from geomx_tpu_torch.compression import get_compressor
            self._compressor = get_compressor(compression)
            self._comp_state: Dict[str, Any] = {}

        # ---- durability -------------------------------------------------
        # generation token: changes on every process start, rides every
        # reply.  Without a durable dir it is a fresh random draw (so
        # clients still DETECT a restart, they just cannot resume state);
        # with one it is the store's persisted monotone counter.
        import random as _rnd
        self.generation = _rnd.getrandbits(31) | 1
        self._durable = None
        self._journal_since_compact = 0
        from geomx_tpu_torch.resilience.durability import (
            DurableStateStore, durable_dir_from_env)
        ddir = durable_dir_from_env(durable_dir)
        if ddir:
            self._durable = DurableStateStore(
                ddir, durable_name or f"ps_server_r{rank}")
            self.generation = self._durable.bump_generation()
            self._restore_durable()
            if self.generation > 1:
                self._announce_restart()
        self._upstream_reconnect = reconnect

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # loopback by default (pseudo-distributed); multi-host deployments
        # bind all interfaces via bind_host="0.0.0.0" or GEOMX_PS_BIND_HOST
        if bind_host is None:
            # graftlint: disable=GXL006 — host-plane knob
            bind_host = os.environ.get("GEOMX_PS_BIND_HOST", "127.0.0.1")
        self._bind_with_retry(self._srv, bind_host, port)
        self._srv.listen(64)
        # a blocked accept() is not reliably woken by close() on Linux, so
        # poll with a short timeout and re-check _running
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        # HTTP observability surface (the scheduler's routes, so fleet
        # scrapers need not speak the wire's metrics command):
        # GET /metrics + /healthz + /ledger
        self._metrics_srv = None
        self.metrics_port: Optional[int] = None
        if metrics_port is None:
            mp = env_int(("GEOMX_SERVER_METRICS_PORT",), 0)
            metrics_port = mp if mp > 0 else None
        if metrics_port is not None:
            from geomx_tpu_torch.telemetry.export import start_http_exporter
            self._metrics_srv = start_http_exporter(
                bind_host, int(metrics_port),
                health_fn=self.health_snapshot,
                thread_name=f"ps-metrics-http-r{rank}")
            self.metrics_port = self._metrics_srv.server_address[1]
        self._start_unix = time.time()

    @staticmethod
    def _bind_with_retry(srv: socket.socket, host: str, port: int,
                         window_s: float = 5.0) -> None:
        """Bind, retrying EADDRINUSE for a short window when the port is
        EXPLICIT: a restart onto a crashed predecessor's port races the
        old socket's teardown (and TIME_WAIT), and a supervisor-style
        replacement should wait it out instead of dying."""
        import errno
        deadline = time.monotonic() + window_s
        while True:
            try:
                srv.bind((host, port))
                return
            except OSError as e:
                if port == 0 or e.errno != errno.EADDRINUSE \
                        or time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)

    def health_snapshot(self) -> dict:
        """The ``GET /healthz`` body (the scheduler's shape): role
        identity, sync-gate width, shard range/map version, store size,
        durable generation, uptime and build identity."""
        from geomx_tpu_torch import __version__ as _ver
        with self._lock:
            out = {
                "status": "ok" if self._running else "stopping",
                "role": "ps_server",
                "rank": self.rank,
                "mode": self.mode,
                "num_workers": self.num_workers,
                "num_keys": len(self._store),
                "evicted": sorted(self._evicted),
                "generation": self.generation,
                "durable": self._durable is not None,
                "uptime_s": round(time.time() - self._start_unix, 3),
                "version": _ver,
            }
            if self._shard_range is not None:
                out.update({"shard_index": self.shard_index,
                            "shard_lo": self._shard_range[0],
                            "shard_hi": self._shard_range[1],
                            "map_version": self.shard_map_version})
        return out

    def _close_metrics_http(self) -> None:
        if self._metrics_srv is None:
            return
        try:
            self._metrics_srv.shutdown()
            self._metrics_srv.server_close()
        except OSError:
            pass
        self._metrics_srv = None

    # ---- lifecycle ---------------------------------------------------------

    def start(self):
        self._g_autopull = False
        if self._global_addrs:
            from geomx_tpu_torch.service.client import GeoPSClient
            ts = self.inter_ts and len(self._global_addrs) == 1
            if self.inter_ts and not ts:
                import warnings
                warnings.warn(
                    "ENABLE_INTER_TS does not compose with MultiGPS "
                    f"({len(self._global_addrs)} global servers): the "
                    "ASK1 overlay aggregates whole tensors, which "
                    "conflicts with sharded global placement; running "
                    "the PLAIN direct topology instead. Use a single "
                    "global server for the inter-party relay overlay.",
                    RuntimeWarning, stacklevel=2)
            self._gclients = [
                GeoPSClient(addr, sender_id=self._global_sender_id,
                            ts_node=self._global_ts_node if ts else None,
                            reconnect=self._upstream_reconnect)
                for addr in self._global_addrs]
            for c in self._gclients:
                # a RESTARTED local server must resume its global push
                # round ids where its dead incarnation left off, or the
                # round-dedup would absorb all its future relays
                c.recover()
            if ts:
                # inter-party pull-side dissemination (the reference's
                # global AutoPull, kv_app.h:586-691): register for
                # server-initiated updates so fresh params come DOWN in
                # the global tier's throughput-scheduled order instead of
                # per-party min_round-gated pulls.  A global tier started
                # without auto_pull declines; we fall back to gated pulls.
                try:
                    self._gclients[0]._request(Msg(
                        MsgType.COMMAND,
                        meta={"cmd": "register_autopull"}))
                    self._g_autopull = True
                except (RuntimeError, ConnectionError, TimeoutError):
                    self._g_autopull = False
        self._accept_thread.start()
        if self.ts_sched is not None:
            self._ap_thread = threading.Thread(target=self._autopull_loop,
                                               daemon=True)
            self._ap_thread.start()
        return self

    def stop(self, forward: bool = True):
        """``forward=False`` detaches from the global tier WITHOUT
        sending kStopServer up — the rolling-restart/crash case, where a
        replacement server will re-register under the same identity.

        stop() usually runs on a daemon handler thread (the worker-STOP
        path).  Closing the listen socket below unblocks join() in the
        MAIN thread, which may then exit the process and kill this
        daemon thread before the STOP-forward loop finishes — the
        global tier then waits for a stop that died mid-loop and
        strands past any launcher deadline (seen: one global server
        of two received a single STOP).  join() therefore also gates on
        _stop_done, set in the ``finally`` here."""
        try:
            self._stop_impl(forward)
        finally:
            self._stop_done.set()

    def _stop_impl(self, forward: bool):
        self._running = False
        self._close_metrics_http()
        with self._lock:
            for q in self._relay_qs.values():
                q.put(None)
        try:
            self._srv.close()
        except OSError:
            pass
        # drop live worker connections so their clients fail fast instead
        # of waiting on a server that will never answer.  shutdown() (not
        # just close()) is required: the serve thread blocked in recv holds
        # the fd open, so close() alone would never send the FIN
        for c in list(self._conns):
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for c in self._gclients:
            ok = not forward
            if forward:
                try:
                    ok = c.stop_server()
                except Exception:
                    ok = False
            if forward and not ok:
                # the STOP timed out in (or never left) a send queue the
                # close() below will discard — without it the global tier
                # strands listening past any launcher deadline (seen:
                # global_server 0 hung after a lost stop).  Retry once on
                # a bare short-timeout socket with the frame written
                # directly — no send queue to lose it in, no bring-up
                # retry loop to stall THIS server's shutdown if the
                # global already exited.  A duplicate STOP is safe: the
                # stop counter can only over-count at shutdown time.
                try:
                    retry = socket.create_connection(c.addr, timeout=2.0)
                    retry.settimeout(5.0)
                    send_frame(retry, Msg(MsgType.STOP,
                                          sender=c.sender_id))
                    recv_frame(retry)  # best-effort ACK read
                    retry.close()
                except Exception:
                    pass
            try:
                c.close()
            except OSError:
                pass

    def crash(self):
        """In-process emulation of a process death (the chaos ``kill@``
        verb / SIGKILL): sever every socket abruptly — no STOP forward,
        no drains, no graceful anything.  Whatever was only in memory
        (the open round's partial merges) is lost; only the durable
        store survives, exactly as for a real kill.  A replacement
        server constructed on the same durable dir (and port) is the
        restart."""
        self._running = False
        self._close_metrics_http()
        with self._lock:
            for q in self._relay_qs.values():
                q.put(None)
        for sock in [self._srv] + list(self._conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for c in self._gclients:
            try:
                c.close()
            except OSError:
                pass
        if self._durable is not None:
            self._durable.close()
        self._stop_done.set()

    def join(self, timeout: Optional[float] = None):
        self._accept_thread.join(timeout)
        if not self._running:
            # a stop() is in flight (likely on a daemon handler thread):
            # wait for its forward/teardown to finish before letting the
            # caller exit the process.  Bounded so a stop() wedged in a
            # remote send can never hang the host process forever.
            self._stop_done.wait(timeout if timeout is not None else 60.0)

    # ---- durability (atomic snapshot + append journal) ---------------------

    def _announce_restart(self):
        """Restored from a durable dir with generation > 1: this is a
        restart.  Publish it (restart counter, generation gauge, the
        host-plane incident for the flight recorders and the event log,
        a profiler instant)."""
        from geomx_tpu_torch.resilience.durability import \
            record_host_restart
        record_host_restart(f"server_r{self.rank}", self.generation,
                            "server_restart", rank=self.rank,
                            keys=len(self._store))
        self.profiler.instant("ServerRestart", "kvstore",
                              args={"rank": self.rank,
                                    "generation": self.generation,
                                    "keys": len(self._store)})

    def _opt_blob(self, key: str) -> Optional[bytes]:
        """A key's optimizer state as a host-tree blob (the port's
        ``utils/checkpoint.tree_to_bytes``: tensors moved to numpy), the
        ``opt`` field of a journal or migration record.  None without a
        factory optimizer (the native SGD's state handle is not
        serializable, as in the JAX package)."""
        if self._tx is None or key not in self._opt_state:
            return None
        from geomx_tpu_torch.utils.checkpoint import tree_to_bytes
        return tree_to_bytes(self._opt_state[key])

    def _comp_host(self, key: str, st: "_KeyState"):
        """The relay compressor's state of a key as host arrays in the
        value's shape (the JAX record's layout), or None."""
        if self._compressor is None:
            return None
        comp = self._comp_state.get(key)
        if not comp:
            return comp
        return tuple(a.detach().cpu().numpy().reshape(st.dense_shape)
                     for a in comp)

    def _key_record(self, key: str, st: _KeyState) -> dict:
        sp = st.sparse_value
        if sp is not None:
            # journal the sparse-pending round AS PAIRS: the write-ahead
            # record stays O(k), matching the merge's cost — replay
            # densifies once (restore is rare, rounds are not)
            value = {"__sparse__": True, "vals": sp[0], "idx": sp[1],
                     "shape": list(st.dense_shape),
                     "dtype": st.dense_dtype}
        else:
            value = st.value
        return {"value": value, "round": st.round,
                "pushed": dict(st.pushed), "milestone": st.milestone,
                "opt": self._opt_blob(key),
                "comp": self._comp_host(key, st)}

    @staticmethod
    def _decode_value_record(val) -> np.ndarray:
        """Inverse of the `_key_record` value field: a sparse round
        record densifies here (restore time only)."""
        if isinstance(val, dict) and val.get("__sparse__"):
            from geomx_tpu_torch.compression.sparseagg import \
                densify_pairs_host
            n = int(np.prod(val["shape"])) or 1
            dense = densify_pairs_host(val["vals"], val["idx"], n)
            return dense.reshape(val["shape"]).astype(
                np.dtype(val.get("dtype", "<f4")), copy=False)
        return np.asarray(val)

    def _journal(self, rec: dict) -> None:
        """Append one journal record; caller holds self._lock (or runs
        pre-start).  Folds the journal into a fresh snapshot every
        GEOMX_DURABLE_COMPACT records (256) OR once it outgrows
        GEOMX_DURABLE_COMPACT_BYTES (64 MiB) — round records carry the
        full key value + optimizer tree (replay needs no delta algebra),
        so byte growth, not record count, bounds big-key deployments."""
        if self._durable is None:
            return
        self._durable.append(rec)
        self._journal_since_compact += 1
        if self._journal_since_compact >= env_int(
                ("GEOMX_DURABLE_COMPACT",), 256) or \
                self._durable.journal_bytes() >= env_int(
                    ("GEOMX_DURABLE_COMPACT_BYTES",), 64 * 1024 * 1024):
            self._durable.compact(self._durable_state_locked())
            self._journal_since_compact = 0

    def _journal_round(self, key: str, st: _KeyState) -> None:
        """One completed merge round -> one durable record.  Called
        BEFORE the round's pull replies go out (write-ahead: a value a
        client may already have seen is always recoverable)."""
        if self._durable is None:
            return
        rec = {"k": "round", "key": key}
        rec.update(self._key_record(key, st))
        self._journal(rec)

    def _durable_state_locked(self) -> dict:
        return {"keys": {key: self._key_record(key, st)
                         for key, st in self._store.items()},
                "num_workers": self.num_workers,
                "evicted": sorted(self._evicted),
                "tx_config": self._tx_config,
                "shard_range": None if self._shard_range is None
                else list(self._shard_range),
                "map_version": self.shard_map_version}

    def _apply_durable_key(self, key: str, rec: dict) -> None:
        value = self._decode_value_record(rec["value"])
        st = self._store.get(key)
        if st is None:
            st = self._store[key] = _KeyState(value)
        st.value = value.copy()
        st.round = int(rec.get("round", 0))
        st.pushed = {int(s): int(n)
                     for s, n in dict(rec.get("pushed", {})).items()}
        st.milestone = None if rec.get("milestone") is None \
            else np.asarray(rec["milestone"]).copy()
        st.contribs, st.count = {}, 0
        st.rs_rows, st.rs_vals = [], []
        blob = rec.get("opt")
        if blob is not None and self._tx is not None:
            # host bytes in the journal, back on the server's device
            from geomx_tpu_torch.utils.checkpoint import tree_from_bytes
            self._opt_state[key] = tree_from_bytes(
                blob, target=self._opt_init(st.value))
        elif self._tx is not None and key not in self._opt_state:
            self._opt_state[key] = self._opt_init(st.value)
        if self._compressor is not None:
            comp = rec.get("comp")
            self._comp_state[key] = tuple(
                self._to_device(a).reshape(-1) for a in comp) \
                if comp else self._comp_init(st.value)

    def _restore_durable(self) -> None:
        """Replay snapshot + journal into the in-memory store: the
        restarted process resumes at its last DURABLE state (every
        completed merge round).  The round that was in flight at the
        crash is gone from memory by design — its pushers detect the
        new generation and idempotently re-push it (session resume),
        which re-opens the round."""
        snap, records = self._durable.load()
        state = snap or {"keys": {}, "num_workers": None,
                         "evicted": [], "tx_config": None}
        # fold journal records into the snapshot state first, so
        # optimizer config lands before per-key opt blobs decode
        for rec in records:
            kind = rec.get("k")
            if kind in ("init", "round"):
                state["keys"][rec["key"]] = {
                    f: rec.get(f) for f in ("value", "round", "pushed",
                                            "milestone", "opt", "comp")}
            elif kind == "evict":
                state["evicted"] = sorted(set(state.get("evicted", []))
                                          | {int(rec["sender"])})
                state["num_workers"] = int(rec["num_workers"])
            elif kind == "optimizer":
                state["tx_config"] = (rec["name"], rec.get("kwargs", {}))
            elif kind == "shard_range":
                state["shard_range"] = [int(rec["lo"]), int(rec["hi"])]
                state["map_version"] = int(rec.get("version", 0))
            elif kind == "drop_keys":
                # keys that migrated off this shard must not resurrect
                for k0 in rec.get("keys", []):
                    state["keys"].pop(k0, None)
        if state.get("tx_config"):
            name, kwargs = state["tx_config"]
            self._set_optimizer_locked(name, dict(kwargs))
            self._tx_config = (name, dict(kwargs))
        for key, rec in state["keys"].items():
            if rec.get("value") is None:
                continue
            self._apply_durable_key(key, rec)
        self._evicted = set(int(s) for s in state.get("evicted", []))
        if state.get("num_workers") is not None:
            self.num_workers = int(state["num_workers"])
            self._m_workers.set(self.num_workers)
        sr = state.get("shard_range")
        if sr is not None and int(state.get("map_version", 0)) >= \
                self.shard_map_version:
            # the journaled range is at least as fresh as the
            # constructor's: a restarted shard resumes the range it
            # last installed (a rebalance may have moved it)
            self._shard_range = (int(sr[0]), int(sr[1]))
            self.shard_map_version = int(state.get("map_version", 0))
            self._m_shard_ver.set(self.shard_map_version)
        self._m_shard_keys.set(len(self._store))

    # ---- key-range sharding: migration + redirect helpers ------------------

    @staticmethod
    def _enc_arr(a) -> Optional[dict]:
        """numpy array -> wire-primitive dict (meta headers carry only
        primitives; pickled ndarrays would be refused by the hardened
        header unpickler)."""
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        return {"d": a.dtype.str, "s": list(a.shape), "b": a.tobytes()}

    @staticmethod
    def _dec_arr(e) -> Optional[np.ndarray]:
        if e is None:
            return None
        return np.frombuffer(e["b"], dtype=np.dtype(e["d"])).reshape(
            e["s"]).copy()

    @classmethod
    def _enc_contrib(cls, g) -> Optional[dict]:
        """Wire-primitive form of one in-flight contribution: dense
        arrays as `_enc_arr`, sparse (value, index) pair sets as ONE
        flat dict (marked ``sp``; the wire-meta depth cap forbids
        nesting `_enc_arr` dicts) so a shard migration moves the open
        round WITHOUT densifying it."""
        if isinstance(g, _SparsePairs):
            return {"sp": 1, "vb": g.vals.tobytes(),
                    "ib": np.ascontiguousarray(g.idx).tobytes(),
                    "n": g.n, "shape": list(g.shape)}
        return cls._enc_arr(g)

    @classmethod
    def _dec_contrib(cls, e):
        if isinstance(e, dict) and e.get("sp"):
            return _SparsePairs(
                np.frombuffer(e["vb"], np.float32),
                np.frombuffer(e["ib"], np.int64), e["n"], e["shape"])
        return cls._dec_arr(e)

    def _wrong_shard_msg(self, error: str) -> Msg:
        return Msg(MsgType.ERROR, meta={
            "error": error, "wrong_shard": True,
            "map_version": self.shard_map_version})

    def _owns(self, key: str) -> bool:
        from geomx_tpu_torch.service.shardmap import key_hash
        lo, hi = self._shard_range
        return lo <= key_hash(key) < hi

    def _wrong_shard_reply_locked(self, key: str) -> Optional[Msg]:
        """The locked re-check of the (unlocked, fast-path) range gate
        in ``_handle``: a push that passed the fast path can reach the
        merge AFTER a rebalance shrank the range and copied the key
        out — merging then would strand an ACKed contribution on a key
        the paired ``drop_keys`` is about to erase.  Returns the
        redirect to send (caller holds self._lock), or None when the
        key is owned."""
        if self._shard_range is None or key is None or self._owns(key):
            return None
        lo, hi = self._shard_range
        return self._wrong_shard_msg(
            f"key {key!r} is outside this shard's range [{lo}, {hi}) at "
            f"map version {self.shard_map_version}")

    def _redirect_waiters_locked(self, st: "_KeyState", error: str) -> None:
        """Answer every parked pull of ``st`` with a ``wrong_shard``
        redirect (its round completes at the key's new owner)."""
        waiters, st.waiting_pulls = st.waiting_pulls, []
        for c, req, _need in waiters:
            err = self._wrong_shard_msg(error)
            rid = req.meta.get("rid")
            if rid is not None:
                err.meta["rid"] = rid
            try:
                self._send_msg(c, err)
            except OSError:
                pass

    def _redirect_out_of_range_locked(self) -> None:
        """After a range shrink: parked pulls for keys this shard no
        longer owns must redirect (their round will complete at the new
        owner), not stall forever.  Caller holds self._lock."""
        if self._shard_range is None:
            return
        for key, st in self._store.items():
            if self._owns(key) or not st.waiting_pulls:
                continue
            self._redirect_waiters_locked(
                st, f"key {key!r} moved off this shard "
                    f"(map version {self.shard_map_version})")

    def _snapshot_key_locked(self, key: str) -> dict:
        """One key's FULL state — the value, round counts, optimizer and
        compressor state plus the open round's in-flight per-sender
        contributions — as a wire-primitive record.  Read-only
        (migration copies first, drops only after the import is
        acknowledged).  Caller holds self._lock."""
        st = self._store[key]
        sp = st.sparse_value
        if sp is not None:
            # a sparse-pending round migrates IN PAIR FORM (the one
            # _enc_contrib encoding): O(k) bytes over the migration
            # wire instead of an O(n) densify
            value = self._enc_contrib(_SparsePairs(
                sp[0], sp[1], st.dense_size, st.dense_shape))
        else:
            value = self._enc_arr(st.value)
        rec = {"value": value, "round": int(st.round),
               "pushed": {int(s): int(n) for s, n in st.pushed.items()},
               "milestone": self._enc_arr(st.milestone),
               "opt": self._opt_blob(key), "comp": None,
               "count": int(st.count),
               "contribs": {int(s): self._enc_contrib(g)
                            for s, g in st.contribs.items()},
               "relay_error": st.relay_error}
        comp = self._comp_state.get(key) \
            if self._compressor is not None else None
        if isinstance(comp, tuple) and comp and \
                all(isinstance(a, torch.Tensor) for a in comp):
            # the JAX record's layout: each buffer in the value's shape
            rec["comp"] = [self._enc_arr(a.cpu().numpy().reshape(
                st.dense_shape)) for a in comp]
        return rec

    def _drop_keys_locked(self, keys) -> None:
        """Forget migrated keys: pop every trace of them — store,
        optimizer/compressor state, in-flight P3 assemblies, armed DGT
        deadlines, load-window counters — journal the drop (a restarted
        loser must not resurrect moved keys) and redirect parked pulls
        (their rounds complete at the importing shard).  Caller holds
        self._lock."""
        dropped = []
        for key in keys:
            st = self._store.pop(key, None)
            if st is None:
                continue
            dropped.append(key)
            self._opt_state.pop(key, None)
            if self._compressor is not None:
                self._comp_state.pop(key, None)
            self._load_key_pushes.pop(key, None)
            for pk in [pk for pk in list(self._p3_partial)
                       if pk[1] == key]:
                self._p3_partial.pop(pk, None)
            for pk in [pk for pk in list(self._dgt_pending)
                       if pk[1] == key]:
                self._dgt_untrack(pk)
            self._redirect_waiters_locked(
                st, f"key {key!r} migrated off this shard")
        if dropped:
            self._journal({"k": "drop_keys", "keys": dropped})
        self._m_shard_keys.set(len(self._store))

    def _import_key_locked(self, key: str, rec: dict) -> None:
        """Install a migrated key record (the gainer side of a
        rebalance): the open round's contributions arrive in memory —
        exactly a round in flight.  Idempotent round-wise: migrated
        ``pushed`` counts make a re-routed client's replayed push an
        idempotent ACK.  Caller holds self._lock."""
        enc = rec["value"]
        sparse_pending = None
        if isinstance(enc, dict) and enc.get("sp"):
            # sparse-pending migration record: install the pair set
            # lazily, exactly as the exporter held it
            sp = self._dec_contrib(enc)
            sparse_pending = (sp.vals, sp.idx)
            value = np.zeros(enc["shape"], np.float32)
        else:
            value = self._dec_arr(enc)
        st = self._store.get(key)
        if st is None:
            st = self._store[key] = _KeyState(value)
        st.value = value
        if sparse_pending is not None:
            st.set_sparse_value(*sparse_pending)
        st.round = int(rec.get("round", 0))
        st.pushed = {int(s): int(n)
                     for s, n in dict(rec.get("pushed", {})).items()}
        st.milestone = self._dec_arr(rec.get("milestone"))
        st.contribs = {int(s): self._dec_contrib(g)
                       for s, g in dict(rec.get("contribs", {})).items()}
        st.count = int(rec.get("count", 0))
        st.relay_error = rec.get("relay_error")
        blob = rec.get("opt")
        if self._tx is not None:
            if blob is not None:
                from geomx_tpu_torch.utils.checkpoint import tree_from_bytes
                self._opt_state[key] = tree_from_bytes(
                    blob, target=self._opt_init(st.value))
            elif key not in self._opt_state:
                self._opt_state[key] = self._opt_init(st.value)
        if self._compressor is not None:
            comp = rec.get("comp")
            self._comp_state[key] = tuple(
                self._to_device(self._dec_arr(a)).reshape(-1)
                for a in comp) if comp else self._comp_init(st.value)
        jrec = {"k": "round", "key": key}
        jrec.update(self._key_record(key, st))
        self._journal(jrec)
        if 0 < st.count and st.count >= self.num_workers:
            # the migrated open round already satisfies this shard's
            # gate (e.g. the last pusher re-routed before the move)
            self._complete_merge_locked(key, st)

    # ---- networking --------------------------------------------------------

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)  # per-connection sockets block normally
            self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            self._serve_conn_loop(conn)
        finally:
            # actively close: a connection dropped for a FAILED frame
            # (CRC/length/unpicklable) must surface as a dead socket on
            # the peer's side, or the peer waits forever on a stream
            # this server will never read again — closing is what
            # routes it into the client's reconnect/retry path
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            with self._outq_lock:
                # leave _conns FIRST so _conn_out_q can't hand a fresh
                # queue to this dying connection after the pops below
                self._conns.discard(conn)
                q = self._out_qs.pop(id(conn), None)
                gate = self._out_gates.pop(id(conn), None)
            if q is not None:
                q.close()  # wakes a drain thread blocked in pop()
            if gate is not None:
                gate.set()  # ...and one parked in a paused gate.wait()
                # (its sendall then fails on the dead socket and it exits)
            self._conn_wlocks.pop(id(conn), None)  # don't leak per-conn locks

    def _serve_conn_loop(self, conn: socket.socket):
        while True:
            try:
                msg = recv_frame(conn)
            except (OSError, pickle.UnpicklingError, ValueError):
                # malformed/rejected frame (protocol._HeaderUnpickler): the
                # stream is desynced — drop the connection cleanly
                return
            if msg is None:
                return
            if should_drop(msg):
                continue  # fault injection: message "lost on the wire"
            try:
                stop = self._handle(conn, msg)
            except Exception as e:  # surface server errors to the client
                self._reply(conn, msg, Msg(MsgType.ERROR, meta={"error": repr(e)}))
                continue
            if stop:
                return

    # ---- request handling (the DataHandleEx dispatch) ----------------------

    def _send_msg(self, conn, msg: Msg):
        """Per-connection write lock: AUTOPULL pushes race the serve
        thread's replies on the same socket, and interleaved frames would
        corrupt the length-prefixed stream."""
        lock = self._conn_wlocks.setdefault(id(conn), threading.Lock())
        with lock:
            send_frame(conn, msg)

    def _reply(self, conn, req: Msg, reply: Msg):
        """Echo the request id so async clients can match replies.
        ``conn=None`` (a server-internal synthesized request, e.g. a
        best-effort DGT deadline merge) sends nothing.  Every reply
        carries the server's generation token — the restart detector
        the client session-resume handshake stands on."""
        if conn is None:
            return
        rid = req.meta.get("rid")
        if rid is not None:
            reply.meta["rid"] = rid
        reply.meta.setdefault("gen", self.generation)
        self._send_msg(conn, reply)


    # ---- fleet round ledger (telemetry/ledger.py) --------------------------

    def _ledger_hop(self, key: str, rid, hop: str, **kw) -> None:
        """One causal hop of round ``rid`` on this server/shard.  Best
        effort by design — observability must never fail the data path
        it observes."""
        if rid is None:
            return
        try:
            from geomx_tpu_torch.telemetry.ledger import record_hop
            kw.setdefault("shard", self.shard_index
                          if self.shard_index is not None else self.rank)
            record_hop(key, int(rid), hop, **kw)
        except Exception:
            pass

    def _ledger_phase(self, key: str, rid, phase: str,
                      seconds: float) -> None:
        if rid is None:
            return
        try:
            from geomx_tpu_torch.telemetry.ledger import add_phase
            add_phase(key, int(rid), phase, seconds)
        except Exception:
            pass

    def _ledger_complete(self, key: str, rid) -> None:
        if rid is None:
            return
        try:
            from geomx_tpu_torch.telemetry.ledger import complete_round
            complete_round(key, int(rid))
        except Exception:
            pass

    def _handle(self, conn, msg: Msg) -> bool:
        t = msg.type
        if msg.sender >= 0:
            self.heartbeats.heartbeat(msg.sender)
        if self._shard_range is not None and msg.key is not None and \
                t in (MsgType.INIT, MsgType.PUSH, MsgType.PULL) and \
                not self._owns(msg.key):
            # stale shard map: REDIRECT, never a wrong-shard merge.  The
            # version tells the client how fresh a map to fetch.
            lo, hi = self._shard_range
            self._reply(conn, msg, self._wrong_shard_msg(
                f"key {msg.key!r} is outside this shard's range "
                f"[{lo}, {hi}) at map version {self.shard_map_version}"))
            return False
        if t == MsgType.HEARTBEAT:
            self._reply(conn, msg, Msg(MsgType.ACK))
        elif t == MsgType.INIT:
            with self._lock:
                redirect = self._wrong_shard_reply_locked(msg.key)
                if redirect is not None:
                    self._reply(conn, msg, redirect)
                    return False
                if msg.key not in self._store:
                    self._store[msg.key] = _KeyState(msg.array)
                    if self.hfa_k2 is not None:
                        self._store[msg.key].milestone = \
                            np.asarray(msg.array, np.float32).copy()
                    if self._native_sgd is not None:
                        self._opt_state[msg.key] = \
                            self._native_sgd.init_state(msg.array)
                    elif self._tx is not None:
                        self._opt_state[msg.key] = self._opt_init(msg.array)
                    if self._compressor is not None:
                        self._comp_state[msg.key] = \
                            self._comp_init(msg.array)
                    # propagate upward so the global tier owns every key
                    # (the reference inits global store on first push-
                    # through, kvstore_dist_server.h:1241-1273)
                    if self._gclients:
                        try:
                            self._global_init(msg.key,
                                              np.asarray(msg.array,
                                                         np.float32))
                        except Exception as e:
                            # undo the local registration so a retried
                            # INIT re-forwards; surface the failure
                            del self._store[msg.key]
                            self._opt_state.pop(msg.key, None)
                            if self._compressor is not None:
                                self._comp_state.pop(msg.key, None)
                            raise RuntimeError(
                                f"global INIT failed for {msg.key}: "
                                f"{e!r}")
                    if self._durable is not None:
                        st0 = self._store[msg.key]
                        rec = {"k": "init", "key": msg.key}
                        rec.update(self._key_record(msg.key, st0))
                        self._journal(rec)
                self._m_shard_keys.set(len(self._store))
            self._reply(conn, msg, Msg(MsgType.ACK, key=msg.key))
        elif t == MsgType.PUSH:
            self._handle_push(conn, msg)
        elif t == MsgType.PULL:
            self._handle_pull(conn, msg)
        elif t == MsgType.BARRIER:
            with self._lock:
                self._barrier_waiters.append((conn, msg.meta.get("rid")))
                if len(self._barrier_waiters) >= self.num_workers:
                    for c, rid in self._barrier_waiters:
                        rel = Msg(MsgType.BARRIER_RELEASE)
                        if rid is not None:
                            rel.meta["rid"] = rid
                        self._send_msg(c, rel)
                    self._barrier_waiters = []
        elif t == MsgType.COMMAND:
            self._handle_command(conn, msg)
        elif t == MsgType.STOP:
            with self._lock:
                self._stops += 1
                done = self._stops >= self.num_workers
            self._reply(conn, msg, Msg(MsgType.ACK))
            if done:
                self.stop()
            return True
        else:
            self._reply(conn, msg, Msg(MsgType.ERROR,
                                       meta={"error": f"bad type {t}"}))
        return False

    def _handle_command(self, conn, msg: Msg):
        cmd = msg.meta.get("cmd")
        if cmd == "set_optimizer":
            # reference pickles the optimizer to the server (kController);
            # here only a named optimizer + kwargs travel the wire.
            # A local-tier server forwards it up: the optimizer runs on the
            # GLOBAL tier (kvstore_dist_server.h:512-515 — python updater
            # executes on global servers; local tier is pure aggregation).
            if self._gclients:
                # every global server gets the optimizer (MultiGPS: each
                # runs it on its own key range).  A global-tier failure
                # must reach the worker, not be swallowed into a blind ACK
                # (it would train with the overwrite store and silently
                # diverge)
                try:
                    with self._lock:
                        for c in self._gclients:
                            c._request(Msg(MsgType.COMMAND,
                                           meta=dict(msg.meta)))
                except Exception as e:
                    self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                        "error": f"global set_optimizer failed: {e!r}"}))
                    return
            else:
                config = (msg.meta["name"], msg.meta.get("kwargs", {}))
                with self._lock:
                    # idempotent: every party's lead worker sends the same
                    # config so ordering vs. first pushes is safe in async
                    # mode; don't reset optimizer state on repeats
                    if self._tx_config != config:
                        self._set_optimizer_locked(*config)
                        self._tx_config = config
                        self._journal({"k": "optimizer",
                                       "name": config[0],
                                       "kwargs": dict(config[1])})
        elif cmd == "set_gradient_compression":
            from geomx_tpu_torch.compression import get_compressor
            self._compressor = get_compressor(msg.meta["spec"])
            with self._lock:
                self._comp_state = {
                    k: self._comp_init(st.value)
                    for k, st in self._store.items()}
        elif cmd == "register_autopull":
            # client opts into server-initiated updates; indices drive the
            # TSEngine scheduler.  A reconnecting worker (same sender id)
            # reclaims its slot; a table overflow is a real error, not a
            # silent ACK that would leave the client waiting forever.
            with self._lock:
                if self.ts_sched is None:
                    self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                        "error": "server not in auto_pull mode"}))
                    return
                idx = self._ap_ids.get(msg.sender)
                if idx is None:
                    idx = len(self._ap_ids)
                    if idx >= self.ts_sched.n:
                        self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                            "error": "autopull table full"}))
                        return
                    self._ap_ids[msg.sender] = idx
                self._ap_conns[idx] = conn
        elif cmd == "ts_register":
            # a TS node announces its relay listener; directives for it go
            # down this connection
            with self._lock:
                if self.ts_push_sched is None:
                    self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                        "error": "server not in TS mode"}))
                    return
                self._ts_nodes[int(msg.meta["node"])] = {
                    "conn": conn,
                    "addr": (msg.meta["host"], int(msg.meta["port"]))}
        elif cmd == "ts_ask1":
            if self.ts_push_sched is None:
                self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                    "error": "server not in TS mode"}))
                return
            # pairing rounds count only REGISTERED overlay nodes: peers
            # that opted out of TS (e.g. a compressed party at the global
            # tier) push directly and must not be waited for.  TS clients
            # register at construction, before any training push; the
            # demos barrier after init so registration races can't shrink
            # a round's pool mid-flight.
            with self._lock:
                num_pushers = max(1, len(self._ts_nodes))
            directive = self.ts_push_sched.ask1_key(
                int(msg.meta["node"]), msg.meta["key"], num_pushers)
            self._reply(conn, msg, Msg(MsgType.ACK))
            if directive is not None:
                self._send_ts_directive(msg.meta["key"], *directive)
            return
        elif cmd == "ts_relay_failed":
            # a sender could not reach its designated receiver and sank
            # its own partial directly.  Abort the key's pairing round
            # conservatively: the stranded receiver AND every still-queued
            # node go straight to the sink, and the round state resets —
            # the aggregate still lands exactly once per contribution.
            k = msg.meta["key"]
            to_sink = {int(msg.meta["receiver"])}
            if self.ts_push_sched is not None:
                to_sink.update(self.ts_push_sched.drain_key(k))
            for node in to_sink:
                self._send_ts_directive(k, node, 0)
            self._reply(conn, msg, Msg(MsgType.ACK))
            return
        elif cmd == "ts_report":
            if self.ts_push_sched is not None:
                self.ts_push_sched.report(
                    int(msg.meta["sender"]), int(msg.meta["receiver"]),
                    float(msg.meta["throughput"]),
                    self.ts_push_sched.iters)
        elif cmd == "set_profiler_params":
            self.profiler.set_config(**msg.meta.get("params", {}))
        elif cmd == "profiler_start":
            self.profiler.set_state(True)
        elif cmd == "profiler_stop":
            self.profiler.set_state(False)
        elif cmd == "profiler_dump":
            path = self.profiler.dump()
            self._reply(conn, msg, Msg(MsgType.ACK, meta={"path": path}))
            return
        elif cmd == "hello":
            # session-resume handshake, step 1: who am I talking to?
            # The generation token rides every reply already; hello
            # exists so a RECONNECTING client can learn it before
            # deciding whether to replay (docs/resilience.md)
            hello = {"gen": self.generation, "rank": self.rank,
                     "mode": self.mode, "num_workers": self.num_workers,
                     "durable": self._durable is not None}
            if self._shard_range is not None:
                hello.update({"shard_index": self.shard_index,
                              "shard_lo": self._shard_range[0],
                              "shard_hi": self._shard_range[1],
                              "map_version": self.shard_map_version})
            self._reply(conn, msg, Msg(MsgType.ACK, meta=hello))
            return
        elif cmd == "query_progress":
            # recovery state for a (re)joining worker: its per-key merged
            # round counts, so it resumes its round ids where the dead
            # incarnation left off
            with self._lock:
                prog = {k: st.pushed.get(msg.sender, 0)
                        for k, st in self._store.items()}
            self._reply(conn, msg, Msg(MsgType.ACK,
                                       meta={"progress": prog}))
            return
        elif cmd == "num_dead_nodes":
            self._reply(conn, msg, Msg(
                MsgType.ACK,
                meta={"dead": self.heartbeats.dead_nodes(
                    msg.meta.get("timeout"))}))
            return
        elif cmd == "shard_info":
            with self._lock:
                info = {"shard_index": self.shard_index,
                        "map_version": self.shard_map_version,
                        "num_keys": len(self._store)}
                if self._shard_range is not None:
                    info["lo"], info["hi"] = self._shard_range
            self._reply(conn, msg, Msg(MsgType.ACK, meta=info))
            return
        elif cmd == "set_shard_range":
            # scheduler-driven range install (rebalance step 1 shrinks
            # the loser FIRST, quiescing the moved segment before its
            # keys export — in-flight clients redirect and retry)
            lo, hi = int(msg.meta["lo"]), int(msg.meta["hi"])
            ver = int(msg.meta.get("version", 0))
            with self._lock:
                self._shard_range = (lo, hi)
                self.shard_map_version = max(self.shard_map_version, ver)
                self._journal({"k": "shard_range", "lo": lo, "hi": hi,
                               "version": self.shard_map_version})
                self._m_shard_ver.set(self.shard_map_version)
                self._redirect_out_of_range_locked()
        elif cmd == "shard_load":
            # windowed load observation: per-key push counts since the
            # last reset — the scheduler's rebalance input
            with self._lock:
                load = {"pushes": self._load_pushes,
                        "pulls": self._load_pulls,
                        "keys": dict(self._load_key_pushes),
                        "num_keys": len(self._store)}
                if msg.meta.get("reset"):
                    self._load_pushes = self._load_pulls = 0
                    self._load_key_pushes = {}
            self._reply(conn, msg, Msg(MsgType.ACK, meta={"load": load}))
            return
        elif cmd == "export_keys":
            # COPY the range's key state out (``remove=True`` also
            # drops it).  The scheduler's rebalance exports with
            # remove=False and only issues the paired ``drop_keys``
            # AFTER the gainer acknowledged the import — a failed import
            # between the two leaves the keys intact on the (quiesced)
            # loser, retryable, never lost.
            lo, hi = int(msg.meta["lo"]), int(msg.meta["hi"])
            from geomx_tpu_torch.service.shardmap import key_hash
            with self._lock:
                records = {key: self._snapshot_key_locked(key)
                           for key in sorted(self._store)
                           if lo <= key_hash(key) < hi}
                if msg.meta.get("remove", True):
                    self._drop_keys_locked(sorted(records))
            self._reply(conn, msg, Msg(MsgType.ACK,
                                       meta={"records": records}))
            return
        elif cmd == "drop_keys":
            lo, hi = int(msg.meta["lo"]), int(msg.meta["hi"])
            from geomx_tpu_torch.service.shardmap import key_hash
            with self._lock:
                self._drop_keys_locked(
                    [key for key in sorted(self._store)
                     if lo <= key_hash(key) < hi])
        elif cmd == "import_keys":
            with self._lock:
                for key, rec in dict(msg.meta["records"]).items():
                    self._import_key_locked(str(key), rec)
                self._m_shard_keys.set(len(self._store))
        elif cmd == "evict_worker":
            # resilience/: un-stall the sync gate after a worker death
            # (the liveness controller or an operator decides WHEN; the
            # server only executes the roster change)
            n = self.evict_worker(int(msg.meta["node"]))
            self._reply(conn, msg, Msg(MsgType.ACK,
                                       meta={"num_workers": n}))
            return
        elif cmd == "metrics":
            # live Prometheus exposition of the process-global registry
            # (the wire-protocol twin of the scheduler's GET /metrics)
            from geomx_tpu_torch.telemetry import render_prometheus
            self._reply(conn, msg, Msg(MsgType.ACK,
                                       meta={"text": render_prometheus()}))
            return
        elif cmd == "wire_stats":
            # this server process's Van-style byte/message counters
            # (reference van.h:182-183 send_bytes_/recv_bytes_)
            self._reply(conn, msg, Msg(MsgType.ACK,
                                       meta={"stats":
                                             wire_stats.snapshot()}))
            return
        elif cmd == "pause_pull_stream":
            # test/demo hook (mirror of the client's pause_sending): hold
            # this connection's chunked-reply drain so queued replies
            # re-order by priority observably
            gate = self._out_gates.get(id(conn))
            if gate is None:
                gate = self._out_gates[id(conn)] = threading.Event()
            gate.clear()
        elif cmd == "resume_pull_stream":
            gate = self._out_gates.get(id(conn))
            if gate is not None:
                gate.set()
        else:
            self._reply(conn, msg, Msg(MsgType.ERROR,
                                       meta={"error": f"bad cmd {cmd}"}))
            return
        self._reply(conn, msg, Msg(MsgType.ACK))

    def _send_ts_directive(self, key: str, sender: int, receiver: int):
        """Tell `sender` where its partial goes (the ASK1 reply).  An
        unregistered receiver degrades to the sink so the round always
        completes."""
        with self._lock:
            info = self._ts_nodes.get(sender)
            rinfo = self._ts_nodes.get(receiver) if receiver != 0 else None
        if info is None:
            return  # sender vanished; its heartbeat death will surface
        d = Msg(MsgType.TS_DIRECTIVE, key=key, meta={"to": receiver})
        if receiver != 0:
            if rinfo is None:
                d.meta["to"] = 0
            else:
                d.meta["host"], d.meta["port"] = rinfo["addr"]
        try:
            self._send_msg(info["conn"], d)
        except OSError:
            pass

    # ---- the data path -----------------------------------------------------

    def _set_optimizer_locked(self, name: str, kwargs: dict):
        """Install the server-side optimizer.  The sgd family goes through
        the native C++ kernel when the runtime is built (the reference's
        legacy server-side SGDOpt, src/optimizer/sgd-inl.h — applied
        without a python/optax dispatch per key per round); everything
        else is the port's optimizer of that name (optax semantics) on the
        server's device.  GEOMX_NATIVE_SGD=0 opts out."""
        self._native_sgd = None
        # durable servers take the factory path: the native kernel's
        # state handle is not serializable, and a restart that silently
        # re-zeroed momentum would not be the exact resume the durable
        # store promises
        use_native = (name in ("sgd", "momentum")
                      # graftlint: disable=GXL006 — host-plane gate
                      and os.environ.get("GEOMX_NATIVE_SGD", "1") != "0"
                      and self._durable is None)
        if use_native:
            try:
                from geomx_tpu_torch.runtime.native import NativeSGD
                kw = dict(kwargs)
                if name == "momentum":
                    kw.setdefault("momentum", 0.9)
                self._native_sgd = NativeSGD(**kw)
                self._tx = None
                for k, st in self._store.items():
                    self._opt_state[k] = self._native_sgd.init_state(st.value)
                return
            except (RuntimeError, TypeError):
                pass  # no toolchain / unsupported kwargs: the factory's
        from geomx_tpu_torch.optim import get_optimizer
        self._tx = get_optimizer(name, **kwargs)
        for k, st in self._store.items():
            self._opt_state[k] = self._opt_init(st.value)

    def _to_device(self, a) -> torch.Tensor:
        # np.array copies: a decoded payload is a read-only wire view
        return torch.from_numpy(np.array(a, np.float32)).to(self.device)

    def _opt_init(self, value) -> Any:
        """The optimizer state of one key: the port's optimizers take
        flat trees, so a key's value is the one-leaf tree ``{"w": v}``,
        on the server's device."""
        return self._tx.init({"w": self._to_device(value)})

    def _comp_init(self, value) -> Any:
        """The relay compressor's state of one key: BSC's momentum u
        and velocity v, flat on the server's device (they stay there
        between rounds); ``()`` for a key under ``min_sparse_size`` or a
        compressor without a relay selection."""
        comp = self._compressor
        n = int(np.size(value))
        if not hasattr(comp, "compress") or n < comp.min_sparse_size:
            return ()
        return (torch.zeros(n, dtype=torch.float32, device=self.device),
                torch.zeros(n, dtype=torch.float32, device=self.device))

    def _apply(self, key: str, grad: np.ndarray):
        """Merged gradient -> store (optimizer if present, else overwrite —
        the reference's ApplyUpdates, kvstore_dist_server.h:502-523)."""
        st = self._store[key]
        if self._native_sgd is not None:
            st.value = self._native_sgd.update(
                st.value, grad, self._opt_state.get(key))
            return
        if self._tx is not None:
            new, self._opt_state[key] = self._tx.update(
                {"w": self._to_device(grad)}, self._opt_state[key],
                {"w": self._to_device(st.value)})
            st.value = new["w"].cpu().numpy().astype(st.value.dtype,
                                                      copy=False)
        elif self.accumulate:
            st.value = st.value + grad.astype(st.value.dtype)
        else:
            st.value = grad.astype(st.value.dtype)

    def _placement(self, key: str, shape: tuple) -> dict:
        """Reference MultiGPS placement for the host plane: tensors >=
        bigarray_bound split contiguously across all global servers,
        smaller ones hashed whole (kvstore_dist.h:792-833; string keys
        hash via crc32 in place of the reference's int keys).  Splits of
        >=2-D tensors align to ROW boundaries, so row-sparse pushes route
        per shard.  Keys under a dc-tier compressor are never split:
        their relay payloads are compressed whole (value+index pairs are
        indivisible), so they route to the hash owner."""
        import zlib

        from geomx_tpu_torch.parallel.multigps import HASH_PRIME
        S = len(self._gclients)
        size = int(np.prod(shape)) if shape else 1
        owner = (zlib.crc32(key.encode("utf-8")) * HASH_PRIME) % max(S, 1)
        place = {"owner": owner, "bounds": None, "row_bounds": None,
                 "shape": tuple(shape)}
        if S > 1 and self._compressor is None and \
                size >= self.bigarray_bound:
            if len(shape) >= 2:
                nrows = shape[0]
                rowsize = size // nrows
                per = nrows // S
                rb = tuple(i * per for i in range(S)) + (nrows,)
                place["row_bounds"] = rb
                place["bounds"] = tuple(b * rowsize for b in rb)
            else:
                per = size // S
                place["bounds"] = tuple(i * per for i in range(S)) + (size,)
            place["owner"] = -1
        return place

    def _global_init(self, key: str, value: np.ndarray) -> None:
        """Place a key on the global tier (whole or sharded); row-aligned
        shards keep the trailing row shape so row-sparse pushes work."""
        place = self._placement(key, value.shape)
        self._gplace[key] = place
        if place["bounds"] is None:
            self._gclients[place["owner"]].init(key, value,
                                                meta={"reliable": True})
            return
        if place["row_bounds"] is not None:
            rb = place["row_bounds"]
            for i, c in enumerate(self._gclients):
                c.init(key, value[rb[i]:rb[i + 1]], meta={"reliable": True})
            return
        flat = value.reshape(-1)
        b = place["bounds"]
        for i, c in enumerate(self._gclients):
            c.init(key, flat[b[i]:b[i + 1]], meta={"reliable": True})

    def _relay_to_global(self, key: str, grad: np.ndarray,
                         round_: Optional[int] = None) -> np.ndarray:
        """Push the party aggregate up, pull fresh globals back
        (DataPushToGlobalServers* + DataPullFromGlobalServers*).
        ``round_`` tags the span for cross-party round correlation;
        ``payload_bytes`` makes the span a throughput observation the
        LinkObservatory (telemetry/links.py) can fold on replay.

        Chaos link shaping (``throttle@``/``delay@``,
        resilience/chaos.py): any installed override for this party is
        realized as real extra wall-clock INSIDE the span, so the
        degradation a schedule injects is the degradation the
        observatory measures."""
        from geomx_tpu_torch.service.protocol import shaping_extra_seconds
        with self.profiler.scope(
                f"RelayToGlobal:{key}", "comm",
                args={"key": key, "round_id": round_,
                      "payload_bytes": int(np.asarray(grad).nbytes)}):
            t0 = time.monotonic()
            out = self._relay_to_global_impl(key, grad)
            extra = shaping_extra_seconds(self.rank,
                                          time.monotonic() - t0)
            if extra > 0:
                time.sleep(extra)
            return out

    def _relay_to_global_impl(self, key: str, grad: np.ndarray) -> np.ndarray:
        place = self._gplace.get(key)
        if place is None:
            place = {"owner": 0, "bounds": None} \
                if len(self._gclients) == 1 \
                else self._placement(key, grad.shape)
        owner, bounds = place["owner"], place["bounds"]
        if bounds is not None:
            # MultiGPS split relay: shard i goes to global server i (all
            # hops async, merged back on pull — the reference's multi-
            # server slicer + reassembly, kvstore_dist_server.h:1025-1082)
            rb = place.get("row_bounds")
            if rb is not None:   # row-aligned: ship row-shaped shards
                shards = [np.asarray(grad, np.float32)[rb[i]:rb[i + 1]]
                          for i in range(len(self._gclients))]
            else:
                flat = np.asarray(grad, np.float32).reshape(-1)
                shards = [flat[bounds[i]:bounds[i + 1]]
                          for i in range(len(self._gclients))]
            ts = [c.push_async(key, sh, meta={"reliable": True})
                  for c, sh in zip(self._gclients, shards)]
            # bounded waits: a hung global server must raise and hit the
            # relay thread's fail-fast path, not wedge the FIFO forever
            for c, t in zip(self._gclients, ts):
                c.wait(t, timeout=120.0)
            rids = [c.pull_async(key, meta={"reliable": True})
                    for c in self._gclients]
            parts = [np.asarray(c.wait(r, timeout=120.0).array,
                                np.float32).reshape(-1)
                     for c, r in zip(self._gclients, rids)]
            return np.concatenate(parts).reshape(grad.shape)
        c0 = self._gclients[owner]
        if c0.ts_node is not None:
            # inter-party TS: announce the partial to the global ASK1
            # scheduler (it may relay-merge through a faster party before
            # hitting the sink); the fresh value comes back via the
            # global tier's AutoPull dissemination (throughput-scheduled
            # server-initiated push-down, kv_app.h:586-691) when the
            # tier supports it, else a min_round-gated pull
            rnd = self._ground[key] = self._ground.get(key, 0) + 1
            c0.ts_push(key, np.asarray(grad, np.float32))
            if self._g_autopull:
                pulled = c0.auto_pull(key, min_version=rnd, timeout=120.0)
            else:
                pulled = c0.pull(key, timeout=120.0,
                                 meta={"min_round": rnd, "reliable": True})
            return np.asarray(pulled, np.float32).reshape(grad.shape)
        from geomx_tpu_torch.compression.sparseagg import (PAIR_WIRE_MAX_N,
                                                           encode_pairs_payload)
        meta = {}
        payload = grad
        if self._compressor is not None and \
                self._compressor.name in ("bsc", "mpq") and \
                int(grad.size) < PAIR_WIRE_MAX_N:
            # the pair format's f32 index half is exact only below
            # PAIR_WIRE_MAX_N; bigger tensors relay dense so no
            # producer ever emits a silently-rounded index.  The
            # selection runs on the server's device (bsc_select_pack on
            # the card); only the k pairs come back to the host
            comp = self._compressor
            state = self._comp_state[key]
            if hasattr(comp, "compress") and state != ():
                u, v = state
                vals, idx, u, v = comp.compress(
                    self._to_device(grad.reshape(-1)), u, v)
                self._comp_state[key] = (u, v)
                payload = encode_pairs_payload(vals.cpu().numpy(),
                                               idx.cpu().numpy())
                meta = {"comp": "bsc", "n": int(grad.size),
                        "shape": list(grad.shape)}
        elif self._compressor is not None and self._compressor.name == "fp16":
            payload = grad.astype(np.float16)
        # the relay hop runs on the dedicated relay thread; it opts out of
        # drop injection (meta["reliable"])
        meta["reliable"] = True
        c = self._gclients[owner]
        if self.enable_dgt and "comp" not in meta:
            # WAN DGT: the party aggregate crosses as contribution-ranked
            # priority blocks (top-k f32 first, fp16 tail)
            c.push_dgt(key, payload, reliable=True)
        else:
            c.push(key, payload, meta=meta)
        pulled = c.pull(key, timeout=120.0, meta={"reliable": True})
        return np.asarray(pulled, np.float32).reshape(grad.shape)

    def _relay_row_sparse(self, key: str, rows, vals: np.ndarray,
                          round_: Optional[int] = None):
        """Push only the touched rows up, pull their fresh values back —
        row-sparse through the dist path (kvstore_dist.h:874-906).
        ``rows`` are unique and sorted, ``vals`` their summed values.
        Hash-placed keys route whole; row-aligned split keys route each
        row to its shard owner — and every server gets a push (possibly
        empty) so multi-party sync counts stay in lockstep."""
        rows_arr = np.asarray(rows, np.int64)
        place = self._gplace.get(key)
        if place is None:
            # e.g. after a local-server restart: recompute (and cache) the
            # placement like the dense path, so split keys route correctly
            place = self._placement(key, self._store[key].value.shape)
            self._gplace[key] = place
        with self.profiler.scope(
                f"RelayRowSparse:{key}", "comm",
                args={"key": key, "round_id": round_,
                      "payload_bytes": int(rows_arr.nbytes
                                           + np.asarray(vals).nbytes)}):
            if place["owner"] >= 0:
                c = self._gclients[place["owner"]]
                c.push_row_sparse(key, rows_arr, vals, timeout=120.0)
                return c.pull_row_sparse(key, rows_arr, timeout=120.0)
            rb = place.get("row_bounds")
            if rb is None:
                raise RuntimeError(
                    f"row-sparse push for {key!r} but its MultiGPS split "
                    "is not row-aligned (1-D tensors cannot take row-"
                    "sparse pushes when split); raise GEOMX_BIGARRAY_BOUND")
            fresh = np.empty_like(vals)
            for i, c in enumerate(self._gclients):
                mask = (rows_arr >= rb[i]) & (rows_arr < rb[i + 1])
                c.push_row_sparse(key, rows_arr[mask] - rb[i], vals[mask],
                                  timeout=120.0)
            for i, c in enumerate(self._gclients):
                mask = (rows_arr >= rb[i]) & (rows_arr < rb[i + 1])
                if mask.any():
                    fresh[mask] = c.pull_row_sparse(
                        key, rows_arr[mask] - rb[i], timeout=120.0)
            return fresh

    def _apply_row_sparse(self, key: str, rows, vals: np.ndarray):
        """Lazy row-wise apply: only the touched rows of the value (and
        of every row-shaped optimizer-state leaf) update — untouched rows
        see no weight decay or momentum drift, the reference's row_sparse
        optimizer semantics (src/operator/optimizer_op row_sparse
        kernels).  ``rows`` unique, ``vals`` their summed gradients."""
        st = self._store[key]
        rows_arr = np.asarray(rows, np.int64)
        if self._native_sgd is not None:
            raise RuntimeError(
                "row-sparse pushes need the factory optimizer path "
                "(native SGD state is not row-addressable); set "
                "GEOMX_NATIVE_SGD=0")
        if self._tx is None:
            v = st.value.copy()
            np.add.at(v, rows_arr, vals)  # row-sparse accumulation
            st.value = v
            return
        ridx = torch.from_numpy(rows_arr).to(self.device)
        ref = self._to_device(st.value)
        shape = tuple(st.value.shape)

        def is_rowwise(leaf):
            return isinstance(leaf, torch.Tensor) and \
                tuple(leaf.shape) == shape

        def put_rows(full, part):
            if not is_rowwise(full):
                return part
            out = full.clone()
            out[ridx] = part
            return out

        state_rows = state_map(
            lambda leaf: leaf[ridx] if is_rowwise(leaf) else leaf,
            self._opt_state[key])
        new_rows, new_state_rows = self._tx.update(
            {"w": self._to_device(vals)}, state_rows, {"w": ref[ridx]})
        ref[ridx] = new_rows["w"]
        st.value = ref.cpu().numpy()
        self._opt_state[key] = state_map(put_rows, self._opt_state[key],
                                          new_state_rows)

    def _decompress_incoming(self, msg: Msg) -> np.ndarray:
        if msg.meta.get("comp") == "bsc":
            from geomx_tpu_torch.compression.sparseagg import (
                                                               decode_pairs_payload, densify_pairs_host)
            vals, idx = decode_pairs_payload(msg.array)
            out = densify_pairs_host(vals, idx, msg.meta["n"])
            return out.reshape(msg.meta["shape"])
        return np.asarray(msg.array, np.float32)

    def _incoming_payload(self, msg: Msg):
        """A push's merge payload: compressed (value, index) pushes STAY
        compressed (:class:`_SparsePairs`) when this store can merge
        them in the compressed domain — sync mode, whole-tensor push,
        no HFA (HFA pushes are parameters, and the milestone algebra
        needs dense), and the tensor inside the pair wire format's
        float32-exact index range (``PAIR_WIRE_MAX_N``, the same bound
        the sparse-reply side and the relay encode enforce) — otherwise
        the legacy per-push densify."""
        from geomx_tpu_torch.compression.sparseagg import (PAIR_WIRE_MAX_N,
                                                           decode_pairs_payload)
        if msg.meta.get("comp") == "bsc" and self.mode == "sync" \
                and self.hfa_k2 is None \
                and msg.meta.get("chunk") is None \
                and int(msg.meta.get("n", 0)) < PAIR_WIRE_MAX_N:
            vals, idx = decode_pairs_payload(msg.array)
            return _SparsePairs(vals, idx, msg.meta["n"],
                                msg.meta["shape"])
        return self._decompress_incoming(msg)

    def _handle_push(self, conn, msg: Msg):
        self._m_pushes.inc()
        # round correlation (telemetry/tracing.py): the pusher's per-key
        # round counter is the cross-party round id — merge_traces
        # stitches this span to the other parties' by (key, round_id)
        with self.profiler.scope(f"ServerPush:{msg.key}", "kvstore",
                                 args={"key": msg.key,
                                       "round_id": msg.meta.get("round"),
                                       "sender": msg.sender}):
            self._handle_push_profiled(conn, msg)

    def _handle_push_profiled(self, conn, msg: Msg):
        key = msg.key
        rs = None
        if msg.meta.get("rows") is not None:
            # row-sparse push (kvstore_dist.h:874-906): rows stay sparse
            # through merge; they share the dense path's dedup machinery
            with self._lock:
                st = self._store.get(key)
                if st is None:
                    self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                        "error": f"no key {key}"}))
                    return
                tail = st.dense_shape[1:]  # shape only: never force the
                # lazy densify of a sparse-pending round for a header read
            rows = np.asarray(msg.meta["rows"], np.int64)
            rs = (rows,
                  np.asarray(msg.array, np.float32).reshape(
                      (len(rows),) + tail))
            grad = None
        else:
            grad = self._incoming_payload(msg)
        # resend dedup: a push is not idempotent (it merges), so replayed
        # (sender, rid) signatures are re-ACKed without re-merging — the
        # reference Resender's signature set (src/resender.h).  Only
        # resend-flagged pushes participate: unflagged clients (fresh rid
        # counters after a worker restart) must never match stale sigs.
        sig = None
        if msg.meta.get("resend") and msg.meta.get("rid") is not None \
                and msg.sender >= 0:
            sig = (msg.sender, msg.meta["rid"])
        with self._lock:
            self.push_log.append((msg.sender, key, msg.meta.get("chunk")))
            if len(self.push_log) > 65536:
                del self.push_log[:32768]
            # windowed load observation (scheduler rebalance input)
            self._load_pushes += 1
            self._load_key_pushes[key] = \
                self._load_key_pushes.get(key, 0) + 1
            redirect = self._wrong_shard_reply_locked(key)
            if redirect is not None:
                # locked re-check of the fast-path range gate: a
                # rebalance shrank the range after this push passed it —
                # redirect BEFORE any dedup/chunk state records it
                self._reply(conn, msg, redirect)
                return
            if sig is not None:
                prior = self._seen_pushes.get(sig)
                if prior is True:
                    self._reply(conn, msg, Msg(MsgType.ACK, key=key))
                    return
                if prior == "parked":
                    # original is queued on the relay shard (async mode):
                    # not installed yet, so a retransmit must NOT be
                    # ACKed — stay silent; the deferred reply (same rid)
                    # answers whichever copy the client is waiting on
                    return
                # check-and-record atomically so concurrent replays can't
                # both merge; rolled back below if processing fails so a
                # retransmit can still succeed
                self._seen_pushes[sig] = True
                if len(self._seen_pushes) > 65536:
                    # evict oldest COMPLETED signatures; parked (in-
                    # flight async relay) entries are skipped rather
                    # than breaking the sweep — a parked head must not
                    # disable the cap while pushes keep arriving
                    for k0 in list(itertools.islice(
                            iter(self._seen_pushes), 1024)):
                        if len(self._seen_pushes) <= 65536:
                            break
                        if self._seen_pushes[k0] == "parked":
                            continue
                        del self._seen_pushes[k0]
            if msg.meta.get("chunk") is not None:
                if msg.meta.get("num_required") is not None:
                    # best-effort DGT: a NEWER round's first chunk must
                    # not discard the previous round wholesale — its
                    # reliable top-k blocks were ACKed and their merge is
                    # owed.  Finalize the outstanding round (missing
                    # deferred blocks as zeros) BEFORE the accumulator
                    # resets to the new generation.
                    self._dgt_supersede_locked(msg)
                full = self._p3_accumulate(msg, grad)
                if full is None:   # more chunks outstanding
                    if msg.meta.get("num_required") is not None:
                        # once the reliable (top-k) blocks are all in,
                        # start the deadline after which missing
                        # deferred blocks count as zeros
                        self._dgt_track(msg)
                    self._reply(conn, msg, Msg(MsgType.ACK, key=key))
                    return
                grad = full        # final chunk: merge the whole tensor;
                # its ACK comes from _push_locked below
                self._dgt_untrack((msg.sender, key))
            try:
                self._push_locked(conn, msg, key, grad, rs=rs, sig=sig)
            except Exception:
                if sig is not None:
                    self._seen_pushes.pop(sig, None)
                raise
            if msg.meta.get("chunk") is not None:
                # only clear the buffer once the merge really happened, so
                # a retransmitted final chunk can retry after a failure
                self._p3_partial.pop((msg.sender, key), None)

    def _dgt_track(self, msg: Msg):
        """Best-effort DGT bookkeeping (caller holds self._lock): when
        every REQUIRED (top-k, reliably-sent) chunk of a push has
        arrived, arm a deadline that finalizes the push with zeros for
        whatever deferred blocks never made it — the reference's lossy
        UDP channels, where dropped blocks are simply gone
        (van.cc:723-846)."""
        pk = (msg.sender, msg.key)
        rnd = int(msg.meta.get("round", 0))
        st = self._dgt_pending.get(pk)
        if st is not None and rnd < st["round"]:
            # stale straggler from an already-superseded round (deferred
            # blocks ride lower priority and can arrive arbitrarily
            # late): it must not wipe the current round's required set
            # or cancel its armed deadline
            return
        if st is None or st["round"] != rnd:
            if st is not None and st["timer"] is not None:
                st["timer"].cancel()
            st = self._dgt_pending[pk] = {
                "round": rnd, "required_got": set(),
                "num_required": int(msg.meta["num_required"]),
                "num_merge": int(msg.meta.get("num_merge", 1)),
                "timer": None}
        if msg.meta.get("required"):
            st["required_got"].add(int(msg.meta["chunk"]))
        if st["timer"] is None and \
                len(st["required_got"]) >= st["num_required"]:
            # graftlint: disable=GXL006 — host-plane knob
            deadline_s = float(os.environ.get(
                "GEOMX_DGT_DEADLINE_MS", "200")) / 1000.0
            t = threading.Timer(deadline_s, self._dgt_finalize,
                                args=(pk, rnd))
            t.daemon = True
            st["timer"] = t
            t.start()

    def _dgt_untrack(self, pk):
        """The chunk set completed naturally: cancel the deadline."""
        st = self._dgt_pending.pop(pk, None)
        if st is not None and st["timer"] is not None:
            st["timer"].cancel()

    def _dgt_supersede_locked(self, msg: Msg):
        """A chunk of a NEWER round arrived while an older round is still
        pending: force-finalize the older round now.  Caller holds
        self._lock."""
        pk = (msg.sender, msg.key)
        rnd = int(msg.meta.get("round", 0))
        st = self._dgt_pending.get(pk)
        if st is not None and rnd > st["round"]:
            if st["timer"] is not None:
                st["timer"].cancel()
            self._dgt_finalize_locked(pk, st["round"])

    def _dgt_finalize(self, pk, rnd: int):
        """Deadline fired: merge the push with its missing deferred
        blocks as zeros.  No-op if the set completed in the meantime."""
        with self._lock:
            self._dgt_finalize_locked(pk, rnd)

    def _dgt_finalize_locked(self, pk, rnd: int):
        st = self._dgt_pending.get(pk)
        if st is None or st["round"] != rnd:
            return
        del self._dgt_pending[pk]
        part = self._p3_partial.get(pk)
        if part is None or part.gen != rnd:
            # the assembly moved on (the set completed and merged, or
            # was never fed): never force-merge a buffer from a
            # different round than this finalize's
            return
        self._p3_partial.pop(pk, None)
        grad = part.force()
        if grad is None:
            return
        proto = Msg(MsgType.PUSH, key=pk[1],
                    meta={"round": rnd,
                          "num_merge": st["num_merge"]})
        proto.sender = pk[0]
        # conn=None: every arrived chunk was already ACKed (the
        # client doesn't wait on deferred blocks); _reply no-ops
        self._push_locked(None, proto, pk[1], grad)

    def _p3_accumulate(self, msg: Msg, piece: np.ndarray):
        """Collect one P3 chunk; returns the reassembled tensor when the
        set completes, else None.  Caller holds self._lock.  Keyed by
        (sender, key): one chunked push per key per sender may be in
        flight, which the per-round push discipline guarantees.  The
        buffer is kept until the caller pops it post-merge, so a
        retransmitted final chunk can retry after a failure."""
        from geomx_tpu_torch.transport import ChunkAssembler
        pk = (msg.sender, msg.key)
        part = self._p3_partial.get(pk)
        if part is None:
            # monotonic per-key rounds: a stale straggler chunk (e.g. a
            # deferred best-effort block from an already-finalized round)
            # must not reset a newer round's assembly
            part = self._p3_partial[pk] = \
                ChunkAssembler(clear_on_complete=False, monotonic_gen=True)
        return part.feed(msg.meta, piece)

    @staticmethod
    def _rs_unique(rows_list, vals_list):
        """Merge row-sparse contributions: unique rows, duplicates
        summed.  Cost scales with the touched rows, not the tensor."""
        rows_cat = np.concatenate(rows_list)
        vals_cat = np.concatenate(vals_list)
        uniq, inverse = np.unique(rows_cat, return_inverse=True)
        vals_u = np.zeros((len(uniq),) + vals_cat.shape[1:], np.float32)
        np.add.at(vals_u, inverse, vals_cat)
        return uniq, vals_u

    def _push_locked(self, conn, msg: Msg, key: str, grad, rs=None,
                     sig=None):
        """The merge/apply body; caller holds self._lock.  ``rs`` is an
        optional (row_ids, row_values) pair for a row-sparse push.
        ``sig`` is the push's resend-dedup signature: an async-mode relay
        parks it until the relayed value installs, so retransmits of the
        in-flight push are neither re-merged nor falsely ACKed."""
        redirect = self._wrong_shard_reply_locked(key)
        if redirect is not None:
            # the range moved between the unlocked fast-path check and
            # this merge (rebalance quiesce): redirect, never merge
            if sig is not None:
                self._seen_pushes.pop(sig, None)
            self._reply(conn, msg, redirect)
            return
        st = self._store[key]
        if rs is not None and self.hfa_k2 is not None:
            self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                "error": "row-sparse pushes do not compose with HFA "
                         "(HFA workers push dense parameters)"}))
            return
        if self.mode == "async":
            # arrival-ordered apply (DataHandleAsyncDefault).  The WAN
            # push-through runs on the key-affine relay shard, never
            # inline under self._lock (a straggling global tier would
            # stall every other key, pulls and heartbeats for up to the
            # relay timeout); the pusher is ACKed after
            # the fresh value installs.
            rnd = int(msg.meta.get("round", st.round + 1))
            if rs is not None:
                rows_u, vals_u = self._rs_unique([rs[0]], [rs[1]])
                if self._gclients:
                    if sig is not None:
                        self._seen_pushes[sig] = "parked"
                    self._relay_enqueue(
                        key,
                        ((rows_u, vals_u), False, True, (conn, msg, sig),
                         rnd))
                    return
                self._apply_row_sparse(key, rows_u, vals_u)
            elif self._gclients:
                if sig is not None:
                    self._seen_pushes[sig] = "parked"
                self._relay_enqueue(
                    key, (grad, False, False, (conn, msg, sig), rnd))
                return
            else:
                self._apply(key, grad)
            r0 = msg.meta.get("round")
            if r0 is not None and msg.sender >= 0:
                # async mode counts merged rounds per sender too:
                # query_progress and the pull-reply durability proof
                # (the client's retained-frame release) need it —
                # bumped HERE, where the apply+journal happen under
                # one lock hold, never at relay park time (a parked
                # round is not yet durable)
                st.pushed[msg.sender] = max(
                    st.pushed.get(msg.sender, 0), int(r0))
            st.round += 1
            self._journal_round(key, st)  # async apply = one round
            st.led_rid = int(r0) if r0 is not None else st.round
            self._ledger_hop(key, st.led_rid, "merge",
                             party=msg.sender, detail={"mode": "async"})
            self._ledger_complete(key, st.led_rid)
            self._reply(conn, msg, Msg(MsgType.ACK, key=key))
            if self.ts_sched is not None:
                # async intra-TS: disseminate after every apply, like the
                # reference's TS_ApplyUpdates -> DefaultAutoPull.  Snapshot
                # with copy(): NativeSGD mutates st.value in place, and the
                # distributor thread serializes outside self._lock
                self._ap_queue.put((key, st.value.copy(), st.round))
            return
        # worker-rejoin safety: a restarted worker that died before its
        # push was ACKed replays it.  Pushes that carry a client round id
        # (meta["round"], maintained by GeoPSClient and restored by
        # recover()) are absorbed with an idempotent ACK when that round
        # was already merged from this sender — the recovery discipline
        # the reference gets from is_recovery + skipped barriers
        # (van.cc:165-212, kvstore_dist.h:63-67).
        r = msg.meta.get("round")
        if r is not None and msg.sender >= 0 and \
                int(r) <= st.pushed.get(msg.sender, 0):
            self._reply(conn, msg, Msg(MsgType.ACK, key=key))
            return
        # dense and row-sparse pushes must not mix within one sync round:
        # the round gate would have to invent semantics for the overlap
        if rs is not None and st.contribs or \
                rs is None and st.rs_rows:
            self._reply(conn, msg, Msg(MsgType.ERROR, meta={
                "error": "dense and row-sparse pushes mixed in one sync "
                         f"round for {key!r}"}))
            return
        if st.count == 0 and not st.rs_rows:
            # first contribution of a fresh round: the gate-wait phase
            # (ledger) measures from here to the gate close
            st.open_t = time.monotonic()
        if r is not None:
            st.open_rids.add(int(r))
        if rs is not None:
            st.rs_rows.append(rs[0])
            st.rs_vals.append(rs[1])
        else:
            prev = st.contribs.get(msg.sender)
            st.contribs[msg.sender] = grad if prev is None else \
                self._combine_contribs(prev, grad)
        # a TS relay-merged push carries the contributions of num_merge
        # workers (reference KVMeta.num_merge counting toward the sync
        # gate, kvstore_dist_server.h:1324)
        st.count += int(msg.meta.get("num_merge", 1))
        st.pushed[msg.sender] = st.pushed.get(msg.sender, 0) + 1
        self._reply(conn, msg, Msg(MsgType.ACK, key=key))
        if st.count >= self.num_workers:
            self._complete_merge_locked(key, st)

    @staticmethod
    def _combine_contribs(prev, new):
        """Two pushes from ONE sender within a round: merge them.  Two
        sparse contributions merge by sorted-index (still compressed);
        any dense participant densifies the pair."""
        if isinstance(prev, _SparsePairs) and isinstance(new, _SparsePairs):
            from geomx_tpu_torch.compression.sparseagg import merge_pairs_host
            mv, mi = merge_pairs_host([(prev.vals, prev.idx),
                                       (new.vals, new.idx)])
            return _SparsePairs(mv, mi, new.n, new.shape)
        return _contrib_dense(prev) + _contrib_dense(new)

    def _complete_merge_locked(self, key: str, st: _KeyState):
        """Close a full sync round for ``key``: apply or relay the merge
        and finish the round.  Caller holds self._lock and has checked
        ``st.count >= self.num_workers``.  Factored out of _push_locked
        so worker eviction (resilience/) can close rounds the evicted
        worker would otherwise stall forever.

        The merge sums the per-sender contributions in SORTED sender
        order: float addition is not associative, so an arrival-ordered
        running sum would tie the merged bits to thread scheduling —
        sorted-order summation is what makes a 16+-party chaos replay
        bit-exact against its uninterrupted baseline.  Sparse (value,
        index) contributions merge in the same sorted-sender order by
        sorted-index segment fold (compression/sparseagg.py
        merge_pairs_host) and the result STAYS sparse: O(k log k) host
        work, no densify until a dense consumer actually reads."""
        t_gate = time.monotonic()
        gate_wait = 0.0 if st.open_t is None else \
            max(0.0, t_gate - st.open_t)
        n_contribs = len(st.contribs)
        merged = None
        if st.contribs:
            parts = [st.contribs[s] for s in sorted(st.contribs)]
            if all(isinstance(p, _SparsePairs) for p in parts):
                from geomx_tpu_torch.compression.sparseagg import merge_pairs_host
                mv, mi = merge_pairs_host(
                    [(p.vals, p.idx) for p in parts])
                merged = _SparsePairs(mv, mi, parts[-1].n,
                                      parts[-1].shape)
                self._m_sparse_merges.inc()
            else:
                dense = [_contrib_dense(p) for p in parts]
                merged = dense[0]
                for g in dense[1:]:
                    merged = merged + g
        st.contribs, st.count = {}, 0
        rnd = st.round + 1  # the round this merge completes
        # ledger round ids: the CLIENT round numbering the pushes
        # declared (it survives re-routing/migration; the server's own
        # completion count is the fallback when pushes carried none).
        # More than one id means a coalesced merge (see _KeyState).
        led_rids = sorted(st.open_rids) if st.open_rids else [rnd]
        st.open_rids = set()
        st.open_t = None
        st.led_rid = led_rids[-1]
        st.led_rids = led_rids
        self.profiler.instant(f"ServerMerge:{key}", "kvstore",
                              args={"key": key, "round_id": rnd})
        merge_dur = time.monotonic() - t_gate
        for lr in led_rids:
            self._ledger_hop(key, lr, "merge",
                             dur_s=merge_dur,
                             detail={"contribs": n_contribs,
                                     "server_round": rnd,
                                     "gate_wait_s": round(gate_wait, 6),
                                     **({"coalesced": len(led_rids)}
                                        if len(led_rids) > 1 else {})})
            self._ledger_phase(key, lr, "gate_wait", gate_wait)
            self._ledger_phase(key, lr, "merge", merge_dur)
        if st.rs_rows:
            rows_u, vals_u = self._rs_unique(st.rs_rows, st.rs_vals)
            st.rs_rows, st.rs_vals = [], []
            if self._gclients:
                self._relay_enqueue(
                    key, ((rows_u, vals_u), False, True, None, rnd))
                return
            self._apply_row_sparse(key, rows_u, vals_u)
            self._finish_round_locked(key, st)
            return
        if self._gclients:
            if self.hfa_k2 is not None:
                # HFA: `merged` is the party-average parameters (workers
                # push params/num_workers).  Apply it every round so
                # pulls see fresh aggregates — the reference calls
                # ApplyUpdates every round and skips only the WAN hop
                # (kvstore_dist_server.h:1326-1332)
                self._apply(key, _contrib_dense(merged))
                if (st.round + 1) % self.hfa_k2 == 0:
                    # milestone sync: relay the normalized delta
                    # (kvstore_dist_server.h:1334-1338).  The global
                    # tier runs in accumulate mode and holds the real
                    # model (init + every synced delta), so the pull
                    # returns authoritative params — parties whose
                    # milestones ever disagreed reconverge here,
                    # unlike rebasing on the local milestone.
                    # The WAN hop itself runs on the relay thread so
                    # a straggler party's global barrier cannot stall
                    # this server's other keys/pulls/heartbeats;
                    # the round completes on install.
                    delta = (st.value.astype(np.float32) - st.milestone) \
                        / self.num_global_workers
                    self._relay_enqueue(key, (delta, True, False, None,
                                              rnd))
                    return
            else:
                # the WAN relay transports dense party aggregates (its
                # own compressor re-sparsifies on the hop if configured)
                self._relay_enqueue(
                    key, (_contrib_dense(merged), False, False, None, rnd))
                return
        else:
            self._apply_merged(key, merged)
        self._finish_round_locked(key, st)

    def _apply_merged(self, key: str, merged) -> None:
        """Merged round -> store, staying in the compressed domain when
        the store semantics allow: an overwrite store installs the pair
        set lazily (pulls of the round can reply sparse), an accumulate
        store adds the k pairs in place (O(k)); optimizer stores need
        the dense gradient and densify the MERGED set once per round —
        still never once per push."""
        if isinstance(merged, _SparsePairs) and self._tx is None \
                and self._native_sgd is None:
            st = self._store[key]
            valid = merged.idx >= 0
            if self.accumulate:
                base = st.value  # folds any pending sparse round first
                flat = base.reshape(-1)
                np.add.at(flat, merged.idx[valid],
                          merged.vals[valid].astype(flat.dtype,
                                                    copy=False))
                st.value = base
            else:
                st.set_sparse_value(merged.vals[valid], merged.idx[valid])
            return
        self._apply(key, _contrib_dense(merged))

    def evict_worker(self, sender: int) -> int:
        """Server-side worker eviction (resilience/): shrink the sync
        gate by one so the surviving workers' rounds complete instead of
        stalling forever on a dead worker's pushes.  Any gradient the
        evicted worker already merged into the open round stands
        (excising it would need per-sender un-merge the additive store
        cannot express), but it no longer counts toward the gate — the
        round still waits for EVERY survivor instead of closing one push
        early.  Rounds the smaller gate now satisfies close immediately.
        Repeated eviction of the same sender is rejected (two liveness
        agents reacting to one death must not shrink the gate twice);
        the caller owns id validity — a worker that died before its
        first push is a legitimate eviction the server cannot vet.
        Returns the new num_workers."""
        with self._lock:
            if self.num_workers <= 1:
                raise ValueError(
                    "cannot evict below one worker: stop the server "
                    "instead (an empty party has no rounds to complete)")
            if sender in self._evicted:
                raise ValueError(
                    f"worker {sender} already evicted: a second eviction "
                    "would shrink the sync gate past the real survivor "
                    "count")
            self._evicted.add(sender)
            self.num_workers -= 1
            self._journal({"k": "evict", "sender": int(sender),
                           "num_workers": self.num_workers})
            for key, st in list(self._store.items()):
                pushed = st.pushed.pop(sender, 0)
                if pushed > st.round and st.count > 0:
                    # the evicted worker contributed to the OPEN round:
                    # its merge stands, but uncounting it keeps the gate
                    # waiting for all num_workers survivors
                    st.count -= 1
                if 0 < st.count and st.count >= self.num_workers:
                    self._complete_merge_locked(key, st)
        self.heartbeats.unregister(sender)
        self._m_evictions.inc()
        self._m_workers.set(self.num_workers)
        self.profiler.instant("ServerEvictWorker", "kvstore",
                              args={"sender": sender,
                                    "num_workers": self.num_workers})
        return self.num_workers

    def _finish_round_locked(self, key: str, st: _KeyState):
        """Complete a sync round: bump the round counter, answer the pulls
        it unblocks, feed the TS distributor.  Caller holds self._lock."""
        st.round += 1
        led_rid = st.led_rid if st.led_rid is not None else st.round
        led_rids = st.led_rids or [led_rid]
        # write-ahead: the round is durable BEFORE any pull can observe
        # its value — a crash after a client saw round r always replays
        # to a state that includes round r
        t_j = time.monotonic()
        self._journal_round(key, st)
        if self._durable is not None:
            jd = time.monotonic() - t_j
            for lr in led_rids:
                self._ledger_hop(key, lr, "journal", dur_s=jd)
                self._ledger_phase(key, lr, "journal", jd)
        self._m_rounds.inc()
        t_rep = time.monotonic()
        still = []
        for c, req, need in st.waiting_pulls:
            if st.round >= need:
                rows = req.meta.get("rows")
                sparse = self._sparse_reply_locked(st, req) \
                    if rows is None else None
                val = None if sparse is not None else (
                    st.value if rows is None else
                    st.value[np.asarray(rows, np.int64)])
                self.profiler.instant(
                    f"ServerPull:{key}", "kvstore",
                    args={"key": key, "round_id": st.round,
                          "sender": req.sender})
                for lr in led_rids:
                    self._ledger_hop(key, lr, "reply",
                                     party=req.sender)
                try:
                    self._reply_pull_value(
                        c, req, key, val,
                        pushed=st.pushed.get(req.sender, 0),
                        sparse=sparse, round_=led_rid)
                except OSError:
                    pass  # dead waiter (crashed worker): drop its entry —
                    # the round must still complete for the live ones
            else:
                still.append((c, req, need))
        st.waiting_pulls = still
        for lr in led_rids:
            self._ledger_phase(key, lr, "reply",
                               time.monotonic() - t_rep)
            self._ledger_complete(key, lr)
        if self.ts_sched is not None:
            # hand an immutable snapshot to the distributor thread:
            # blocking sends must not run under self._lock (a stalled
            # client would freeze the whole tier), and NativeSGD
            # mutates st.value in place on later rounds
            self._ap_queue.put((key, st.value.copy(), st.round))

    def _relay_enqueue(self, key: str, job: tuple):
        """Queue a WAN relay job on the key's hash-affine worker shard
        (lazily spawned, at most _relay_shards threads).  Caller holds
        self._lock."""
        if not self._running:
            return  # racing a stop(): don't spawn a worker that would
            # relay against closed global links and leak
        import zlib
        shard = zlib.crc32(key.encode("utf-8")) % self._relay_shards
        q = self._relay_qs.get(shard)
        if q is None:
            q = self._relay_qs[shard] = queue.Queue()
            threading.Thread(target=self._relay_loop, args=(q,),
                             daemon=True).start()
        # the enqueue timestamp is the ledger's queue phase zero: time
        # a round spends parked behind its key-affine shard's FIFO
        q.put((key, job, time.monotonic()))

    def _relay_loop(self, q: "queue.Queue"):
        """WAN-relay worker: the blocking push-through to the global tier
        runs here, never under self._lock, so one straggling party cannot
        freeze this server's pulls/pushes/heartbeats.  Jobs are FIFO per
        shard, preserving each key's round order."""
        while True:
            item = q.get()
            if item is None:
                return
            # ``reply_to`` is (conn, request) for an async-mode push whose
            # ACK is deferred until the relayed value installs; None for
            # sync-mode rounds (their ACKs went out at merge time and the
            # round completes via _finish_round_locked).  ``round_`` is
            # the WAN round id the relay belongs to (telemetry/tracing).
            key, (payload, is_milestone, is_rs, reply_to, round_), \
                enq_t = item
            queue_s = max(0.0, time.monotonic() - enq_t)
            t_relay = time.perf_counter()
            try:
                if is_rs:
                    rs_rows, rs_vals = payload
                    fresh = self._relay_row_sparse(key, rs_rows, rs_vals,
                                                   round_=round_)
                else:
                    fresh = self._relay_to_global(key, payload,
                                                  round_=round_)
                relay_s = time.perf_counter() - t_relay
                self._m_relay_s.observe(relay_s)
            except Exception as e:
                self._m_relay_fail.inc()
                # loss observation for the LinkObservatory's trace replay
                # (telemetry/links.py): a failed WAN round is one lost
                # transfer on this party's uplink
                self.profiler.instant(
                    f"RelayFailure:{key}", "comm",
                    args={"key": key, "round_id": round_})
                # the round can never complete: fail current waiters fast
                # with the reason, latch the error so pulls that arrive
                # AFTER the failure (the common case — the network round
                # trip races the exception) also fail instead of parking
                # forever, and log it server-side
                import sys
                print(f"[geomx-ps rank {self.rank}] global relay failed "
                      f"for {key!r}: {e!r}", file=sys.stderr, flush=True)
                if reply_to is not None:
                    # async mode: the pusher is still waiting — fail its
                    # request directly instead of latching the key, and
                    # roll the parked dedup signature back so a fresh
                    # retransmit re-merges instead of vanishing
                    if reply_to[2] is not None:
                        with self._lock:
                            self._seen_pushes.pop(reply_to[2], None)
                    try:
                        self._reply(reply_to[0], reply_to[1],
                                    Msg(MsgType.ERROR, meta={
                                        "error": f"global relay failed: "
                                                 f"{e!r}"}))
                    except OSError:
                        pass
                    continue
                with self._lock:
                    st = self._store.get(key)
                    if st is None:
                        continue
                    st.relay_error = f"global relay failed: {e!r}"
                    waiters, st.waiting_pulls = st.waiting_pulls, []
                    try:
                        # EVERY round still open on the key can never
                        # complete (the latched relay_error fails all
                        # its future pulls): close them all as
                        # orphaned instead of leaking open records
                        from geomx_tpu_torch.telemetry.ledger import \
                            get_round_ledger
                        get_round_ledger().orphan(
                            key=key, reason="relay_failed")
                    except Exception:
                        pass
                for c, req, _need in waiters:
                    err = Msg(MsgType.ERROR,
                              meta={"error": st.relay_error})
                    rid = req.meta.get("rid")
                    if rid is not None:
                        err.meta["rid"] = rid
                    try:
                        self._send_msg(c, err)
                    except OSError:
                        pass
                continue
            try:
                nb = int(rs_vals.nbytes + rs_rows.nbytes) if is_rs \
                    else int(np.asarray(payload).nbytes)
            except Exception:
                nb = None
            with self._lock:
                st = self._store[key]
                if is_rs:
                    v = st.value.copy()
                    v[np.asarray(rs_rows, np.int64)] = fresh
                    st.value = v
                else:
                    st.value = fresh
                if is_milestone:
                    st.milestone = fresh.copy()
                if reply_to is None:
                    self._ledger_hop(key, st.led_rid, "relay",
                                     dur_s=relay_s, nbytes=nb,
                                     detail={"queue_s":
                                             round(queue_s, 6)})
                    self._ledger_phase(key, st.led_rid, "queue",
                                       queue_s)
                    self._finish_round_locked(key, st)
                else:
                    # async mode: arrival-ordered round bump + TSEngine
                    # dissemination, mirroring the non-relay apply path;
                    # the parked dedup signature completes — retransmits
                    # are idempotently ACKed from here on
                    if reply_to[2] is not None:
                        self._seen_pushes[reply_to[2]] = True
                    req0 = reply_to[1]
                    r0 = req0.meta.get("round")
                    if r0 is not None and req0.sender >= 0:
                        # the parked push is durable only NOW, at
                        # install: bump the sender's merged-round count
                        # here (see the direct-apply branch)
                        st.pushed[req0.sender] = max(
                            st.pushed.get(req0.sender, 0), int(r0))
                    st.round += 1
                    self._journal_round(key, st)
                    st.led_rid = int(r0) if r0 is not None else st.round
                    self._ledger_hop(key, st.led_rid, "relay",
                                     dur_s=relay_s, nbytes=nb,
                                     detail={"queue_s":
                                             round(queue_s, 6)})
                    self._ledger_phase(key, st.led_rid, "queue", queue_s)
                    self._ledger_hop(key, st.led_rid, "merge",
                                     party=req0.sender,
                                     detail={"mode": "async_relay"})
                    self._ledger_complete(key, st.led_rid)
                    if self.ts_sched is not None:
                        self._ap_queue.put((key, st.value.copy(), st.round))
            if reply_to is not None:
                try:
                    self._reply(reply_to[0], reply_to[1],
                                Msg(MsgType.ACK, key=key))
                except OSError:
                    pass  # pusher died; the install stands

    def _autopull_loop(self):
        while self._running or not self._ap_queue.empty():
            try:
                item = self._ap_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._autopull_distribute(*item)

    def _autopull_distribute(self, key: str, value: np.ndarray,
                             round_: int):
        """One TSEngine dissemination round: ASK the scheduler for
        receivers in measured-throughput order, send the fresh value to
        each, and report the observed throughput back (the server-side
        half of AutoPullUpdate; send-side timing stands in for the
        reference's receiver-measured piggyback).  Runs on the distributor
        thread, never under the store lock."""
        from geomx_tpu_torch.transport.tsengine import STOP
        sched = self.ts_sched
        version = sched.iters + 1
        while True:
            r = sched.ask(0, version)
            if r == STOP:
                return
            conn = self._ap_conns.get(r)
            if conn is None:
                continue  # ask() marked the index busy; nothing to send
            msg = Msg(MsgType.AUTOPULL, key=key, array=value,
                      meta={"version": round_})
            t0 = time.perf_counter()
            try:
                self._send_msg(conn, msg)
            except OSError:
                # dead receiver: evict so later rounds stop paying for it
                # (a reconnecting worker re-registers under its sender id)
                self._ap_conns.pop(r, None)
                continue
            dt = max(time.perf_counter() - t0, 1e-9)
            sched.report(0, r, value.nbytes / dt, version)

    def _handle_pull(self, conn, msg: Msg):
        self._m_pulls.inc()
        with self._lock:
            self._load_pulls += 1
            redirect = self._wrong_shard_reply_locked(msg.key)
            if redirect is not None:
                self._reply(conn, msg, redirect)
                return
            st = self._store.get(msg.key)
            if st is None:
                self._reply(conn, msg, Msg(MsgType.ERROR,
                                           meta={"error": f"no key {msg.key}"}))
                return
            # a puller that has contributed to round r must see the post-r
            # value; pulls never wait on rounds they did not join (that
            # deadlocks cross-worker pipelining — the reference gates on
            # per-round request bookkeeping, kvstore_dist_server.h:1138-1168)
            # a puller that relayed its contribution through a TS peer
            # never pushed directly; meta["min_round"] gates its pull on
            # the aggregation round it joined
            need = max(st.pushed.get(msg.sender, 0),
                       int(msg.meta.get("min_round", 0)))
            if self.mode == "sync" and st.round < need:
                if st.relay_error is not None:
                    # this round is lost (WAN relay failed) — fail fast
                    self._reply(conn, msg, Msg(
                        MsgType.ERROR, meta={"error": st.relay_error}))
                    return
                rid = msg.meta.get("rid")
                # a resent PULL (same connection, same rid) must not queue
                # twice — the original entry will answer it; different
                # connections may legitimately collide on rid
                if rid is None or all(
                        not (w[0] is conn and w[1].meta.get("rid") == rid)
                        for w in st.waiting_pulls):
                    st.waiting_pulls.append((conn, msg, need))
                return
            rows = msg.meta.get("rows")
            sparse = self._sparse_reply_locked(st, msg) \
                if rows is None else None
            val = None if sparse is not None else (
                st.value if rows is None else
                st.value[np.asarray(rows, np.int64)])
            self.profiler.instant(
                f"ServerPull:{msg.key}", "kvstore",
                args={"key": msg.key, "round_id": st.round,
                      "sender": msg.sender})
            led = st.led_rid if st.led_rid is not None else st.round
            if led:
                # pulls legitimately arrive after the round completed:
                # the reply hop appends to the completed ledger record
                # (every round a coalesced merge closed gets it)
                for lr in (st.led_rids or [led]):
                    self._ledger_hop(msg.key, lr, "reply",
                                     party=msg.sender)
            self._reply_pull_value(conn, msg, msg.key, val,
                                   pushed=st.pushed.get(msg.sender, 0),
                                   sparse=sparse, round_=led or None)

    @staticmethod
    def _sparse_reply_locked(st: _KeyState, req: Msg):
        """(vals, idx, n, shape) when this pull can be answered from a
        sparse-pending round WITHOUT densifying: the requester opted in
        (``sparse_ok`` — its client decompresses once), the round is
        sparse-pending, and every index fits the pair wire format's
        float32-exact range.  Otherwise None (dense reply)."""
        from geomx_tpu_torch.compression.sparseagg import PAIR_WIRE_MAX_N
        sp = st.sparse_value
        if sp is None or not req.meta.get("sparse_ok"):
            return None
        n = st.dense_size
        if n >= PAIR_WIRE_MAX_N:  # idx rides the f32 half of the pairs
            return None
        return sp[0], sp[1], n, st.dense_shape

    def _reply_pull_value(self, conn, req: Msg, key: str, val,
                          pushed: Optional[int] = None,
                          sparse: Optional[tuple] = None,
                          round_: Optional[int] = None):
        """Answer a PULL: whole tensor directly, or — when the request
        opted into P3 pull chunking and the tensor is big — as
        priority-tagged chunks through the connection's priority send
        queue (reference P3_ZPull slicing the reply the same way the
        push side slices, kv_app.h:246-306).

        ``pushed`` is the requester's merged-round count at reply time
        (journaled write-ahead of this reply): the proof the client's
        session-resume layer needs to release its retained re-push
        frames for rounds <= it — a reply alone proves nothing about a
        push pipelined AFTER the pull was issued.

        ``sparse`` (vals, idx, n, shape): answer from a sparse-merged
        round in the compressed pair format (the relay wire format —
        values then f32-cast indices); the requester's client
        decompresses ONCE.  Sparse replies are pair-sized and bypass
        P3 chunking.

        ``round_`` is the ledger round this reply answers: it rides
        the reply meta so the encode/decode choke point attributes the
        reply's wire bytes to the right (key, round) record."""
        if sparse is not None:
            from geomx_tpu_torch.compression.sparseagg import encode_pairs_payload
            mvals, midx, n, shape = sparse
            reply = Msg(MsgType.PULL_REPLY, key=key,
                        meta={"comp": "bsc", "n": int(n),
                              "shape": list(shape)},
                        array=encode_pairs_payload(mvals, midx))
            if pushed is not None:
                reply.meta["pushed"] = int(pushed)
            if round_ is not None:
                reply.meta["round"] = int(round_)
            self._reply(conn, req, reply)
            return
        ce = req.meta.get("p3_chunk_elems")
        if not ce or val.size <= int(ce):
            reply = Msg(MsgType.PULL_REPLY, key=key, array=val)
            if pushed is not None:
                reply.meta["pushed"] = int(pushed)
            if round_ is not None:
                reply.meta["round"] = int(round_)
            self._reply(conn, req, reply)
            return
        ce = int(ce)
        flat = np.asarray(val, np.float32).reshape(-1)
        n = int(flat.size)
        num = -(-n // ce)
        prio = int(req.meta.get("priority", 0))
        rid = req.meta.get("rid")
        # one generation id per reply: a retransmitted PULL re-sliced
        # from a newer value must not blend with the first reply's
        # chunks in the client's assembler
        gen = next(self._pull_gen)
        q = self._conn_out_q(conn)
        for i in range(num):
            rep = Msg(MsgType.PULL_REPLY, key=key,
                      meta={"chunk": i, "num_chunks": num, "start": i * ce,
                            "n_total": n, "shape": list(val.shape),
                            "gen": gen,
                            **({} if round_ is None
                               else {"round": int(round_)}),
                            **({} if pushed is None
                               else {"pushed": int(pushed)})},
                      array=flat[i * ce:(i + 1) * ce])
            if rid is not None:
                rep.meta["rid"] = rid
            frame = rep.encode()
            if _verbose_level() >= 2:
                _log_msg("ENQ ", rep, len(frame))
            try:
                q.push(frame, prio)
            except RuntimeError as e:
                # queue closed under us (connection torn down): surface
                # as the connection error it is, which every reply site
                # already tolerates
                raise OSError(f"connection closed: {e}") from e

    def _conn_out_q(self, conn):
        """Lazily create the per-connection priority send queue + drain
        thread (the server half of the P3 send discipline: queued chunk
        replies leave in priority order, not submission order)."""
        qid = id(conn)
        with self._outq_lock:
            q = self._out_qs.get(qid)
            if q is None:
                if conn not in self._conns:
                    # the waiter is gone (its serve thread already cleaned
                    # up); creating a queue now would leave a stale entry
                    # that an id()-reusing NEW connection could inherit
                    raise OSError("connection closed")
                from geomx_tpu_torch.transport import PrioritySendQueue
                q = self._out_qs[qid] = PrioritySendQueue()
                gate = self._out_gates.get(qid)
                if gate is None:  # don't undo a pause_pull_stream that
                    gate = self._out_gates[qid] = threading.Event()
                    gate.set()

                def drain():
                    while True:
                        frame = q.pop()
                        if frame is None:
                            return
                        gate.wait()
                        frames = [frame]
                        if batch_drain_enabled():
                            # small-key round batching (mirrors the
                            # client _send_loop): coalesce everything
                            # already queued into one sendall; frames
                            # keep their length prefixes, the peer's
                            # recv loop is oblivious
                            total = len(frame) + 4
                            while (len(frames) < BATCH_DRAIN_MAX_FRAMES
                                   and total < BATCH_DRAIN_MAX_BYTES):
                                extra = q.pop(timeout=0)
                                if extra is None:
                                    break
                                frames.append(extra)
                                total += len(extra) + 4
                        blob = b"".join(
                            len(f).to_bytes(4, "little") + f
                            for f in frames)
                        lock = self._conn_wlocks.setdefault(
                            qid, threading.Lock())
                        with lock:
                            try:
                                conn.sendall(blob)
                                if len(frames) == 1:
                                    wire_stats.add_sent(len(blob))
                                else:
                                    wire_stats.add_sent_batch(
                                        len(frames), len(blob))
                            except OSError:
                                # dead socket: drop our queue entry (only
                                # if still ours — the serve thread may
                                # have cleaned up and a new conn reused
                                # the id)
                                with self._outq_lock:
                                    if self._out_qs.get(qid) is q:
                                        self._out_qs.pop(qid, None)
                                q.close()
                                return
                threading.Thread(target=drain, daemon=True).start()
        return q
