"""ShardedGlobalClient — a worker's line to the key-range sharded global
tier (port of geomx_tpu/service/sharded.py).

The scheduler owns a versioned :class:`~geomx_tpu_torch.service.shardmap.
ShardMap`; this wrapper fetches it, keeps one :class:`GeoPSClient` per
shard, and routes every key to its range owner.  Three failure shapes
are absorbed here so the training loop above sees a stall, never an
error:

- **stale map** — a shard answers with a ``wrong_shard`` redirect
  (carrying its map version); the wrapper re-fetches a map at least
  that fresh from the scheduler and re-routes.  A replayed push is
  idempotent under the migrated per-sender round counts, so a
  rebalance mid-round merges exactly once;
- **shard restart in place** — the per-shard client's built-in session
  resume (generation token -> ``query_progress`` -> retained-frame
  re-push, P3 chunk sets included) handles it below this layer;
- **shard failover** — the shard's journal replayed into a replacement
  on a NEW port (map bump): the dead client's window expires, the
  wrapper polls the map, rebuilds the client, and replays the
  WRAPPER-retained in-flight round through the same round dedup.

Round ids are owned HERE (``meta["round"]`` on every push), not by the
per-shard clients: a key's rounds belong to the key, and must survive
re-routing to a different shard client mid-stream.

The wrapper records ``REDIRECT`` and ``FAILOVER_REPLAY`` hops in the
fleet round ledger (``telemetry/ledger.py``), naming the shard and the
map version, so a round's record shows its re-routes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from geomx_tpu_torch.config import _env
from geomx_tpu_torch.service.client import GeoPSClient, WrongShardError
from geomx_tpu_torch.service.protocol import env_int
from geomx_tpu_torch.service.scheduler import SchedulerClient
from geomx_tpu_torch.service.shardmap import ShardMap, even_bounds


def default_num_shards() -> int:
    """``GEOMX_GLOBAL_SHARDS`` (default 1 — the unsharded tier)."""
    return max(1, _env(("GEOMX_GLOBAL_SHARDS",), 1, int))


def start_sharded_global_tier(scheduler_addr: Tuple[str, int],
                              num_shards: Optional[int] = None,
                              num_workers: int = 1,
                              mode: str = "sync",
                              accumulate: bool = True,
                              durable_dir: Optional[str] = None,
                              optimizer=None,
                              heartbeat_timeout: float = 15.0,
                              device=None) -> list:
    """Spawn ``num_shards`` GeoPSServer shard instances with even
    key-range bounds and install the version-1 map at the scheduler.
    Each shard journals through its OWN DurableStateStore name
    (``shard<i>`` under ``durable_dir``), so a shard kill/restart — or
    a failover replay into a replacement on a new port — recovers only
    its ranges while the rest of the tier keeps merging.  ``device`` is
    each shard's (``resolve_device``: the card unless ``"cpu"``), where
    a server-side optimizer other than the native SGD runs.  Returns the
    server list (index order = range order)."""
    if num_shards is None:
        num_shards = default_num_shards()
    from geomx_tpu_torch.service.server import GeoPSServer
    bounds = even_bounds(num_shards)
    servers = [
        GeoPSServer(num_workers=num_workers, mode=mode,
                    accumulate=accumulate, optimizer=optimizer,
                    rank=i, shard_index=i,
                    shard_range=(bounds[i], bounds[i + 1]),
                    shard_map_version=1,
                    heartbeat_timeout=heartbeat_timeout,
                    durable_dir=durable_dir,
                    durable_name=f"shard{i}", device=device).start()
        for i in range(num_shards)]
    sc = SchedulerClient(scheduler_addr)
    try:
        sc.init_shard_map([("127.0.0.1", srv.port) for srv in servers])
    finally:
        sc.close()
    return servers


class ShardedGlobalClient:
    """Route init/push/pull over the scheduler's shard map, with
    redirect-driven map refresh and failover re-join."""

    def __init__(self, scheduler_addr: Tuple[str, int],
                 sender_id: int = 0,
                 reconnect: Optional[bool] = None,
                 p3_slice_elems: Optional[int] = None,
                 reconnect_timeout_s: float = 10.0,
                 map_timeout_s: float = 60.0,
                 op_timeout_s: float = 120.0):
        self.sender_id = int(sender_id)
        if reconnect is None:
            reconnect = bool(env_int(("GEOMX_RECONNECT",), 0))
        self._reconnect = bool(reconnect)
        self._p3_slice_elems = p3_slice_elems
        self._reconnect_timeout_s = float(reconnect_timeout_s)
        self._op_timeout_s = float(op_timeout_s)
        self._sched = SchedulerClient(scheduler_addr)
        self._map = ShardMap.from_meta(
            self._sched.wait_shard_map(timeout=map_timeout_s))
        self._clients: Dict[int, GeoPSClient] = {}
        self._lock = threading.Lock()
        # wrapper-owned per-key round ids + the in-flight round's
        # gradient, retained for the failover re-push (released when
        # the round's pull reply is consumed, like the client layer).
        # The wrapper copy is a SECOND retention layer on top of the
        # per-shard client's frame set — it too rides the
        # geomx_resend_buffer_bytes gauge (same sender label: the
        # children compose additively via inc/dec)
        self._rounds: Dict[str, int] = {}
        self._retained: Dict[str, tuple] = {}
        from geomx_tpu_torch.telemetry import get_registry
        self._m_resend_buf = get_registry().gauge(
            "geomx_resend_buffer_bytes",
            "Bytes of retained session-resume re-push frames",
            ("sender",)).labels(str(self.sender_id))

    @property
    def map_version(self) -> int:
        return self._map.version

    # ---- map / client plumbing --------------------------------------------

    def _client(self, idx: int) -> GeoPSClient:
        with self._lock:
            c = self._clients.get(idx)
            if c is None:
                c = self._clients[idx] = GeoPSClient(
                    self._map.addr_of(idx), sender_id=self.sender_id,
                    reconnect=self._reconnect,
                    p3_slice_elems=self._p3_slice_elems,
                    reconnect_timeout_s=self._reconnect_timeout_s)
            return c

    def refresh_map(self, min_version: int = 0,
                    timeout: float = 30.0) -> ShardMap:
        """Fetch a map with ``version >= min_version``; clients whose
        shard address changed are torn down (rebuilt lazily)."""
        new = ShardMap.from_meta(self._sched.wait_shard_map(
            timeout=timeout, min_version=min_version))
        with self._lock:
            old = self._map
            if new.version <= old.version:
                return old
            stale = [i for i in list(self._clients)
                     if i >= new.num_shards
                     or new.addr_of(i) != old.addr_of(i)]
            for i in stale:
                _close_quietly(self._clients.pop(i))
            self._map = new
            return new

    def _rebuild_client(self, idx: int) -> GeoPSClient:
        with self._lock:
            c = self._clients.pop(idx, None)
        if c is not None:
            _close_quietly(c)
        return self._client(idx)

    def _rejoin(self, idx: int, deadline: float) -> None:
        """The shard's connection died for good (its client's reconnect
        window expired): either it restarted slowly in place, or it
        failed over to a new port.  Poll the map briefly for an address
        change, rebuild the client, and replay the wrapper-retained
        in-flight rounds the replacement's journal does not cover."""
        old_addr = self._map.addr_of(idx)
        poll_until = min(deadline,
                         time.monotonic() + self._reconnect_timeout_s)
        while time.monotonic() < poll_until:
            try:
                self.refresh_map(timeout=2.0)
            except TimeoutError:
                pass
            if self._map.addr_of(idx) != old_addr:
                break
            time.sleep(0.2)
        c = self._rebuild_client(idx)
        prog = c.recover()
        for key, held in list(self._retained.items()):
            rnd, grad, prio, meta = held
            if self._map.shard_for(key) == idx and \
                    prog.get(key, 0) < rnd:
                # the round died with the old incarnation: re-push it
                # (idempotent under the per-sender round dedup if a
                # durable copy survived after all)
                c.push(key, grad, priority=prio,
                       meta={**meta, "round": rnd})
                try:
                    # ledger: the failover is attributed to the exact
                    # round it interrupted, on the named shard
                    from geomx_tpu_torch.telemetry.ledger import (
                        FAILOVER_REPLAY, record_hop)
                    record_hop(key, rnd, FAILOVER_REPLAY,
                               party=self.sender_id, shard=idx,
                               nbytes=int(grad.nbytes),
                               detail={"map_version": self._map.version,
                                       "addr_changed":
                                       self._map.addr_of(idx) != old_addr})
                except Exception:
                    pass

    def _routed(self, key: str, op):
        """Run ``op(client)`` against the key's current range owner,
        absorbing redirects (stale map) and dead shards (restart /
        failover) until the op deadline."""
        deadline = time.monotonic() + self._op_timeout_s
        while True:
            idx = self._map.shard_for(key)
            c = self._client(idx)
            try:
                return op(c)
            except WrongShardError as e:
                # redirect observability: exactly one retry count per
                # redirect, and a ledger hop naming the refusing shard and
                # the map version it held — the round's record shows the
                # re-route instead of a mystery latency bump
                from geomx_tpu_torch.service.retry import count_retry
                count_retry("redirect")
                try:
                    from geomx_tpu_torch.telemetry.ledger import (
                        REDIRECT, record_hop)
                    rnd = self._rounds.get(key)
                    if rnd:
                        record_hop(key, rnd, REDIRECT,
                                   party=self.sender_id, shard=idx,
                                   detail={"map_version":
                                           int(e.map_version)})
                except Exception:
                    pass
                want = max(int(e.map_version), self._map.version + 1)
                try:
                    self.refresh_map(min_version=want, timeout=max(
                        0.5, min(30.0, deadline - time.monotonic())))
                except TimeoutError:
                    time.sleep(0.1)
            except (ConnectionError, TimeoutError, OSError):
                if time.monotonic() >= deadline:
                    raise
                try:
                    self._rejoin(idx, deadline)
                except (ConnectionError, TimeoutError, OSError,
                        RuntimeError):
                    time.sleep(0.2)  # still down: keep trying to the
                    # op deadline (a restart may land any moment)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"sharded op on key {key!r} exceeded "
                    f"{self._op_timeout_s}s (map v{self._map.version})")

    # ---- KVWorker surface --------------------------------------------------

    def init(self, key: str, value: np.ndarray,
             meta: Optional[dict] = None) -> None:
        self._routed(key, lambda c: c.init(key, value, meta=meta))

    def _retain(self, key: str, rnd: int, g: np.ndarray,
                priority: int, meta: Optional[dict] = None) -> None:
        with self._lock:
            prev = self._retained.get(key)
            if prev is not None:
                self._m_resend_buf.dec(prev[1].nbytes)
            self._retained[key] = (rnd, g, priority, dict(meta or {}))
            self._m_resend_buf.inc(g.nbytes)

    def _release(self, key: str) -> None:
        with self._lock:
            held = self._retained.pop(key, None)
            if held is not None:
                self._m_resend_buf.dec(held[1].nbytes)

    def push(self, key: str, grad: np.ndarray, priority: int = 0,
             meta: Optional[dict] = None) -> None:
        """``meta`` passes through to the shard push (e.g. the
        compressed-pair wire header ``{"comp": "bsc", "n": ..,
        "shape": ..}`` of the sparse server merge) — retained alongside
        the payload so a failover re-push replays the same form."""
        g = np.asarray(grad)
        if g.dtype != np.float16:
            g = g.astype(np.float32, copy=False)
        rnd = self._rounds.get(key, 0) + 1
        self._rounds[key] = rnd
        if self._reconnect:
            # retain a PRIVATE copy: astype(copy=False) may alias the
            # caller's buffer, and a reused gradient buffer must not
            # mutate the failover re-push (the client layer retains
            # immutable encoded frames for the same reason)
            self._retain(key, rnd, np.array(g, copy=True), priority, meta)
        m = dict(meta or {})
        m["round"] = rnd
        self._routed(key, lambda c: c.push(
            key, g, priority=priority, meta=m))

    def pull(self, key: str, priority: int = 0,
             timeout: Optional[float] = 120.0) -> np.ndarray:
        out = self._routed(key, lambda c: c.pull(
            key, priority=priority, timeout=timeout))
        # the pull reply proves the round durable at its owner: the
        # wrapper-retained failover re-push copy can go
        self._release(key)
        return out

    def _each_shard(self, op):
        """Run ``op(client)`` once per shard with the same stale-map
        absorption the keyed path gets: a dead address triggers one map
        refresh + client rebuild before the retry (a failover the
        wrapper has not observed yet must not fail an admin op)."""
        out = []
        for idx in range(self._map.num_shards):
            try:
                out.append(op(self._client(idx)))
            except (ConnectionError, TimeoutError, OSError,
                    RuntimeError):
                try:
                    self.refresh_map(timeout=5.0)
                except TimeoutError:
                    pass
                out.append(op(self._rebuild_client(idx)))
        return out

    def progress(self) -> Dict[str, int]:
        """Per-key merged-round counts for THIS sender, unioned across
        every shard — the zero-lost-rounds probe of the many-party
        acceptance."""
        out: Dict[str, int] = {}
        for prog in self._each_shard(lambda c: c.recover()):
            out.update(prog)
        return out

    def set_optimizer(self, name: str, **kwargs) -> None:
        self._each_shard(lambda c: c.set_optimizer(name, **kwargs))

    def stop_all(self) -> None:
        for idx in range(self._map.num_shards):
            try:
                self._client(idx).stop_server()
            except Exception:
                pass

    def close(self) -> None:
        with self._lock:
            for held in self._retained.values():
                self._m_resend_buf.dec(held[1].nbytes)
            self._retained.clear()
            clients, self._clients = dict(self._clients), {}
        for c in clients.values():
            _close_quietly(c)
        _close_quietly(self._sched)


def _close_quietly(c) -> None:
    try:
        c.close()
    except Exception:
        pass


__all__ = ["ShardedGlobalClient", "start_sharded_global_tier",
           "default_num_shards"]
