"""The port's key-range sharded global tier against the JAX package's.

The cases of tests/test_manyparty.py that need no durable store and no
chaos, each run as one fleet of the JAX package and one of the port on
the same inputs (memory-only on both sides).  The two runs are compared
bit for bit: the shard maps' bounds and versions, the redirects'
``map_version`` and message, ``rebalance_shards``'s result (new bounds,
``moved_keys``) and every final pull.  A cross-wire fleet runs JAX
``ShardedGlobalClient``s against the port's scheduler and shards, and a
failover case re-points a shard to a fresh replacement on a new port.

Every case runs its fleet under its own deadline (``bounded``), so a
hang fails that test instead of the suite; ports come from binding 0.
"""

import functools
import threading
import types

import numpy as np
import pytest

import geomx_tpu.service as jsvc
import geomx_tpu.service.protocol as jproto
import geomx_tpu_torch.service as tsvc
import geomx_tpu_torch.service.protocol as tproto
from geomx_tpu.compression.sparseagg import \
    encode_pairs_payload as jax_encode_pairs
from geomx_tpu.service.shardmap import ShardMap as JaxShardMap
from geomx_tpu_torch.compression.sparseagg import \
    encode_pairs_payload as port_encode_pairs
from geomx_tpu_torch.service.shardmap import ShardMap

T = 30.0        # seconds: every pull in this file
DEADLINE = 90.0  # seconds: one fleet's whole run


def bounded(seconds=DEADLINE):
    """Run the test body on a daemon thread and fail it when it outlives
    ``seconds``: a hung socket fails one test, not the suite."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            box = {}

            def run():
                try:
                    box["out"] = fn(*args, **kwargs)
                except BaseException as e:  # re-raised on the test thread
                    box["err"] = e
            th = threading.Thread(target=run, daemon=True)
            th.start()
            th.join(seconds)
            if th.is_alive():
                pytest.fail(f"{fn.__name__} still running after "
                            f"{seconds} s")
            if "err" in box:
                raise box["err"]
            return box.get("out")
        return wrapper
    return deco


def _port_tier(addr, **kw):
    return tsvc.start_sharded_global_tier(addr, device="cpu", **kw)


def _port_server(*args, **kw):
    kw.setdefault("device", "cpu")
    return tsvc.GeoPSServer(*args, **kw)


JAX = types.SimpleNamespace(
    name="jax", Scheduler=jsvc.GeoScheduler,
    tier=jsvc.start_sharded_global_tier,
    Sharded=jsvc.ShardedGlobalClient, SchedClient=jsvc.SchedulerClient,
    Client=jsvc.GeoPSClient, Server=jsvc.GeoPSServer,
    WrongShard=jsvc.WrongShardError, pairs=jax_encode_pairs, proto=jproto)
PORT = types.SimpleNamespace(
    name="port", Scheduler=tsvc.GeoScheduler, tier=_port_tier,
    Sharded=tsvc.ShardedGlobalClient, SchedClient=tsvc.SchedulerClient,
    Client=tsvc.GeoPSClient, Server=_port_server,
    WrongShard=tsvc.WrongShardError, pairs=port_encode_pairs, proto=tproto)
PKGS = {"jax": JAX, "port": PORT}


class Fleet:
    """One scheduler, a sharded tier and its clients: the scheduler and
    the shards from package ``tier``, every client from ``clients``."""

    def __init__(self, tier, clients, shards=2, workers=2):
        self.t, self.c = PKGS[tier], PKGS[clients]
        self.sched = self.t.Scheduler().start()
        self.addr = ("127.0.0.1", self.sched.port)
        self.servers = self.t.tier(self.addr, num_shards=shards,
                                   num_workers=workers)
        self.sc = self.c.SchedClient(self.addr)
        self.closing = [self.sc]

    def sharded(self, parties, **kw):
        ws = [self.c.Sharded(self.addr, sender_id=p, reconnect=True, **kw)
              for p in range(parties)]
        self.closing += ws
        return ws

    def client(self, addr, sender_id=0):
        c = self.c.Client(tuple(addr), sender_id=sender_id)
        self.closing.append(c)
        return c

    def map(self, meta=None):
        return ShardMap.from_meta(meta or self.sc.shard_map())

    def close(self):
        for c in self.closing:
            try:
                c.close()
            except Exception:
                pass
        for s in self.servers:
            try:
                s.stop(forward=False)
            except Exception:
                pass
        self.sched.stop()


def fleet_run(tier, clients, body, **kw):
    f = Fleet(tier, clients, **kw)
    try:
        return body(f)
    finally:
        f.close()


def map_view(meta):
    """A map without its addresses (each fleet binds its own ports)."""
    return {"version": int(meta["version"]),
            "bounds": [int(b) for b in meta["bounds"]],
            "num_shards": len(meta["shards"])}


def keys_on(m, prefix, shard, n):
    return [f"{prefix}{i}" for i in range(64)
            if m.shard_for(f"{prefix}{i}") == shard][:n]


def assert_same(a, b, path="out"):
    """Bit equality of nested results (arrays by bytes and dtype)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


# ---- the shard map itself --------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4, 7])
def test_shard_map_matches_the_jax_map(shards):
    addrs = [("127.0.0.1", 7000 + i) for i in range(shards)]
    pm, jm = ShardMap.initial(addrs), JaxShardMap.initial(addrs)
    assert pm.to_meta() == jm.to_meta()
    keys = [f"w{i}" for i in range(200)]
    assert [pm.shard_for(k) for k in keys] == [jm.shard_for(k) for k in keys]


# ---- wrong-shard redirect --------------------------------------------------


def stale_map_body(f):
    m = f.map()
    key = keys_on(m, "k", 0, 1)[0]
    right = f.client(m.addr_of(0))
    right.init(key, np.zeros(8, np.float32))
    # a client with a stale (wrong) map dials shard 1 for shard 0's key:
    # every request type redirects, nothing merges
    wrong = f.client(m.addr_of(1))
    redirects = []
    for op in (lambda: wrong.init(key, np.zeros(8, np.float32)),
               lambda: wrong.push(key, np.ones(8, np.float32)),
               lambda: wrong.pull(key, timeout=T)):
        with pytest.raises(f.c.WrongShard) as ei:
            op()
        redirects.append((ei.value.map_version, str(ei.value)))
    # the right shard's store is untouched by the redirected push
    right.push(key, np.ones(8, np.float32))
    return {"map": map_view(f.sc.shard_map()), "redirects": redirects,
            "pull": np.asarray(right.pull(key, timeout=T))}


@bounded()
def test_stale_map_gets_redirect_not_wrong_merge():
    outs = {pkg: fleet_run(pkg, pkg, stale_map_body, workers=1)
            for pkg in ("jax", "port")}
    assert all(v == 1 for v, _ in outs["port"]["redirects"])
    np.testing.assert_array_equal(outs["port"]["pull"], np.ones(8))
    assert_same(outs["jax"], outs["port"])


# ---- sharded routing end to end --------------------------------------------


def routes_body(f):
    ws = f.sharded(2)
    keys = [f"w{i}" for i in range(6)]
    for w in ws:
        for k in keys:
            w.init(k, np.zeros(16, np.float32))
    for _r in range(2):
        for k in keys:
            for p, w in enumerate(ws):
                w.push(k, np.full(16, p + 1.0, np.float32))
            for w in ws:
                w.pull(k, timeout=T)
    m = f.map(ws[0]._sched.shard_map())
    return {"pulls": {k: np.asarray(ws[0].pull(k, timeout=T))
                      for k in keys},
            "progress": ws[0].progress(),
            "owners": sorted({m.shard_for(k) for k in keys}),
            "map": map_view(m.to_meta())}


@bounded()
def test_sharded_client_routes_and_merges_exactly():
    outs = {pkg: fleet_run(pkg, pkg, routes_body)
            for pkg in ("jax", "port")}
    port = outs["port"]
    for v in port["pulls"].values():
        np.testing.assert_array_equal(v, np.full(16, 6.0, np.float32))
    assert all(n == 2 for n in port["progress"].values())
    assert port["owners"] == [0, 1]      # the tier is really sharded
    assert_same(outs["jax"], port)


# ---- rebalance with an open round -------------------------------------------


def rebalance_body(f):
    """A rebalance moves keys while their round is OPEN: the migrated
    state carries the open round's contributions + per-sender counts, a
    replayed push at the new owner is an idempotent ACK, and the round
    completes with the exact sum."""
    ws = f.sharded(2)
    m = f.map()
    hot, cold = keys_on(m, "h", 0, 4), keys_on(m, "c", 1, 1)
    for k in hot + cold:
        for w in ws:
            w.init(k, np.zeros(8, np.float32))
    for _r in range(2):     # skewed load onto shard 0
        for k in hot:
            for w in ws:
                w.push(k, np.ones(8, np.float32))
            for w in ws:
                w.pull(k, timeout=T)
    # open round 3 on every hot key: only worker 0 pushed
    for k in hot:
        ws[0].push(k, np.full(8, 3.0, np.float32))
    res = f.sc.rebalance_shards(min_gain=0.05)
    m2 = f.map(res["map"])
    moved = [k for k in hot if m2.shard_for(k) != 0]
    # a resend crossing the rebalance: replay worker 0's round-3 push at
    # the NEW owner — must dedup, not double-merge
    replay = f.client(m2.addr_of(m2.shard_for(moved[0])))
    replay.push(moved[0], np.full(8, 3.0, np.float32), meta={"round": 3})
    for k in hot:           # worker 1 completes round 3 everywhere
        ws[1].push(k, np.full(8, 3.0, np.float32))
    return {"rebalance": {"changed": res["changed"],
                          "moved_keys": res["moved_keys"],
                          "segments": res["segments"],
                          "map": map_view(res["map"])},
            "moved": moved,
            "pulls": {k: np.asarray(ws[0].pull(k, timeout=60.0))
                      for k in hot},
            "progress": ws[0].progress(),
            "client_maps": [w.map_version for w in ws]}


@pytest.mark.parametrize("tier,clients", [("port", "port"),
                                          ("port", "jax")],
                         ids=["port", "jax_clients_on_port_tier"])
@bounded(2 * DEADLINE)
def test_rebalance_mid_round_is_idempotent(tier, clients):
    ref = fleet_run("jax", "jax", rebalance_body)
    out = fleet_run(tier, clients, rebalance_body)
    assert out["rebalance"]["changed"] and out["rebalance"]["moved_keys"] > 0
    assert out["moved"]
    for v in out["pulls"].values():      # 2 * 2 + 3 + 3
        np.testing.assert_array_equal(v, np.full(8, 10.0, np.float32))
    assert all(out["progress"][k] == 3 for k in out["pulls"])
    assert_same(ref, out)


# ---- deterministic merges ---------------------------------------------------


def sorted_sender_outs(pkg):
    """Float addition is not associative: the round merge must be
    bit-identical regardless of push arrival order."""
    P = PKGS[pkg]
    vals = {0: np.float32(1e8), 1: np.float32(-1e8), 2: np.float32(1.0)}
    outs = []
    for order in ((0, 1, 2), (2, 1, 0), (1, 2, 0)):
        srv = P.Server(num_workers=3, mode="sync", accumulate=True).start()
        cs = [P.Client(("127.0.0.1", srv.port), sender_id=s)
              for s in range(3)]
        try:
            cs[0].init("w", np.zeros(4, np.float32))
            for s in order:
                cs[s].push("w", np.full(4, vals[s], np.float32))
            outs.append(np.asarray(cs[0].pull("w", timeout=T)))
            cs[0].stop_server()
        finally:
            for c in cs:
                c.close()
            srv.join(5)
    return outs


@bounded()
def test_merge_is_sorted_sender_order_not_arrival_order():
    ref, out = sorted_sender_outs("jax"), sorted_sender_outs("port")
    assert_same(ref, out)
    assert_same(out[0], out[1])
    assert_same(out[0], out[2])


N_SPARSE = 64
SPARSE_META = {"comp": "bsc", "n": N_SPARSE, "shape": [N_SPARSE]}


def sparse_body(shuffle, rebalance):
    def body(f):
        pairs = f.c.pairs
        # catastrophic-cancellation values: any reassociation changes bits
        payloads = {
            0: pairs(np.asarray([1e8, 1.0], np.float32), np.asarray([3, 10])),
            1: pairs(np.asarray([-1e8, 2.0], np.float32),
                     np.asarray([3, 20]))}
        ws = f.sharded(2)
        m = f.map()
        hot, cold = keys_on(m, "h", 0, 3), keys_on(m, "c", 1, 1)
        for k in hot + cold:
            for w in ws:
                w.init(k, np.zeros(N_SPARSE, np.float32))
        # a completed warm-up round builds the rebalance's load window
        for k in hot:
            for p in (ws if not shuffle else ws[::-1]):
                p.push(k, pairs(np.asarray([1.0], np.float32),
                                np.asarray([5])), meta=dict(SPARSE_META))
            for w in ws:
                w.pull(k, timeout=T)
        # open round 2: only worker 0 pushed its pairs
        for k in hot:
            ws[0].push(k, payloads[0], meta=dict(SPARSE_META))
        res = None
        if rebalance:
            res = f.sc.rebalance_shards(min_gain=0.05)
            res = {"changed": res["changed"],
                   "moved_keys": res["moved_keys"],
                   "map": map_view(res["map"])}
        # worker 1 completes round 2 (re-routed by a redirect when the
        # key moved)
        for k in hot:
            ws[1].push(k, payloads[1], meta=dict(SPARSE_META))
        return {"pulls": {k: np.asarray(ws[0].pull(k, timeout=60.0))
                          for k in hot},
                "progress": ws[0].progress(), "rebalance": res}
    return body


@pytest.mark.parametrize("shuffle,rebalance",
                         [(False, False), (True, False), (False, True)],
                         ids=["base", "shuffled", "rebalanced"])
@bounded(2 * DEADLINE)
def test_sparse_merge_bit_exact_across_orders_and_rebalance(shuffle,
                                                            rebalance):
    """The sorted-sender bit-equality contract on compressed (value,
    index) rounds: across push orders and across a mid-round rebalance
    that migrates the open round's pairs (`_enc_contrib`), in both
    packages."""
    ref = fleet_run("jax", "jax", sparse_body(shuffle, rebalance))
    out = fleet_run("port", "port", sparse_body(shuffle, rebalance))
    exp = np.zeros(N_SPARSE, np.float32)
    exp[5] = 2.0
    exp[3] = np.float32(np.float32(1e8) + np.float32(-1e8))
    exp[10], exp[20] = 1.0, 2.0
    for k, v in out["pulls"].items():
        np.testing.assert_array_equal(v, exp, err_msg=k)
        assert out["progress"][k] == 2
    if rebalance:
        assert out["rebalance"]["changed"] and \
            out["rebalance"]["moved_keys"] > 0
    assert_same(ref, out)


# ---- failover to a fresh shard on a new port ---------------------------------


def failover_body(f):
    """Shard 0 dies; a FRESH replacement (no journal: memory-only on
    both sides) takes its range on a new port; ``shard_failover`` bumps
    the map, the client re-routes, and the other shard never stalls."""
    w = f.sharded(1, reconnect_timeout_s=1.0)[0]
    m = f.map()
    k0, k1 = keys_on(m, "k", 0, 1)[0], keys_on(m, "k", 1, 1)[0]
    for k in (k0, k1):
        w.init(k, np.zeros(8, np.float32))
        w.push(k, np.ones(8, np.float32))
        w.pull(k, timeout=T)
    f.servers[0].crash()
    repl = f.t.Server(num_workers=1, mode="sync", accumulate=True, rank=0,
                      shard_index=0,
                      shard_range=(m.bounds[0], m.bounds[1]),
                      shard_map_version=1).start()
    f.servers[0] = repl
    newmap = f.sc.shard_failover(0, "127.0.0.1", repl.port)
    w.push(k1, np.ones(8, np.float32))
    survivor = np.asarray(w.pull(k1, timeout=T))
    # the replacement starts empty: the key is initialised again and its
    # stream continues there under the wrapper's round ids
    w.init(k0, np.zeros(8, np.float32))
    w.push(k0, np.full(8, 2.0, np.float32))
    moved = np.asarray(w.pull(k0, timeout=T))
    return {"map": map_view(newmap),
            "moved_to_new_port": newmap["shards"][0][1] == repl.port,
            "client_map": w.map_version,
            "client_addr_is_new": tuple(w._clients[0].addr) ==
            ("127.0.0.1", repl.port),
            "survivor": survivor, "moved": moved,
            "progress": {k0: w.progress()[k0]}}


@bounded()
def test_shard_failover_reroutes_to_a_fresh_shard():
    ref = fleet_run("jax", "jax", failover_body, workers=1)
    out = fleet_run("port", "port", failover_body, workers=1)
    assert out["map"]["version"] == 2 and out["client_map"] == 2
    assert out["moved_to_new_port"] and out["client_addr_is_new"]
    np.testing.assert_array_equal(out["survivor"], np.full(8, 2.0))
    np.testing.assert_array_equal(out["moved"], np.full(8, 2.0))
    assert_same(ref, out)


# ---- the scheduler's and shards' own surfaces --------------------------------


@bounded()
def test_shard_commands_health_and_gauges():
    """``shard_info``/``shard_load``, the hello and health fields and the
    map gauges, port against JAX on the same two-shard fleet shape."""
    def body(f):
        m = f.map()
        k = keys_on(m, "k", 1, 1)[0]
        c = f.client(m.addr_of(1))
        c.init(k, np.zeros(4, np.float32))
        c.push(k, np.ones(4, np.float32))
        c.pull(k, timeout=T)
        proto = f.c.proto
        info = c._request(proto.Msg(proto.MsgType.COMMAND,
                                    meta={"cmd": "shard_info"}), timeout=T)
        load = c._request(proto.Msg(proto.MsgType.COMMAND,
                                    meta={"cmd": "shard_load",
                                          "reset": True}), timeout=T)
        hello = c._request(proto.Msg(proto.MsgType.COMMAND,
                                     meta={"cmd": "hello"}), timeout=T)
        health = f.servers[1].health_snapshot()
        shealth = f.sched.health_snapshot()
        return {"info": {k0: v for k0, v in info.meta.items()
                         if k0 not in ("rid", "gen")},
                "load": load.meta["load"],
                "hello": {k0: hello.meta[k0] for k0 in
                          ("shard_index", "shard_lo", "shard_hi",
                           "map_version")},
                "health": {k0: health[k0] for k0 in
                           ("shard_index", "shard_lo", "shard_hi",
                            "map_version", "num_keys")},
                "sched": {k0: shealth[k0] for k0 in
                          ("shard_map_version", "num_shards")}}
    ref = fleet_run("jax", "jax", body, workers=1)
    out = fleet_run("port", "port", body, workers=1)
    assert out["info"]["shard_index"] == 1 and out["load"]["pushes"] == 1
    assert out["sched"] == {"shard_map_version": 1, "num_shards": 2}
    assert_same(ref, out)
