"""Port parity: the durable host plane (geomx_tpu_torch/resilience/
durability.py, the durable GeoPSServer and GeoScheduler, the sharded
tier's failover replay) against the JAX package, as
tests/test_durability.py, tests/test_recovery.py and
tests/test_manyparty.py pin the JAX side.

Exact throughout: the store's framing is the JAX package's byte for byte
(the same records give the same files, and a store written by either
package loads in the other), and every pull after a restart is compared
bit for bit with the never-crashed value or the JAX fleet's.  Every
socket case runs under its own deadline (``bounded``); ports come from
binding 0.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
from test_torch_sharded import bounded

import geomx_tpu.service as jsvc
import geomx_tpu_torch.service as tsvc
from geomx_tpu.resilience import durability as jdur
from geomx_tpu_torch.resilience import durability as tdur
from geomx_tpu_torch.resilience.chaos import (ChaosEngine, ChaosSchedule,
                                              set_node_lifecycle_hook)
from geomx_tpu_torch.service.shardmap import ShardMap

T = 30.0
STORES = {"port": tdur.DurableStateStore, "jax": jdur.DurableStateStore}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _server(*args, **kw):
    kw.setdefault("device", "cpu")
    return tsvc.GeoPSServer(*args, **kw)


# ---- DurableStateStore ---------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(STORES))
def test_store_snapshot_journal_round_trip(tmp_path, pkg):
    s = STORES[pkg](str(tmp_path), "node")
    s.snapshot({"a": 1})
    s.append({"k": "r", "v": np.arange(4, dtype=np.float32)})
    s.append({"k": "r", "v": 2})
    s.close()
    s2 = STORES[pkg](str(tmp_path), "node")
    snap, recs = s2.load()
    assert snap == {"a": 1} and len(recs) == 2
    np.testing.assert_array_equal(recs[0]["v"],
                                  np.arange(4, dtype=np.float32))
    s2.append({"k": "r", "v": 3})  # the numbering continues
    assert len(s2.load()[1]) == 3


@pytest.mark.parametrize("pkg", sorted(STORES))
def test_store_torn_tail_truncated(tmp_path, pkg):
    s = STORES[pkg](str(tmp_path), "node")
    s.append({"n": 1})
    s.append({"n": 2})
    s.close()
    path = os.path.join(str(tmp_path), "node.journal")
    blob = open(path, "rb").read()
    with open(path, "wb") as f:  # a crash mid-append
        f.write(blob + b"\x40\x00\x00\x00\xde\xad\xbe\xefpartial")
    snap, recs = STORES[pkg](str(tmp_path), "node").load()
    assert snap is None and [r["n"] for r in recs] == [1, 2]
    assert os.path.getsize(path) == len(blob)  # physically truncated
    with open(path, "wb") as f:  # a flipped bit inside a committed record
        bad = bytearray(blob)
        bad[-3] ^= 1
        f.write(bytes(bad))
    assert [r["n"] for r in
            STORES[pkg](str(tmp_path), "node").load()[1]] == [1]


def test_store_survives_a_second_crash_after_a_torn_tail(tmp_path):
    s = tdur.DurableStateStore(str(tmp_path), "node")
    s.append({"n": 1})
    s.close()
    with open(os.path.join(str(tmp_path), "node.journal"), "ab") as f:
        f.write(b"\x40\x00\x00\x00torn-mid-append")
    s2 = tdur.DurableStateStore(str(tmp_path), "node")
    assert [r["n"] for r in s2.load()[1]] == [1]
    s2.append({"n": 2})
    s2.close()
    assert [r["n"] for r in tdur.DurableStateStore(
        str(tmp_path), "node").load()[1]] == [1, 2]


@pytest.mark.parametrize("pkg", sorted(STORES))
def test_store_compaction_and_generation(tmp_path, pkg):
    s = STORES[pkg](str(tmp_path), "node")
    for i in range(5):
        s.append({"n": i})
    s.compact({"through": 4})
    s.append({"n": 5})
    s.close()
    snap, recs = STORES[pkg](str(tmp_path), "node").load()
    assert snap == {"through": 4} and [r["n"] for r in recs] == [5]
    g = STORES[pkg](str(tmp_path / "g"), "node")
    assert g.bump_generation() == 1
    assert STORES[pkg](str(tmp_path / "g"), "node").bump_generation() == 2
    assert STORES[pkg](str(tmp_path / "g"), "node").generation() == 2


def test_store_bad_snapshot_is_loud(tmp_path):
    s = tdur.DurableStateStore(str(tmp_path), "node")
    s.snapshot({"a": 1})
    path = os.path.join(str(tmp_path), "node.snap")
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(tdur.DurabilityError) as pexc:
        tdur.DurableStateStore(str(tmp_path), "node").load()
    with pytest.raises(jdur.DurabilityError) as jexc:
        jdur.DurableStateStore(str(tmp_path), "node").load()
    assert str(pexc.value) == str(jexc.value)


RECORDS = [{"k": "init", "key": "w", "value": np.arange(6, dtype=np.float32),
            "round": 0, "pushed": {}},
           {"k": "round", "key": "w", "value": np.ones((2, 3), np.float64),
            "round": 1, "pushed": {0: 1, 1: 1}, "milestone": None},
           {"k": "evict", "sender": 3, "num_workers": 2},
           {"k": "shard_map", "map": {"version": 2, "bounds": [0, 7, 99],
                                      "shards": [["127.0.0.1", 1]]}}]


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_store_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader):
    """The framing is the JAX package's byte for byte: the same records
    make the same files in both packages, and each reads the other's,
    compaction, torn tail and generation included."""
    dirs = {}
    for pkg in STORES:
        d = tmp_path / pkg
        s = STORES[pkg](str(d), "node")
        s.bump_generation()
        for rec in RECORDS[:2]:
            s.append(rec)
        s.compact({"keys": ["w"]})
        for rec in RECORDS[2:]:
            s.append(rec)
        s.close()
        dirs[pkg] = d
    for suffix in (".snap", ".journal", ".gen"):
        assert (dirs["port"] / f"node{suffix}").read_bytes() == \
            (dirs["jax"] / f"node{suffix}").read_bytes(), suffix
    path = dirs[writer] / "node.journal"
    with open(path, "ab") as f:
        f.write(b"\x40\x00\x00\x00torn")
    r = STORES[reader](str(dirs[writer]), "node")
    snap, recs = r.load()
    assert snap == {"keys": ["w"]} and recs == RECORDS[2:]
    assert r.generation() == 1 and r.bump_generation() == 2
    r.append({"n": 9})
    r.close()
    back = STORES[writer](str(dirs[writer]), "node").load()[1]
    assert back == RECORDS[2:] + [{"n": 9}]


def test_durable_dir_resolution_matches_jax(monkeypatch):
    for explicit, env, want in ((None, None, None), (None, "/d", "/d"),
                                ("", "/d", None), ("/e", "/d", "/e")):
        if env is None:
            monkeypatch.delenv("GEOMX_DURABLE_DIR", raising=False)
        else:
            monkeypatch.setenv("GEOMX_DURABLE_DIR", env)
        assert tdur.durable_dir_from_env(explicit) == \
            jdur.durable_dir_from_env(explicit) == want


# ---- the durable server ------------------------------------------------------------

@bounded()
def test_server_restart_replays_durable_state(tmp_path):
    srv = _server(num_workers=1, mode="sync", accumulate=True,
                  durable_dir=str(tmp_path), durable_name="g").start()
    port = srv.port
    c = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=0)
    c.init("w", np.zeros(8, np.float32))
    c.push("w", np.full(8, 3.0, np.float32))
    np.testing.assert_array_equal(c.pull("w", timeout=T), 3.0)
    c.close()
    srv.crash()
    srv2 = _server(num_workers=1, mode="sync", accumulate=True,
                   durable_dir=str(tmp_path), durable_name="g",
                   port=port).start()
    assert srv2.generation == 2 and srv2.health_snapshot()["durable"]
    c2 = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=0)
    np.testing.assert_array_equal(c2.pull("w", timeout=T), 3.0)
    assert c2.recover()["w"] == 1
    c2.push("w", np.full(8, 1.0, np.float32))
    np.testing.assert_array_equal(c2.pull("w", timeout=T), 4.0)
    c2.stop_server()
    c2.close()
    srv2.join(5)
    from geomx_tpu_torch.telemetry import get_registry
    reg = get_registry()
    assert reg.get("geomx_host_restarts_total").labels(
        node="server_r0").value >= 1
    assert reg.get("geomx_host_generation").labels(
        node="server_r0").value == 2


@bounded()
def test_port_server_restores_a_jax_servers_store(tmp_path):
    """A JAX server's durable directory (a store of primitives and numpy
    arrays: no optimizer) restores in the port's server, and the
    replayed store and round counts are the JAX server's."""
    srv = jsvc.GeoPSServer(num_workers=1, mode="sync", accumulate=True,
                           durable_dir=str(tmp_path),
                           durable_name="g").start()
    port = srv.port
    c = jsvc.GeoPSClient(("127.0.0.1", port), sender_id=0)
    c.init("w", np.zeros(8, np.float32))
    for v in (3.0, 0.5):
        c.push("w", np.full(8, v, np.float32))
        c.pull("w", timeout=T)
    c.close()
    srv.crash()
    srv2 = _server(num_workers=1, mode="sync", accumulate=True,
                   durable_dir=str(tmp_path), durable_name="g",
                   port=port).start()
    assert srv2.generation == 2
    c2 = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=0)
    np.testing.assert_array_equal(c2.pull("w", timeout=T), 3.5)
    assert c2.recover()["w"] == 2
    c2.stop_server()
    c2.close()
    srv2.join(5)


@bounded()
def test_session_resume_repushes_the_inflight_round(tmp_path):
    """A mid-round crash: A's round-2 push merged in memory only; the
    restart drops the partial merge, A's resume handshake re-pushes its
    retained frame, B pushes normally — no loss, no double merge."""
    srv = _server(num_workers=2, mode="sync", accumulate=True,
                  durable_dir=str(tmp_path), durable_name="g").start()
    port = srv.port
    ca = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=0, reconnect=True)
    cb = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=1, reconnect=True)
    try:
        n = 32
        for c in (ca, cb):
            c.init("w", np.zeros(n, np.float32))
        ca.push("w", np.full(n, 1.0, np.float32))
        cb.push("w", np.full(n, 2.0, np.float32))
        np.testing.assert_array_equal(ca.pull("w", timeout=T), 3.0)
        ca.push("w", np.full(n, 5.0, np.float32))
        _wait(lambda: srv._store["w"].count == 1)
        srv.crash()
        srv2 = _server(num_workers=2, mode="sync", accumulate=True,
                       durable_dir=str(tmp_path), durable_name="g",
                       port=port).start()
        try:
            cb.push("w", np.full(n, 2.0, np.float32))
            np.testing.assert_array_equal(cb.pull("w", timeout=60.0), 10.0)
            np.testing.assert_array_equal(ca.pull("w", timeout=60.0), 10.0)
        finally:
            ca.stop_server()
            srv2.join(5)
    finally:
        ca.close()
        cb.close()


def _wait(cond, timeout=10.0):
    """Poll ``cond`` (no fixed sleep: the case waits for the state it
    needs, however loaded the host)."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.01)


def _opt_run(pkg, d, crash_between, compact=None):
    S = _server if pkg == "port" else jsvc.GeoPSServer
    C = tsvc.GeoPSClient if pkg == "port" else jsvc.GeoPSClient
    srv = S(num_workers=1, mode="sync", durable_dir=str(d),
            durable_name="g").start()
    port = srv.port
    c = C(("127.0.0.1", port), sender_id=0)
    c.set_optimizer("momentum", learning_rate=0.5, momentum=0.5)
    c.init("w", np.full(4, 1.0, np.float32))
    for _ in range(3):
        c.push("w", np.full(4, 1.0, np.float32))
        c.pull("w", timeout=T)
    if crash_between:
        c.close()
        srv.crash()
        srv = S(num_workers=1, mode="sync", durable_dir=str(d),
                durable_name="g", port=port).start()
        c = C(("127.0.0.1", port), sender_id=0)
        assert c.recover()["w"] == 3
    c.push("w", np.full(4, 1.0, np.float32))
    out = np.asarray(c.pull("w", timeout=T))
    native = srv._native_sgd
    c.stop_server()
    c.close()
    srv.join(5)
    return out, native


@bounded()
def test_durable_server_optimizer_state_survives_restart(tmp_path,
                                                         monkeypatch):
    """Server-side SGD-momentum (the factory optimizer: a durable server
    opts out of the native SGD, whose state handle is not serializable):
    the restarted server applies the same update a never-crashed one
    does, with journal compaction every 2 records on the way; the values
    are the JAX server's (dyadic inputs, so every op is exact)."""
    monkeypatch.setenv("GEOMX_DURABLE_COMPACT", "2")
    base, native = _opt_run("port", tmp_path / "base", False)
    assert native is None
    crashed, _ = _opt_run("port", tmp_path / "crash", True)
    jax_out, _ = _opt_run("jax", tmp_path / "jax", True)
    np.testing.assert_array_equal(base, crashed)
    np.testing.assert_array_equal(crashed, jax_out)
    st = tdur.DurableStateStore(str(tmp_path / "crash"), "g")
    assert st.snapshot_bytes() > 0  # compaction folded the journal


@bounded()
def test_scheduler_restart_keeps_ids_epoch_and_grace(tmp_path):
    sch = tsvc.GeoScheduler(durable_dir=str(tmp_path)).start()
    port = sch.port
    sc = tsvc.SchedulerClient(("127.0.0.1", port))
    sc.register("worker", tag="0.0")
    wid, epoch0 = sc.node_id, sc.roster_epoch
    sc.heartbeat()
    sch.crash()
    sch2 = tsvc.GeoScheduler(durable_dir=str(tmp_path), port=port,
                             heartbeat_timeout=0.2,
                             restart_grace_s=30.0).start()
    try:
        assert sch2.generation == 2 and sch2.in_restart_grace()
        sc2 = tsvc.SchedulerClient(("127.0.0.1", port))
        meta = sc2.register("worker", tag="0.0")
        assert sc2.node_id == wid and meta["is_recovery"] is True
        assert sc2.roster_epoch > epoch0
        assert sc2.dead_nodes() == []
        assert sc.dead_nodes() == []
        assert sc.saw_scheduler_restart is True
        health = sch2.health_snapshot()
        assert health["restart_grace"] is True
        assert health["generation"] == 2
        sc2.close()
    finally:
        sc.close()
        sch2.stop()


@bounded()
def test_restart_grace_defaults_to_the_env_then_the_heartbeat_timeout(
        tmp_path, monkeypatch):
    d = str(tmp_path)
    s1 = tsvc.GeoScheduler(durable_dir=d).start()
    sc = tsvc.SchedulerClient(("127.0.0.1", s1.port))
    sc.register("worker", tag="0.0")  # a roster to restore
    sc.close()
    s1.crash()
    monkeypatch.setenv("GEOMX_RESTART_GRACE_S", "0")
    s2 = tsvc.GeoScheduler(durable_dir=d, heartbeat_timeout=30.0)
    assert s2.generation == 2 and not s2.in_restart_grace()
    s2.crash()
    monkeypatch.delenv("GEOMX_RESTART_GRACE_S")
    s3 = tsvc.GeoScheduler(durable_dir=d, heartbeat_timeout=30.0)
    assert s3.in_restart_grace()
    s3.crash()
    # a first start is not a restart: no grace
    s4 = tsvc.GeoScheduler(durable_dir=str(tmp_path / "fresh"))
    assert s4.generation == 1 and not s4.in_restart_grace()
    s4.stop()


_SERVER_CHILD = """
import sys
from geomx_tpu_torch.service import GeoPSServer
srv = GeoPSServer(num_workers=2, mode="sync", accumulate=True,
                  port=int(sys.argv[1]), durable_dir=sys.argv[2],
                  durable_name="g", device="cpu").start()
print("READY", flush=True)
srv.join()
"""


def _spawn_server(port, durable_dir):
    proc = subprocess.Popen([sys.executable, "-c", _SERVER_CHILD,
                             str(port), durable_dir], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=ROOT))
    line = proc.stdout.readline()
    assert line.strip() == "READY", f"server child failed: {line!r}"
    return proc


@bounded(120.0)
def test_killed_server_process_resumes_mid_round(tmp_path):
    """The port's server in its own process, SIGKILLed with worker 0's
    round-2 push merged in memory only; a replacement process on the
    same directory and port replays every completed round, and the
    workers' session resume completes the round exactly."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    proc = _spawn_server(port, str(tmp_path))
    proc2 = ca = cb = None
    try:
        ca = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=0,
                              reconnect=True)
        cb = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=1,
                              reconnect=True)
        n = 48
        for c in (ca, cb):
            c.init("w", np.zeros(n, np.float32))
        ca.push("w", np.full(n, 1.0, np.float32))
        cb.push("w", np.full(n, 2.0, np.float32))
        np.testing.assert_array_equal(ca.pull("w", timeout=T), 3.0)
        ca.push("w", np.full(n, 5.0, np.float32))  # ACKed: merged
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        proc2 = _spawn_server(port, str(tmp_path))
        cb.push("w", np.full(n, 2.0, np.float32))
        np.testing.assert_array_equal(cb.pull("w", timeout=60.0), 10.0)
        np.testing.assert_array_equal(ca.pull("w", timeout=60.0), 10.0)
        ca.stop_server()
    finally:
        for c in (ca, cb):
            if c is not None:
                c.close()
        for p in (proc, proc2):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)


# ---- the sharded tier's failover replay ------------------------------------------

def _failover_fleet(pkg, tmp_path):
    """Two durable shards, one worker; shard 0 crashes, a replacement on
    a new port replays its journal (``shard0``), the map re-points, and
    the stream continues on both shards.  Returns the pulls."""
    S = tsvc if pkg == "port" else jsvc
    tier = (lambda *a, **k: tsvc.start_sharded_global_tier(
        *a, device="cpu", **k)) if pkg == "port" \
        else jsvc.start_sharded_global_tier
    Server = _server if pkg == "port" else jsvc.GeoPSServer
    sched = S.GeoScheduler(durable_dir=str(tmp_path / "sched")).start()
    addr = ("127.0.0.1", sched.port)
    servers = tier(addr, num_shards=2, num_workers=1,
                   durable_dir=str(tmp_path / "tier"))
    w = S.ShardedGlobalClient(addr, sender_id=0, reconnect=True,
                              reconnect_timeout_s=1.0)
    sc = S.SchedulerClient(addr)
    try:
        m = ShardMap.from_meta(sc.shard_map())
        k0 = next(f"k{i}" for i in range(64) if m.shard_for(f"k{i}") == 0)
        k1 = next(f"k{i}" for i in range(64) if m.shard_for(f"k{i}") == 1)
        rng = np.random.RandomState(5)
        out = {}
        for k in (k0, k1):
            w.init(k, np.zeros(8, np.float32))
            w.push(k, rng.randn(8).astype(np.float32))
            out[f"{k}_1"] = np.asarray(w.pull(k, timeout=T))
        servers[0].crash()
        repl = Server(num_workers=1, mode="sync", accumulate=True, rank=0,
                      shard_index=0, shard_range=(m.bounds[0], m.bounds[1]),
                      shard_map_version=1,
                      durable_dir=str(tmp_path / "tier"),
                      durable_name="shard0").start()
        servers[0] = repl
        newmap = sc.shard_failover(0, "127.0.0.1", repl.port)
        assert newmap["version"] == 2
        for k in (k1, k0):
            w.push(k, rng.randn(8).astype(np.float32))
            out[f"{k}_2"] = np.asarray(w.pull(k, timeout=60.0))
        assert w.map_version == 2
        sc.close()
        sched.crash()  # the scheduler's journal keeps the v2 map
        sched2 = S.GeoScheduler(port=addr[1],
                                durable_dir=str(tmp_path / "sched")).start()
        sc2 = S.SchedulerClient(addr)
        m2 = sc2.shard_map()
        sc2.close()
        sched = sched2
        out["map_version_after_restart"] = m2["version"]
        out["replica_port_in_map"] = ["127.0.0.1", repl.port] in m2["shards"]
        return out
    finally:
        for c in (w, sc):
            try:
                c.close()
            except Exception:
                pass
        for s in servers:
            try:
                s.stop(forward=False)
            except Exception:
                pass
        sched.stop()


@bounded(120.0)
def test_shard_failover_replays_the_journal_as_jax_does(tmp_path):
    ref = _failover_fleet("jax", tmp_path / "jax")
    out = _failover_fleet("port", tmp_path / "port")
    assert set(ref) == set(out)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert out[k].tobytes() == ref[k].tobytes(), k
        else:
            assert out[k] == ref[k], k
    assert out["map_version_after_restart"] == 2
    assert out["replica_port_in_map"]


# ---- the chaos verbs for host-plane processes -----------------------------------

def test_kill_restart_corrupt_grammar_and_hook():
    from geomx_tpu.resilience.chaos import ChaosSchedule as JaxSchedule
    from geomx_tpu_torch.service import protocol
    spec = ("seed=9;kill@4:node=server,restart_after=2;"
            "kill@8:node=scheduler;restart@9:node=scheduler;"
            "corrupt@2:party=0,rate=40,steps=3;"
            "kill@5:node=shard3,restart_after=1")
    s = ChaosSchedule.from_spec(spec)
    assert s.spec() == JaxSchedule.from_spec(spec).spec()
    assert ChaosSchedule.from_spec(s.spec()).events == s.events
    kinds = [(e.step, e.kind, e.node) for e in s.events]
    assert (6, "restart", "server") in kinds
    assert (6, "restart", "shard3") in kinds
    assert (5, "corrupt_clear", "") in kinds
    with pytest.raises(ValueError, match="node="):
        ChaosSchedule.from_spec("kill@1:node=worker")
    calls = []
    set_node_lifecycle_hook(lambda a, n: calls.append((a, n)))
    try:
        sched = ChaosSchedule.from_spec(
            "seed=3;corrupt@1:party=2,rate=25,steps=2;"
            "kill@2:node=shard1,restart_after=1")
        with ChaosEngine(sched, controller=None) as eng:
            eng.tick(1)
            assert protocol._corrupt_rates == {2: 25}
            eng.tick(3)
        assert calls == [("kill", "shard1"), ("restart", "shard1")]
        assert protocol._corrupt_rates == {}
    finally:
        set_node_lifecycle_hook(None)
