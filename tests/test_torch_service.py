"""The port's host parameter-service plane against the JAX package's.

The cases of tests/test_service.py, each run over three fleets — port
servers with port clients, a JAX server with port clients, and port
servers with JAX clients — so the two packages' frames and protocol
interoperate in both directions.  Then mixed two-tier fleets (a JAX
global tier over port local servers, and the reverse), whose pulls are
held to an all-JAX fleet's over the same rounds, and the scheduler
across packages.  Every socket wait here passes its own timeout in
seconds; ports come from binding port 0.
"""

import functools
import threading
import time
import types

import numpy as np
import pytest

import geomx_tpu.service as jsvc
import geomx_tpu.service.client as jclient
import geomx_tpu.service.protocol as jproto
import geomx_tpu_torch.service as tsvc
import geomx_tpu_torch.service.client as tclient
import geomx_tpu_torch.service.protocol as tproto

T = 30.0  # seconds: every pull/wait in this file


def _push(c, key, grad, **kw):
    """``push`` with this file's timeout (the client's own ``push``
    waits without one)."""
    c.wait(c.push_async(key, grad, **kw), timeout=T)


def _http(port, route):
    """(status, body) of a GET on a loopback exporter; JSON bodies
    parsed."""
    import json
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as r:
            status, raw, ctype = r.status, r.read(), r.headers[
                "Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    body = raw.decode("utf-8")
    if ctype and "json" in ctype:
        body = json.loads(body)
    return status, body


def _port_server(*args, **kw):
    kw.setdefault("device", "cpu")
    return tsvc.GeoPSServer(*args, **kw)


PORT = types.SimpleNamespace(name="port", Server=_port_server,
                             ServerCls=tsvc.GeoPSServer,
                             Client=tsvc.GeoPSClient, proto=tproto,
                             client_mod=tclient)
JAX = types.SimpleNamespace(name="jax", Server=jsvc.GeoPSServer,
                            ServerCls=jsvc.GeoPSServer,
                            Client=jsvc.GeoPSClient, proto=jproto,
                            client_mod=jclient)

# (server package, client package)
FLEETS = {"port": (PORT, PORT), "jaxserver": (JAX, PORT),
          "jaxclient": (PORT, JAX)}


@pytest.fixture(params=list(FLEETS))
def fleet(request):
    s, c = FLEETS[request.param]
    return types.SimpleNamespace(S=s.Server, C=c.Client, srv=s, cli=c)


def test_single_tier_sync_push_pull(fleet):
    server = fleet.S(num_workers=3, mode="sync", accumulate=True).start()
    clients = [fleet.C(("127.0.0.1", server.port), sender_id=i)
               for i in range(3)]
    n = 1000
    for c in clients:
        c.init("w", np.zeros(n, np.float32))
    errs = []

    def worker(c, wid):
        try:
            for r in range(10):
                _push(c, "w", np.full(n, 1.0 + wid, np.float32))
                out = c.pull("w", timeout=T)
                expect = (r + 1) * (1.0 + 2.0 + 3.0)
                if not np.allclose(out, expect):
                    errs.append((wid, r, out[0], expect))
        except Exception as e:
            errs.append((wid, repr(e)))

    threads = [threading.Thread(target=worker, args=(c, i))
               for i, c in enumerate(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive()
    assert not errs, errs
    for c in clients:
        c.stop_server()
        c.close()


def test_barrier_blocks_until_all_enter(fleet):
    server = fleet.S(num_workers=2).start()
    c0 = fleet.C(("127.0.0.1", server.port), sender_id=0)
    c1 = fleet.C(("127.0.0.1", server.port), sender_id=1)
    order = []

    def late():
        time.sleep(0.2)
        order.append("enter1")
        c1.barrier(timeout=T)

    t = threading.Thread(target=late)
    t.start()
    order.append("enter0")
    c0.barrier(timeout=T)
    order.append("released")
    t.join(timeout=T)
    assert not t.is_alive()
    assert order == ["enter0", "enter1", "released"]
    server.stop()


def test_two_tier_hips_relay(fleet):
    gs = fleet.S(num_workers=2, mode="sync").start()
    locals_ = [fleet.S(num_workers=2, mode="sync",
                       global_addr=("127.0.0.1", gs.port)).start()
               for _ in range(2)]
    n = 256
    workers = [(p, fleet.C(("127.0.0.1", ls.port), sender_id=w))
               for p, ls in enumerate(locals_) for w in range(2)]
    ginit = fleet.C(("127.0.0.1", gs.port), sender_id=99)
    ginit.init("w", np.zeros(n, np.float32))
    for _, c in workers:
        c.init("w", np.zeros(n, np.float32))
    results, errs = {}, []

    def run(p, wid, c):
        try:
            _push(c, "w", np.full(n, 1.0, np.float32))
            results[(p, wid)] = c.pull("w", timeout=T)
        except Exception as e:
            errs.append(repr(e))

    threads = [threading.Thread(target=run, args=(p, i, c))
               for i, (p, c) in enumerate(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T)
    assert not errs, errs
    assert len(results) == 4
    for k, v in results.items():
        np.testing.assert_allclose(v, 4.0, err_msg=str(k))
    for ls in locals_:
        ls.stop()
    gs.stop()


def test_async_mode_with_optimizer(fleet):
    server = fleet.S(num_workers=2, mode="async").start()
    c = fleet.C(("127.0.0.1", server.port), sender_id=0)
    c.init("w", np.zeros(4, np.float32))
    c.set_optimizer("sgd", learning_rate=0.1)
    _push(c, "w", np.ones(4, np.float32))
    np.testing.assert_allclose(c.pull("w", timeout=T), -0.1, rtol=1e-6)
    _push(c, "w", np.ones(4, np.float32))
    np.testing.assert_allclose(c.pull("w", timeout=T), -0.2, rtol=1e-6)
    server.stop()


def test_bsc_compressed_relay(fleet):
    gs = fleet.S(num_workers=1, mode="sync").start()
    ls = fleet.S(num_workers=1, mode="sync",
                 global_addr=("127.0.0.1", gs.port),
                 compression="bsc,0.01").start()
    n = 4096
    ginit = fleet.C(("127.0.0.1", gs.port), sender_id=9)
    ginit.init("w", np.zeros(n, np.float32))
    c = fleet.C(("127.0.0.1", ls.port), sender_id=0)
    c.init("w", np.zeros(n, np.float32))
    g = np.random.RandomState(0).normal(0, 1e-3, n).astype(np.float32)
    g[123] = 9.0
    g[456] = -7.0
    _push(c, "w", g)
    out = c.pull("w", timeout=T)
    assert out[123] == pytest.approx(9.0, abs=0.01)
    assert out[456] == pytest.approx(-7.0, abs=0.01)
    assert (out != 0).sum() <= 2 * int(np.ceil(n * 0.01))
    ls.stop()
    gs.stop()


def test_priority_ordering_on_the_wire(fleet):
    server = fleet.S(num_workers=1, mode="async").start()
    arrivals = []
    orig = server._handle_push

    def spy(conn, msg):
        arrivals.append(msg.key)
        return orig(conn, msg)

    server._handle_push = spy
    c = fleet.C(("127.0.0.1", server.port), sender_id=0)
    for i in range(4):
        c.init(f"layer{i}", np.zeros(8, np.float32))
    proto = fleet.cli.proto
    with c._wlock:
        c._submit(proto.Msg(proto.MsgType.HEARTBEAT), priority=10)
        time.sleep(0.05)
        rids = [c.push_async(f"layer{i}", np.ones(8, np.float32),
                             priority=-i)
                for i in (3, 1, 2, 0)]
        time.sleep(0.1)
    for r in rids:
        c.wait(r, timeout=T)
    assert arrivals == ["layer0", "layer1", "layer2", "layer3"]
    server.stop()


def test_dead_node_detection(fleet):
    server = fleet.S(num_workers=1, heartbeat_timeout=0.2).start()
    c = fleet.C(("127.0.0.1", server.port), sender_id=5)
    monitor = fleet.C(("127.0.0.1", server.port), sender_id=-1)
    c.heartbeat()
    assert monitor.num_dead_nodes() == 0
    time.sleep(0.3)
    assert monitor.num_dead_nodes() == 1
    c.heartbeat()
    assert monitor.num_dead_nodes() == 0
    server.stop()


def test_error_reply_for_unknown_key(fleet):
    server = fleet.S(num_workers=1).start()
    c = fleet.C(("127.0.0.1", server.port))
    with pytest.raises(RuntimeError, match="no key"):
        c.pull("missing", timeout=T)
    server.stop()


def test_wire_header_rejects_code_loading_pickles(fleet):
    import pickle
    import struct
    import zlib

    enc, dec = fleet.cli.proto, fleet.srv.proto
    m = enc.Msg(enc.MsgType.PUSH, key="w", sender=3,
                meta={"rid": 7, "resend": True,
                      "nested": [1, 2.5, ("a", None)]},
                array=np.arange(6, dtype=np.float32).reshape(2, 3))
    out = dec.Msg.decode(m.encode())
    assert out.meta == m.meta and np.array_equal(out.array, m.array)
    evil = pickle.dumps({"t": 1, "k": None, "s": 0,
                         "m": {"f": np.frombuffer}}, protocol=4)
    body = struct.pack("<I", len(evil)) + evil
    frame = bytes((dec.FRAME_VERSION,)) + struct.pack(
        "<I", zlib.crc32(body)) + body
    with pytest.raises(pickle.UnpicklingError):
        dec.Msg.decode(frame)


def test_tsengine_autopull_distribution(fleet):
    server = fleet.S(port=0, num_workers=2, mode="sync", accumulate=True,
                     auto_pull=True).start()
    addr = ("127.0.0.1", server.port)
    try:
        c0 = fleet.C(addr, sender_id=0, auto_pull=True)
        c1 = fleet.C(addr, sender_id=1, auto_pull=True)
        c0.init("w", np.zeros(4, np.float32))
        for rnd in range(1, 4):
            c0.push_async("w", np.ones(4, np.float32))
            c1.push_async("w", np.ones(4, np.float32))
            v0 = c0.auto_pull("w", min_version=rnd, timeout=T)
            v1 = c1.auto_pull("w", min_version=rnd, timeout=T)
            np.testing.assert_allclose(v0, 2.0 * rnd)
            np.testing.assert_allclose(v1, 2.0 * rnd)
        deadline = time.time() + 5.0
        while server.ts_sched.iters < 3 and time.time() < deadline:
            time.sleep(0.05)
        measured = [t for row in server.ts_sched.A for t in row
                    if t is not None]
        assert measured and all(t > 0 for t in measured)
        assert server.ts_sched.iters >= 3
        c0.close()
        c1.close()
    finally:
        server.stop()


def test_autopull_reconnect_reclaims_slot_and_dead_client_fails_fast(fleet):
    server = fleet.S(port=0, num_workers=2, mode="sync", accumulate=True,
                     auto_pull=True).start()
    addr = ("127.0.0.1", server.port)
    try:
        c0 = fleet.C(addr, sender_id=0, auto_pull=True)
        c1 = fleet.C(addr, sender_id=1, auto_pull=True)
        c0.init("w", np.zeros(2, np.float32))
        c1.close()
        c1b = fleet.C(addr, sender_id=1, auto_pull=True)
        c0.push_async("w", np.ones(2, np.float32))
        c1b.push_async("w", np.ones(2, np.float32))
        np.testing.assert_allclose(
            c1b.auto_pull("w", min_version=1, timeout=T), 2.0)
        with pytest.raises(RuntimeError, match="autopull table full"):
            fleet.C(addr, sender_id=7, auto_pull=True)
        c1b.close()
    finally:
        server.stop()
    t0 = time.time()
    with pytest.raises(ConnectionError):
        c0.auto_pull("w", min_version=99, timeout=T)
    assert time.time() - t0 < 10
    c0.close()


def test_hfa_k2_reduces_global_relays(fleet):
    glob = fleet.S(port=0, num_workers=1, mode="sync",
                   accumulate=True).start()
    local = fleet.S(port=0, num_workers=1, mode="sync",
                    global_addr=("127.0.0.1", glob.port),
                    global_sender_id=1000, hfa_k2=2,
                    num_global_workers=1).start()
    try:
        c = fleet.C(("127.0.0.1", local.port), sender_id=0)
        c.init("w", np.zeros(3, np.float32))
        for i in range(1, 5):
            _push(c, "w", np.full(3, float(i), np.float32))
            np.testing.assert_allclose(c.pull("w", timeout=T), float(i))
        assert glob._store["w"].round == 2
        np.testing.assert_allclose(glob._store["w"].value, 4.0)
        np.testing.assert_allclose(local._store["w"].milestone, 4.0)
        c.close()
    finally:
        local.stop()
        glob.stop()


def _straggler_case(fleet, local_mode):
    gsrv = fleet.S(num_workers=2, mode="sync", rank=0).start()
    la = fleet.S(num_workers=1, mode=local_mode,
                 global_addr=("127.0.0.1", gsrv.port),
                 global_sender_id=1000, rank=1).start()
    lb = fleet.S(num_workers=1, mode=local_mode,
                 global_addr=("127.0.0.1", gsrv.port),
                 global_sender_id=1001, rank=2).start()
    ca = fleet.C(("127.0.0.1", la.port), sender_id=0)
    cb = fleet.C(("127.0.0.1", lb.port), sender_id=0)
    n = 64
    for c in (ca, cb):
        c.init("slow", np.zeros(n, np.float32))
        c.init("fast", np.zeros(n, np.float32))
    t_slow = ca.push_async("slow", np.full(n, 1.0, np.float32))
    if local_mode == "sync":
        ca.wait(t_slow, timeout=T)
    time.sleep(0.3)
    t0 = time.monotonic()
    ca.heartbeat()
    assert ca.num_dead_nodes(timeout=60) == 0
    t_fa = ca.push_async("fast", np.full(n, 5.0, np.float32))
    t_fb = cb.push_async("fast", np.full(n, 7.0, np.float32))
    ca.wait(t_fa, timeout=T)
    cb.wait(t_fb, timeout=T)
    out = ca.pull("fast", timeout=T)
    assert time.monotonic() - t0 < 10.0, "local server stalled by straggler"
    if local_mode == "async":
        np.testing.assert_allclose(out, 12.0)
    assert out.shape == (n,)
    _push(cb, "slow", np.full(n, 2.0, np.float32))
    if local_mode == "async":
        ca.wait(t_slow, timeout=T)
    np.testing.assert_allclose(ca.pull("slow", timeout=T),
                               cb.pull("slow", timeout=T))
    for c in (ca, cb):
        c.stop_server()
        c.close()


def test_straggler_party_does_not_stall_local_server(fleet):
    _straggler_case(fleet, "sync")


def test_async_relay_runs_off_lock_and_off_serve_thread(fleet):
    _straggler_case(fleet, "async")


def test_wire_stats_and_verbose_logging(fleet, monkeypatch, capfd):
    monkeypatch.setenv("GEOMX_PS_VERBOSE", "2")
    for m in (tproto, jproto):
        m.reset_verbose_cache()
    try:
        before = fleet.srv.proto.wire_stats.snapshot()
        server = fleet.S(num_workers=1, mode="sync").start()
        c = fleet.C(("127.0.0.1", server.port), sender_id=0)
        n = 256
        c.init("w", np.zeros(n, np.float32))
        _push(c, "w", np.ones(n, np.float32))
        assert c.pull("w", timeout=T).shape == (n,)
        stats = c.wire_stats()
        assert stats["msgs_received"] >= 3
        assert stats["bytes_received"] - before["bytes_received"] > n * 4
        assert stats["bytes_sent"] - before["bytes_sent"] > n * 4
        err = capfd.readouterr().err
        assert "[geomx-wire]" in err and "PUSH" in err
        c.stop_server()
        c.close()
    finally:
        monkeypatch.delenv("GEOMX_PS_VERBOSE", raising=False)
        for m in (tproto, jproto):
            m.reset_verbose_cache()


def test_join_gates_on_stop_forward_completion(fleet, monkeypatch):
    gs = fleet.S(num_workers=1, mode="sync").start()
    ls = fleet.S(num_workers=1, mode="sync",
                 global_addr=("127.0.0.1", gs.port),
                 global_sender_id=1000).start()
    # the local server's relay leg is a client of the SERVER's package
    relay_cls = fleet.srv.client_mod.GeoPSClient
    real_stop = relay_cls.stop_server

    def slow_stop(self):
        if self.sender_id >= 1000:
            time.sleep(1.0)
        return real_stop(self)

    monkeypatch.setattr(relay_cls, "stop_server", slow_stop)
    c = fleet.C(("127.0.0.1", ls.port), sender_id=0)
    c.init("w", np.zeros(16, np.float32))
    c.stop_server()
    t0 = time.monotonic()
    ls.join(timeout=20.0)
    assert time.monotonic() - t0 >= 0.9
    gs.join(timeout=10.0)
    assert gs._stops >= 1
    c.close()


# ---- mixed two-tier fleets against an all-JAX fleet ----------------------

ROUNDS = 3
N_DENSE, N_SPARSE = 300, 2048


def _two_tier_pulls(gpkg, lpkg, compression=None, optimizer=None,
                    seed=0):
    """2 parties x 2 workers under a global tier of ``gpkg`` and local
    servers of ``lpkg`` (workers are clients of ``lpkg``): every
    worker's pulls of every round, by (round, party, worker, key)."""
    gs = gpkg.Server(num_workers=2, mode="sync").start()
    locals_ = [lpkg.Server(num_workers=2, mode="sync",
                           global_addr=("127.0.0.1", gs.port),
                           global_sender_id=1000 + p, rank=1 + p,
                           compression=compression).start()
               for p in range(2)]
    keys = {"dense": N_DENSE, "sparse": N_SPARSE}
    workers = {(p, w): lpkg.Client(("127.0.0.1", ls.port), sender_id=w)
               for p, ls in enumerate(locals_) for w in range(2)}
    for c in workers.values():
        for k, n in keys.items():
            c.init(k, np.zeros(n, np.float32))
    if optimizer is not None:
        workers[(0, 0)].set_optimizer(*optimizer[:1], **optimizer[1])
    rng = np.random.default_rng(seed)
    # dyadic gradients: every product and sum of the round is exact in
    # fp32, so the fold order of each package cannot move a bit
    grads = {(r, pw, k): (rng.integers(-64, 64, n) / 64.0).astype(
                 np.float32)
             for r in range(ROUNDS) for pw in workers
             for k, n in keys.items()}
    pulls, errs = {}, []

    def run(pw, c):
        try:
            for r in range(ROUNDS):
                for k in keys:
                    _push(c, k, grads[(r, pw, k)])
                for k in keys:
                    pulls[(r, pw, k)] = np.array(c.pull(k, timeout=T))
        except Exception as e:
            errs.append(repr(e))

    threads = [threading.Thread(target=run, args=(pw, c))
               for pw, c in workers.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * T)
        assert not t.is_alive()
    assert not errs, errs
    for c in workers.values():
        c.stop_server()
        c.close()
    for ls in locals_:
        ls.join(timeout=T)
    gs.join(timeout=T)
    return pulls


MIXED = {"jax_global_port_locals": (JAX, PORT),
         "port_global_jax_locals": (PORT, JAX)}
ROUND_KINDS = {"dense": (None, None),
               "fp16": ("fp16", None),
               "native_sgd": (None, ("sgd", {"learning_rate": 0.25}))}


@functools.lru_cache(maxsize=None)
def _all_jax(kind):
    comp, opt = ROUND_KINDS[kind]
    return _two_tier_pulls(JAX, JAX, comp, opt)


@pytest.mark.parametrize("kind", list(ROUND_KINDS))
@pytest.mark.parametrize("mixed", list(MIXED))
def test_mixed_two_tier_fleet_matches_all_jax(mixed, kind):
    comp, opt = ROUND_KINDS[kind]
    got = _two_tier_pulls(*MIXED[mixed], comp, opt)
    ref = _all_jax(kind)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].tobytes() == ref[k].tobytes(), k
    # every worker of every party pulled one model each round
    for r in range(ROUNDS):
        for key in ("dense", "sparse"):
            vals = [got[(r, pw, key)] for pw in ((0, 0), (0, 1),
                                                 (1, 0), (1, 1))]
            assert all(np.array_equal(vals[0], v) for v in vals)


@pytest.mark.parametrize("mixed", list(MIXED))
def test_mixed_bsc_relay_matches_all_jax(mixed, monkeypatch):
    # the JAX relay compressor on its sampled selection (the port's
    # default): the gradients are dyadic, the momentum buffers start at
    # zero and 0.9 * u is exact only while u is zero or a power of two,
    # so round 1 is bit-equal; later rounds, where XLA may contract
    # u * 0.9 + g into an FMA, are held within 1e-6 of the all-JAX
    # fleet (absolute, on values of order 1)
    monkeypatch.setenv("GEOMX_BSC_SELECT", "sampled")
    got = _two_tier_pulls(*MIXED[mixed], "bsc,0.05")
    ref = _two_tier_pulls(JAX, JAX, "bsc,0.05")
    assert got.keys() == ref.keys()
    for (r, pw, key), v in ref.items():
        if r == 0:
            assert got[(r, pw, key)].tobytes() == v.tobytes()
        else:
            np.testing.assert_allclose(got[(r, pw, key)], v, rtol=0,
                                       atol=1e-6)
    sparse0 = got[(0, (0, 0), "sparse")]
    assert 0 < np.count_nonzero(sparse0) <= 2 * 2 * int(
        np.ceil(N_SPARSE * 0.05))


# ---- the scheduler across packages ---------------------------------------

SCHED = {"port": (tsvc.GeoScheduler, tsvc.SchedulerClient),
         "jaxscheduler": (jsvc.GeoScheduler, tsvc.SchedulerClient),
         "jaxclient": (tsvc.GeoScheduler, jsvc.SchedulerClient)}


@pytest.mark.parametrize("pair", list(SCHED))
def test_scheduler_register_and_wait_for(pair):
    Sched, SC = SCHED[pair]
    sched = Sched(port=0).start()
    try:
        addr = ("127.0.0.1", sched.port)
        a, b, w = SC(addr), SC(addr), SC(addr)
        ra = a.register("server", port=19800, tag="0")
        rb = b.register("server", port=19801, tag="1")
        rw = w.register("worker", port=0, tag="1.0")
        assert ra["node_id"] == 100 and rb["node_id"] == 102
        assert rw["node_id"] == 101 and not ra["is_recovery"]
        # re-registration keeps the id and reports recovery
        again = SC(addr).register("server", port=19800, tag="0")
        assert again["node_id"] == 100 and again["is_recovery"]
        entry = w.wait_for("server", 1, tag="1", timeout=T)[0]
        assert (entry[0], entry[2]) == (102, 19801)
        assert len(w.wait_for("server", 2, timeout=T)) == 2
        with pytest.raises(TimeoutError):
            w.wait_for("global_server", 1, timeout=0.3)
        done = []
        t = threading.Thread(target=lambda: (a.barrier("g", 2, timeout=T),
                                             done.append(1)))
        t.start()
        b.barrier("g", 2, timeout=T)
        t.join(timeout=T)
        assert done == [1]
        assert w.evict(102)["evicted"]
        assert len(w.cluster()["server"]) == 1
        for c in (a, b, w):
            c.close()
    finally:
        sched.stop()


@pytest.mark.parametrize("pair", list(SCHED))
def test_scheduler_heartbeat_eviction(pair, monkeypatch):
    Sched, SC = SCHED[pair]
    sched = Sched(port=0, heartbeat_timeout=0.4).start()
    try:
        addr = ("127.0.0.1", sched.port)
        live, dying, mon = SC(addr), SC(addr), SC(addr)
        live.register("worker", tag="0.0")
        dying.register("worker", tag="0.1")
        live.start_heartbeat(interval_s=0.05)
        dying.heartbeat()
        deadline = time.monotonic() + 10
        while dying.node_id not in mon.dead_nodes() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        dead = mon.dead_nodes()
        assert dying.node_id in dead and live.node_id not in dead
        dying.heartbeat()
        assert dying.node_id not in mon.dead_nodes()
        for c in (live, dying, mon):
            c.close()
    finally:
        sched.stop()


def _families(text):
    """{family: type} of a Prometheus exposition (the build-info gauge
    left out: its identity labels name each package's own stack)."""
    from geomx_tpu_torch.telemetry import parse_prometheus_text
    return {k: v["type"] for k, v in parse_prometheus_text(text).items()
            if k != "geomx_build_info"}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_port_scheduler_refuses_unported_commands(pkg):
    """The ``metrics`` command the port's scheduler once refused:
    through either package's client it answers the Prometheus text of
    the port's registry, with the families and types a JAX scheduler
    answers for its own fresh registry."""
    from geomx_tpu.telemetry import reset_registry as jax_reset
    from geomx_tpu_torch.telemetry import reset_registry
    SC = tsvc.SchedulerClient if pkg == "port" else jsvc.SchedulerClient
    reset_registry()
    jax_reset()
    sched = tsvc.GeoScheduler(port=0).start()
    jsched = jsvc.GeoScheduler(port=0).start()
    try:
        c = SC(("127.0.0.1", sched.port))
        jc = SC(("127.0.0.1", jsched.port))
        text, jtext = c.metrics_text(), jc.metrics_text()
        assert "geomx_scheduler_roster_epoch" in text
        assert 'geomx_build_info{version="0.1.0"' in text
        assert _families(text) == _families(jtext)
        c.close()
        jc.close()
    finally:
        sched.stop()
        jsched.stop()


def test_unported_server_and_scheduler_knobs_raise(monkeypatch, tmp_path):
    # durability is ported: a durable server and scheduler construct
    durable = _port_server(durable_dir=str(tmp_path))
    assert durable.health_snapshot()["durable"] is True
    durable.stop()
    tsvc.GeoScheduler(durable_dir=str(tmp_path)).stop()
    # the sharded global tier is ported: a shard constructs
    _port_server(shard_range=(0, 10), shard_index=0).stop()
    # the exporters are ported: both endpoints answer over loopback
    srv = _port_server(metrics_port=0)
    assert _http(srv.metrics_port, "/metrics")[0] == 200
    assert _http(srv.metrics_port, "/healthz")[1]["role"] == "ps_server"
    assert "summary" in _http(srv.metrics_port, "/ledger")[1]
    srv.stop()
    sched = tsvc.GeoScheduler(metrics_port=0)
    assert "geomx_scheduler" in _http(sched.metrics_port, "/metrics")[1]
    status, body = _http(sched.metrics_port, "/control")
    assert status == 200 and set(body) == {"decisions", "total", "capacity"}
    sched.stop()
    monkeypatch.setenv("GEOMX_DURABLE_DIR", str(tmp_path / "env"))
    durable = _port_server()
    assert durable._durable is not None
    durable.stop()
    monkeypatch.delenv("GEOMX_DURABLE_DIR")
    from geomx_tpu_torch.utils.net import free_port_blocks
    port, = free_port_blocks(1)
    monkeypatch.setenv("GEOMX_SERVER_METRICS_PORT", str(port))
    srv = _port_server()
    assert srv.metrics_port == port and _http(port, "/metrics")[0] == 200
    srv.stop()
    # FleetScope is ported: it runs beside a metrics endpoint, and a
    # scheduler without one has none
    monkeypatch.setenv("GEOMX_FLEETSCOPE", "1")
    sched = tsvc.GeoScheduler()
    assert sched.fleetscope is None
    sched.stop()
    sched = tsvc.GeoScheduler(metrics_port=0)
    assert sched.fleetscope is not None
    assert _http(sched.metrics_port, "/fleet")[0] == 200
    sched.stop()
    monkeypatch.setenv("GEOMX_FLEETSCOPE", "0")
    tsvc.GeoScheduler().stop()
    monkeypatch.setenv("GEOMX_DURABLE_DIR", "")
    # "" and 0 are the defaults: memory-only, no endpoint
    monkeypatch.setenv("GEOMX_SERVER_METRICS_PORT", "0")
    server = _port_server(durable_name="ignored").start()
    try:
        assert server.metrics_port is None
        c = tsvc.GeoPSClient(("127.0.0.1", server.port))
        assert "# TYPE" in c.metrics_text()
        info = c._request(tproto.Msg(tproto.MsgType.COMMAND,
                                     meta={"cmd": "shard_info"}), timeout=T)
        assert info.meta["shard_index"] is None and "lo" not in info.meta
        c.close()
    finally:
        server.stop()


def test_server_device_resolution(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsvc.GeoPSServer()
    s = tsvc.GeoPSServer(device="cpu", compression="bsc,0.01")
    try:
        assert s.device == torch.device("cpu")
        st = s._comp_init(np.zeros(4096, np.float32))
        assert [t.device.type for t in st] == ["cpu", "cpu"]
        assert s._comp_init(np.zeros(100, np.float32)) == ()
    finally:
        s.stop()


@pytest.mark.parametrize("opt", [("adam", {"learning_rate": 0.01}),
                                 ("momentum", {"learning_rate": 0.1}),
                                 ("rmsprop", {"learning_rate": 0.01})])
def test_factory_optimizer_tracks_jax_server(opt, monkeypatch):
    # the non-native server-side optimizer: the port's factory on the
    # server's device against optax on jnp, within 1e-6 over 4 rounds
    monkeypatch.setenv("GEOMX_NATIVE_SGD", "0")
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(4)]
    outs = {}
    for name, Server, Client in (("port", _port_server, tsvc.GeoPSClient),
                                 ("jax", jsvc.GeoPSServer,
                                  jsvc.GeoPSClient)):
        server = Server(num_workers=1, mode="async").start()
        c = Client(("127.0.0.1", server.port), sender_id=0)
        c.init("w", np.linspace(-1, 1, 64, dtype=np.float32))
        c.set_optimizer(opt[0], **opt[1])
        vals = []
        for g in grads:
            _push(c, "w", g)
            vals.append(np.array(c.pull("w", timeout=T)))
        outs[name] = vals
        c.close()
        server.stop()
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
