"""Port parity: the fleet round ledger (geomx_tpu_torch/telemetry/
ledger.py) and its host-plane call sites against the JAX package's.

- the same ledger call sequences give equal records in both packages
  (wall-clock fields aside);
- the same frames — byte-identical across the packages — give equal
  byte accounting at the encode/decode choke point;
- a real sync round through each package's server, with the clients'
  request-id bases pinned (the one random part of a frame), gives equal
  hop chains, wire byte totals and declared bytes;
- the redirect, failover-replay, session-resume replay and corrupt hops
  appear on the sharded tier and the chaos path;
- the exporters answer ``/ledger`` over loopback.
"""

import bisect
import itertools
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import geomx_tpu.service as jsvc
import geomx_tpu.service.protocol as jproto
import geomx_tpu.telemetry as jtel
import geomx_tpu.telemetry.flight as jflight
import geomx_tpu.telemetry.ledger as jled
import geomx_tpu.telemetry.links as jlinks
import geomx_tpu_torch.service as tsvc
import geomx_tpu_torch.service.protocol as tproto
import geomx_tpu_torch.telemetry as ttel
import geomx_tpu_torch.telemetry.flight as tflight
import geomx_tpu_torch.telemetry.ledger as tled
import geomx_tpu_torch.telemetry.links as tlinks

LED = {"jax": jled, "port": tled}
PROTO = {"jax": jproto, "port": tproto}
SVC = {"jax": jsvc, "port": tsvc}
TEL = {"jax": jtel, "port": ttel}
T = 30.0


@pytest.fixture()
def ledgers():
    """Fresh process-global ledgers in both packages."""
    out = {pkg: mod.reset_round_ledger(capacity=512)
           for pkg, mod in LED.items()}
    yield out
    for mod in LED.values():
        mod.reset_round_ledger()


def _strip(records):
    """Ledger records without their wall-clock and duration fields."""
    out = []
    for r in records:
        r = json.loads(json.dumps(r))
        r.pop("opened_unix", None)
        r.pop("closed_unix", None)
        for h in r["hops"]:
            h.pop("t", None)
            h.pop("dur_s", None)
            (h.get("detail") or {}).pop("gate_wait_s", None)
        r["phases"] = sorted(r["phases"])
        out.append(r)
    return out


# ---- RoundLedger: the same call sequences, the same records ----------------

def _hops_complete(L):
    led = L.RoundLedger(capacity=8)
    led.record_hop("w", 1, "push", party=3, nbytes=100)
    led.record_hop("w", 1, "merge", shard=2, dur_s=0.01)
    led.record_hop("w", 1, "reply", party=3)
    led.add_phase("w", 1, "merge", 0.01)
    led.complete("w", 1)
    led.record_hop("w", 1, "reply", party=4)
    led.complete("w", 1)
    return led


def _evict_fifo(L):
    led = L.RoundLedger(capacity=4)
    for r in range(1, 8):
        led.record_hop("w", r, "merge")
        led.complete("w", r)
    return led


def _open_orphaning(L):
    led = L.RoundLedger(capacity=8, open_capacity=4)
    for r in range(1, 7):
        led.record_hop("w", r, "push", party=0)
    return led


def _stragglers(L):
    led = L.RoundLedger(capacity=2)
    for r in (1, 2, 3):
        led.record_hop("w", r, "merge")
        led.complete("w", r)
    led.record_hop("w", 1, "reply", party=0)
    led.record_hop("w", 1, "journal")
    led.add_phase("w", 1, "reply", 0.1)
    led.account_frame("rx", "PULL_REPLY", "w", 1, nbytes=100)
    led.account_frame("rx", "PUSH", "w", 9, nbytes=100)
    return led


def _complete_through(L):
    led = L.RoundLedger(capacity=8)
    for r in (1, 2, 3):
        led.record_hop("k", r, "push", party=0)
    led.complete_through("k", 2)
    led.complete_through("k", 2)
    return led


def _orphan_api(L):
    led = L.RoundLedger(capacity=8)
    led.record_hop("a", 1, "push")
    led.record_hop("a", 2, "push")
    led.record_hop("b", 1, "push")
    led.orphan(key="a", reason="relay_failed")
    return led


def _honesty(L):
    led = L.RoundLedger(capacity=8)
    led.account_frame("rx", "PUSH", "w", 1, nbytes=1000, declared=900)
    led.account_frame("tx", "PUSH", "w", 2, nbytes=9000, declared=8900)
    led.account_frame("rx", "PUSH", "w", 3, nbytes=2000, declared=900)
    for r in (1, 2, 3):
        led.complete("w", r)
    return led


SCENARIOS = {"hops_complete": _hops_complete, "evict_fifo": _evict_fifo,
             "open_orphaning": _open_orphaning, "stragglers": _stragglers,
             "complete_through": _complete_through,
             "orphan_api": _orphan_api, "honesty": _honesty}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ledger_scenario_matches_jax(name):
    leds = {pkg: SCENARIOS[name](mod) for pkg, mod in LED.items()}
    assert _strip(leds["port"].records()) == _strip(leds["jax"].records())
    for attr in ("completed_total", "evicted_total", "orphaned_total"):
        assert getattr(leds["port"], attr) == getattr(leds["jax"], attr)
    summ = {pkg: led.summary(now=2e9) for pkg, led in leds.items()}
    for s in summ.values():
        s.pop("ledger_open_round_age_s")
    assert summ["port"] == summ["jax"]


def test_round_record_reconciliation_matches_jax():
    for measured, declared in ((1000, 900), (2000, 900), (9000, 8900),
                               (9300, 8900)):
        got = []
        for L in (jled, tled):
            rr = L.RoundRecord("w", 1)
            rr.wire.update({"push_rx_bytes": measured,
                            "push_rx_frames": 1})
            rr.declared_rx = declared
            got.append((rr.reconciles(), rr.honesty_ratio()))
        assert got[0] == got[1]
    assert tled.active_frame_overhead_bound() == \
        jled.active_frame_overhead_bound()


# ---- byte accounting at the encode/decode choke point --------------------------

@pytest.mark.parametrize("kind", ["PUSH", "PULL_REPLY", "RELAY"])
def test_frame_accounting_matches_jax(ledgers, kind):
    """The same data frame, encoded and decoded (twice: a re-delivery)
    by each package, gives the same byte accounting; the frames are the
    same bytes.  Only a push opens a record, so one opens the round
    first."""
    g = np.arange(128, dtype=np.float32)
    frames = {}
    for pkg, P in PROTO.items():
        ledgers[pkg].record_hop("w", 3, "push", party=5)
        msg = P.Msg(P.MsgType[kind], key="w", sender=5,
                    meta={"round": 3, "wire_declared": int(g.nbytes)},
                    array=g)
        frames[pkg] = msg.encode()
        P.Msg.decode(frames[pkg])
        P.Msg.decode(frames[pkg])
    assert frames["port"] == frames["jax"]
    recs = {pkg: _strip(led.records()) for pkg, led in ledgers.items()}
    assert recs["port"] == recs["jax"]
    wire = recs["port"][0]["wire"]
    low = kind.lower().replace("pull_", "")
    assert wire[f"{low}_tx_bytes"] == len(frames["port"]) + 4
    assert wire[f"{low}_rx_frames"] == 2


def test_frames_without_round_or_key_not_accounted(ledgers):
    tproto.Msg(tproto.MsgType.ACK, key="w").encode()
    tproto.Msg(tproto.MsgType.PUSH, key=None, meta={"round": 1}).encode()
    tproto.Msg(tproto.MsgType.COMMAND, key="w",
               meta={"round": 1, "cmd": "hello"}).encode()
    assert ledgers["port"].records() == []


def test_corrupt_hop_matches_jax(ledgers):
    """Chaos ``corrupt@``: the injected flip lands on the same offset in
    both packages from the same seed, and the ledger names the round."""
    flipped = {}
    for pkg, P in PROTO.items():
        P.set_corruption_override(-1, 100)
        P.reseed_corrupt_rng(7)
        try:
            msg = P.Msg(P.MsgType.PUSH, key="w", sender=2,
                        meta={"round": 4, "resend": True},
                        array=np.ones(64, np.float32))
            flipped[pkg] = P.maybe_corrupt_frame(msg, msg.encode())
        finally:
            P.clear_corruption_overrides()
    assert flipped["port"] == flipped["jax"]
    recs = {pkg: _strip(led.records()) for pkg, led in ledgers.items()}
    assert recs["port"] == recs["jax"]
    hop = [h for h in recs["port"][0]["hops"] if h["hop"] == "corrupt"]
    assert hop and hop[0]["party"] == 2
    with pytest.raises(Exception):
        tproto.Msg.decode(flipped["port"])
    crc = ttel.get_registry().get("geomx_host_incidents_total")
    assert crc is not None and \
        dict(crc.children())[("wire_crc_error",)].value >= 1


# ---- a real round through each package's server -------------------------------

def _pin_rids(*clients):
    for i, c in enumerate(clients):
        c._rid = itertools.count(1000 * (i + 1))


def _sync_round(pkg, tmp_path, p3=None):
    """Two workers, one durable sync server, one round of ``w``; the
    ledger records of this process."""
    S = SVC[pkg]
    srv = S.GeoPSServer(num_workers=2, mode="sync", accumulate=True,
                        durable_dir=str(tmp_path / pkg),
                        durable_name="led", **(
                            {"device": "cpu"} if pkg == "port" else {}))
    srv.start()
    kw = {} if p3 is None else {"p3_slice_elems": p3}
    c0 = S.GeoPSClient(("127.0.0.1", srv.port), sender_id=0, **kw)
    c1 = S.GeoPSClient(("127.0.0.1", srv.port), sender_id=1, **kw)
    _pin_rids(c0, c1)
    try:
        c0.init("w", np.zeros(100, np.float32))
        c0.push("w", np.ones(100, np.float32))
        c1.push("w", np.ones(100, np.float32))
        assert np.allclose(c0.pull("w", timeout=T), 2.0)
        assert np.allclose(c1.pull("w", timeout=T), 2.0)
        return LED[pkg].get_round_ledger().get("w", 1)
    finally:
        c0.close()
        c1.close()
        srv.stop(forward=False)


@pytest.mark.parametrize("p3", [None, 16])
def test_sync_round_records_match_jax(ledgers, tmp_path, p3):
    """One round through each package's durable server (P3-chunked or
    whole): the same hop kinds (push per frame, merge, journal, replies,
    in causal groups), byte totals, declared bytes and phases."""
    recs = {pkg: _sync_round(pkg, tmp_path, p3) for pkg in ("jax", "port")}
    for rec in recs.values():
        assert rec["status"] == "complete"
        assert [h["seq"] for h in rec["hops"]] == \
            list(range(len(rec["hops"])))
    p, j = _strip([recs["port"]])[0], _strip([recs["jax"]])[0]
    assert sorted(h["hop"] for h in p["hops"]) == \
        sorted(h["hop"] for h in j["hops"])
    assert p["wire"] == j["wire"]
    assert p["declared_rx_bytes"] == j["declared_rx_bytes"] == 2 * 400
    assert p["honesty_ratio"] == j["honesty_ratio"]
    assert p["phases"] == j["phases"]
    assert {"gate_wait", "merge", "journal", "reply"} <= set(p["phases"])
    n_push = 2 * (1 if p3 is None else 7)
    assert [h["hop"] for h in p["hops"]].count("push") == n_push
    rec = tled.RoundRecord("w", 1)
    rec.wire.update(p["wire"])
    rec.declared_rx = p["declared_rx_bytes"]
    assert rec.reconciles()


def test_two_tier_relay_hops_and_server_http_surface(ledgers):
    """A party server relaying to a global server: the relay hop and its
    queue phase on the party's record; the party server's exporter
    answers /metrics, /healthz and /ledger."""
    glob = tsvc.GeoPSServer(num_workers=1, mode="sync", rank=0,
                            device="cpu").start()
    loc = tsvc.GeoPSServer(num_workers=1, mode="sync", rank=1,
                           device="cpu", metrics_port=0,
                           global_addr=("127.0.0.1", glob.port)).start()
    c = tsvc.GeoPSClient(("127.0.0.1", loc.port), sender_id=0)
    try:
        c.init("w", np.zeros(32, np.float32))
        c.push("w", np.ones(32, np.float32))
        c.pull("w", timeout=T)
        recs = [r for r in ledgers["port"].records() if r["key"] == "w"]
        hops = [h["hop"] for r in recs for h in r["hops"]]
        assert "relay" in hops and "merge" in hops
        assert any("queue" in r["phases"] for r in recs)
        base = f"http://127.0.0.1:{loc.metrics_port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        fams = ttel.parse_prometheus_text(text)
        assert "geomx_ledger_rounds_total" in fams
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read())
        assert health["role"] == "ps_server" and health["rank"] == 1
        led = json.loads(urllib.request.urlopen(
            base + "/ledger?n=1", timeout=10).read())
        assert len(led["records"]) == 1
        assert led["summary"]["ledger_completed_total"] >= 1
        summ = json.loads(urllib.request.urlopen(
            base + "/ledger?summary=1", timeout=10).read())
        assert "records" not in summ
    finally:
        c.close()
        loc.stop(forward=False)
        glob.stop(forward=False)
    assert loc._metrics_srv is None


def test_scheduler_serves_ledger_and_refuses_control(ledgers):
    sched = tsvc.GeoScheduler(metrics_port=0).start()
    try:
        ledgers["port"].record_hop("k", 1, "push", party=0)
        base = f"http://127.0.0.1:{sched.metrics_port}"
        doc = json.loads(urllib.request.urlopen(base + "/ledger",
                                                timeout=10).read())
        assert doc["records"][0]["key"] == "k"
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=10).read())
        assert health["build"]["version"] == "0.1.0"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/control", timeout=10)
        assert e.value.code == 501
        assert "Control" in json.loads(e.value.read())["error"]
    finally:
        sched.stop()


# ---- the sharded tier and the chaos path ------------------------------------

def _retry_count(op):
    fam = ttel.get_registry().get("geomx_rpc_retries_total")
    ch = dict(fam.children()).get((op,)) if fam is not None else None
    return 0.0 if ch is None else ch.value


def test_redirect_counts_one_retry_and_ledger_hop(ledgers):
    """A wrong_shard redirect after a rebalance: one retry count, one
    redirect hop naming the refusing shard, no double-counted bytes."""
    from geomx_tpu_torch.service.shardmap import ShardMap
    sched = tsvc.GeoScheduler().start()
    servers = tsvc.start_sharded_global_tier(
        ("127.0.0.1", sched.port), num_shards=2, num_workers=1,
        device="cpu")
    w = tsvc.ShardedGlobalClient(("127.0.0.1", sched.port), sender_id=0)
    sc = tsvc.SchedulerClient(("127.0.0.1", sched.port))
    try:
        m = ShardMap.from_meta(sc.shard_map())
        hot = [k for k in (f"h{i}" for i in range(64))
               if m.shard_for(k) == 0][:4]
        cold = [k for k in (f"c{i}" for i in range(64))
                if m.shard_for(k) == 1][:1]
        for k in hot + cold:
            w.init(k, np.zeros(16, np.float32))
        for _r in range(3):
            for k in hot:
                w.push(k, np.ones(16, np.float32))
                w.pull(k)
        for k in cold:
            w.push(k, np.ones(16, np.float32))
            w.pull(k)
        res = sc.rebalance_shards(min_gain=0.05)
        assert res["changed"]
        m2 = ShardMap.from_meta(res["map"])
        moved = next(k for k in hot if m2.shard_for(k) != 0)
        before = _retry_count("redirect")
        w.push(moved, np.ones(16, np.float32))
        assert _retry_count("redirect") - before == 1
        rnd = w._rounds[moved]
        rec = ledgers["port"].get(moved, rnd)
        redirects = [h for h in rec["hops"] if h["hop"] == "redirect"]
        assert len(redirects) == 1 and redirects[0]["shard"] == 0
        assert redirects[0]["detail"]["map_version"] >= 2
        pushes = [h for h in rec["hops"] if h["hop"] == "push"]
        assert len(pushes) == 2
        assert rec["wire"]["push_tx_bytes"] == \
            sum(h["nbytes"] for h in pushes)
        w.pull(moved)
        assert ledgers["port"].get(moved, rnd)["status"] == "complete"
    finally:
        sc.close()
        w.close()
        for srv in servers:
            srv.stop(forward=False)
        sched.stop()


def test_failover_replay_hop(ledgers, tmp_path):
    """A shard crashes with round 2 open; the replacement on a new port
    takes the failover, and the wrapper's re-push of the lost round is a
    failover_replay hop on that shard; the round completes."""
    from geomx_tpu_torch.service.shardmap import even_bounds, key_hash
    bounds = even_bounds(2)
    key = next(k for k in (f"p{i}" for i in range(256))
               if bisect.bisect_right(bounds, key_hash(k)) - 1 == 1)
    sched = tsvc.GeoScheduler(durable_dir=str(tmp_path / "sched")).start()
    addr = ("127.0.0.1", sched.port)
    tier = str(tmp_path / "tier")
    servers = tsvc.start_sharded_global_tier(addr, num_shards=2,
                                             num_workers=2,
                                             durable_dir=tier, device="cpu")
    kw = dict(reconnect=True, p3_slice_elems=32, reconnect_timeout_s=3.0,
              op_timeout_s=60.0)
    w = tsvc.ShardedGlobalClient(addr, sender_id=4242, **kw)
    w2 = tsvc.ShardedGlobalClient(addr, sender_id=4243, **kw)
    repl = None
    try:
        for c in (w, w2):
            c.init(key, np.zeros(64, np.float32))
        w.push(key, np.ones(64, np.float32))
        w2.push(key, np.ones(64, np.float32))
        w.pull(key, timeout=T)
        w2.pull(key, timeout=T)
        w.push(key, np.ones(64, np.float32))     # round 2 open (1/2)
        servers[1].crash()
        repl = tsvc.GeoPSServer(num_workers=2, mode="sync", accumulate=True,
                                rank=1, shard_index=1, port=0,
                                shard_range=(bounds[1], bounds[2]),
                                shard_map_version=1, durable_dir=tier,
                                durable_name="shard1", device="cpu").start()
        sc = tsvc.SchedulerClient(addr)
        try:
            sc.shard_failover(1, "127.0.0.1", repl.port)
        finally:
            sc.close()
        t = threading.Thread(
            target=lambda: w2.push(key, np.ones(64, np.float32)),
            daemon=True)
        t.start()
        val = w.pull(key, timeout=60.0)
        t.join(30.0)
        assert np.allclose(val, 4.0)
        rec = ledgers["port"].get(key, 2)
        assert any(h["hop"] == "failover_replay" and h["shard"] == 1
                   for h in rec["hops"])
        deadline = time.monotonic() + 10.0
        while ledgers["port"].get(key, 2)["status"] != "complete" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ledgers["port"].get(key, 2)["status"] == "complete"
    finally:
        w.close()
        w2.close()
        for s in (servers[0], repl):
            if s is not None:
                s.stop(forward=False)
        sched.stop()


def test_session_resume_replay_hop(ledgers, tmp_path):
    """A server restarted in place with round 2 open: the client's
    session resume re-pushes the lost round as a replay hop, and the
    pull queued during the outage sees the replayed round."""
    srv = tsvc.GeoPSServer(num_workers=2, mode="sync", accumulate=True,
                           durable_dir=str(tmp_path), durable_name="g",
                           device="cpu").start()
    port = srv.port
    ca = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=0, reconnect=True,
                          p3_slice_elems=32)
    cb = tsvc.GeoPSClient(("127.0.0.1", port), sender_id=1, reconnect=True,
                          p3_slice_elems=32)
    srv2 = None
    try:
        for c in (ca, cb):
            c.init("w", np.zeros(64, np.float32))
        ca.push("w", np.ones(64, np.float32))
        cb.push("w", np.ones(64, np.float32))
        assert np.allclose(ca.pull("w", timeout=T), 2.0)
        assert np.allclose(cb.pull("w", timeout=T), 2.0)
        ca.push("w", np.full(64, 5.0, np.float32))   # round 2 open
        time.sleep(0.2)
        srv.crash()
        got = []
        t = threading.Thread(target=lambda: got.append(
            ca.pull("w", timeout=T)), daemon=True)
        t.start()
        time.sleep(0.1)
        srv2 = tsvc.GeoPSServer(num_workers=2, mode="sync", accumulate=True,
                                port=port, durable_dir=str(tmp_path),
                                durable_name="g", device="cpu").start()
        cb.push("w", np.ones(64, np.float32))
        t.join(T)
        assert got and np.allclose(got[0], 8.0)
        rec = ledgers["port"].get("w", 2)
        assert rec["status"] == "complete"
        assert any(h["hop"] == "replay" for h in rec["hops"])
    finally:
        for c in (ca, cb):
            c.close()
        for s in (srv, srv2):
            if s is not None:
                try:
                    s.stop(forward=False)
                except Exception:
                    pass


# ---- the ledger's consumers -------------------------------------------------

def test_flight_ledger_rules_match_jax():
    """``stuck_round`` and ``honesty_ratio_drift`` fire at the same
    records in both packages."""
    out = {}
    for pkg, (L, F) in {"jax": (jled, jflight),
                        "port": (tled, tflight)}.items():
        led = L.RoundLedger(capacity=8)
        led.record_hop("w", 1, "push")
        t0 = led.get("w", 1)["opened_unix"]
        fr = F.FlightRecorder(capacity=64, stuck_round_s=30.0,
                              honesty_drift=0.25, min_history=5)
        fired = [fr.record_ledger(1, ledger=led, now=t0 + 5.0),
                 fr.record_ledger(2, ledger=led, now=t0 + 31.0)]
        for s in range(8):
            fired.append(fr.record(10 + s, {"wire_honesty_ratio": 1.1}))
        fired.append(fr.record(18, {"wire_honesty_ratio": 1.6}))
        out[pkg] = [[(f["rule"], f["step"]) for f in fs] for fs in fired]
    assert out["port"] == out["jax"]
    assert out["port"][1] == [(tflight.STUCK_ROUND, 2)]
    assert out["port"][-1] == [(tflight.HONESTY_DRIFT, 18)]


def test_ledger_feeds_links_and_traces_like_jax():
    """``LinkObservatory.ingest_ledger`` and ``RoundLedger.to_doc`` over
    the same hops (explicit ``t``) agree with the JAX package's."""
    snaps, linked = {}, {}
    for pkg, (L, K, tel) in {"jax": (jled, jlinks, jtel),
                             "port": (tled, tlinks, ttel)}.items():
        led = L.RoundLedger(capacity=16)
        t0 = 1_000_000.0
        for party in (0, 1):
            led.record_hop("w", 1, "push", party=party, nbytes=4096,
                           t=t0 + party * 0.01)
        led.record_hop("w", 1, "merge", shard=0, t=t0 + 0.1)
        led.complete("w", 1)
        led.record_hop("x", 1, "push", party=2, nbytes=100, t=t0)
        led.orphan(key="x", reason="relay_failed")
        obs = K.LinkObservatory()
        assert obs.ingest_ledger(led.records()) >= 3
        snaps[pkg] = obs.snapshot(now=t0 + 1.0)
        merged = tel.merge_traces([led.to_doc(label="ledger")],
                                  labels=["ledger"])
        linked[pkg] = sorted((k, len(v)) for k, v in
                             tel.rounds_in_trace(merged).items())
    assert json.dumps(snaps["port"], sort_keys=True) == \
        json.dumps(snaps["jax"], sort_keys=True)
    assert snaps["port"]["party2->global"]["loss_rate"] > 0
    assert linked["port"] == linked["jax"]
