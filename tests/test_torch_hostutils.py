"""The host plane's utilities in the port against the JAX package's:
the seeded retry backoff, the shard map and its rebalance helpers, the
heartbeat monitor, the metric registry, the port reservation and the
profiler (its Chrome-trace document, and the device trace it takes with
torch.profiler where the JAX package takes jax.profiler's)."""

import json
import os
import socket
import time

import pytest

import geomx_tpu.service.retry as jretry
import geomx_tpu.service.shardmap as jsm
import geomx_tpu.telemetry.registry as jreg
import geomx_tpu.utils.heartbeat as jhb
import geomx_tpu.utils.profiler as jprof
import geomx_tpu_torch.service.retry as tretry
import geomx_tpu_torch.service.shardmap as tsm
import geomx_tpu_torch.telemetry.registry as treg
import geomx_tpu_torch.utils.heartbeat as thb
import geomx_tpu_torch.utils.profiler as tprof
from geomx_tpu_torch.utils.net import free_port_blocks


@pytest.mark.parametrize("kw", [{}, {"seed": 7, "base_s": 0.01,
                                     "factor": 3.0, "max_s": 0.5,
                                     "jitter": 0.25}])
def test_seeded_backoff_equal(kw):
    a, b = tretry.SeededBackoff(**kw), jretry.SeededBackoff(**kw)
    assert [a.next() for _ in range(12)] == [b.next() for _ in range(12)]


def test_call_with_retries_counts_and_reraises():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("down")
        return "up"

    reg = treg.reset_registry()
    assert tretry.call_with_retries("t", flaky, attempts=5,
                                    sleep=sleeps.append) == "up"
    assert len(sleeps) == 2
    fam = reg.get("geomx_rpc_retries_total")
    assert sum(c.value for _, c in fam.children()) == 2
    with pytest.raises(OSError):
        tretry.call_with_retries("t", lambda: (_ for _ in ()).throw(
            OSError("x")), attempts=2, sleep=lambda s: None)
    with pytest.raises(ValueError):
        tretry.call_with_retries("t", flaky, attempts=0)


def test_shardmap_equal():
    keys = [f"layer{i}.w" for i in range(40)]
    assert [tsm.key_hash(k) for k in keys] == [jsm.key_hash(k) for k in keys]
    for s in (1, 3, 8):
        assert tsm.even_bounds(s) == jsm.even_bounds(s)
    addrs = [("127.0.0.1", 9000 + i) for i in range(3)]
    tm, jm = tsm.ShardMap.initial(addrs), jsm.ShardMap.initial(addrs)
    assert tm.to_meta() == jm.to_meta()
    assert [tm.owner(k) for k in keys] == [jm.owner(k) for k in keys]
    loads = {k: float(i % 7 + (30 if i < 5 else 0))
             for i, k in enumerate(keys)}
    tb = tsm.rebalance_bounds(tm, loads, min_gain=0.0)
    assert tb == jsm.rebalance_bounds(jm, loads, min_gain=0.0)
    tn, jn = tm.with_bounds(tb), jm.with_bounds(tb)
    assert tsm.moved_segments(tm, tn) == jsm.moved_segments(jm, jn)
    assert tsm.ShardMap.from_meta(jn.to_meta()).to_meta() == tn.to_meta()
    assert tm.with_address(1, "h", 1).to_meta() == \
        jm.with_address(1, "h", 1).to_meta()


def test_heartbeat_monitor():
    for mod in (thb, jhb):
        hb = mod.HeartbeatMonitor(timeout_s=0.2)
        hb.register(1)
        hb.heartbeat(2)
        assert hb.dead_nodes() == [] and sorted(hb.alive_nodes()) == [1, 2]
        time.sleep(0.3)
        hb.heartbeat(2)
        assert hb.dead_nodes() == [1] and hb.num_dead_nodes == 1
        hb.unregister(1)
        assert hb.dead_nodes() == [] and hb.alive_nodes() == [2]


def test_metric_registry_equal():
    out = []
    for mod in (treg, jreg):
        r = mod.MetricRegistry()
        c = r.counter("geomx_x_total", "x", ("op",))
        c.labels(op="a").inc()
        c.labels("b").inc(2.5)
        g = r.gauge("geomx_g", "g")
        g.set(4)
        g.dec()
        h = r.histogram("geomx_h_seconds", "h", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        with pytest.raises(ValueError):
            r.gauge("geomx_x_total")
        out.append(([(lbl, ch.value) for lbl, ch in c.children()],
                    g._solo().value, h._solo().snapshot(),
                    h._solo().percentile(0.5), sorted(f.name
                                                      for f in r.collect())))
    assert out[0] == out[1]


def test_free_port_blocks_are_bindable():
    bases = free_port_blocks(1, 3, 2)
    ports = [bases[0], *(bases[1] + i for i in range(3)),
             *(bases[2] + i for i in range(2))]
    assert len(set(ports)) == 6
    socks = []
    try:
        for p in ports:
            s = socket.socket()
            s.bind(("127.0.0.1", p))
            socks.append(s)
    finally:
        for s in socks:
            s.close()


def _trace(mod, path):
    p = mod.Profiler(filename=str(path), rank=3)
    p.set_state(True)
    with p.scope("ServerPush:w", "kvstore", args={"key": "w"}):
        time.sleep(0.001)
    p.instant("ServerMerge:w", "kvstore", args={"round_id": 1})
    p.counter("inflight", {"bytes": 10})
    p.set_state(False)
    p.instant("ignored")
    return p


def test_profiler_document_matches_jax(tmp_path):
    tp = _trace(tprof, tmp_path / "t.json")
    jp = _trace(jprof, tmp_path / "j.json")
    td, jd = tp.to_doc(), jp.to_doc()

    def shape(doc):
        return [(e["name"], e["ph"], e.get("cat"), e.get("args"))
                for e in doc["traceEvents"] if e["ph"] != "M"]
    assert shape(td) == shape(jd)
    assert {k: td["metadata"][k] for k in ("rank", "num_events",
                                            "num_spans", "dropped_events")} \
        == {k: jd["metadata"][k] for k in ("rank", "num_events",
                                            "num_spans", "dropped_events")}
    path = tp.dump()
    assert os.path.basename(path) == "rank3_t.json"
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert tp.aggregate_stats().keys() == jp.aggregate_stats().keys()
    assert tprof.get_profiler() is tprof.get_profiler()


def test_profiler_device_trace_uses_torch_profiler(tmp_path):
    import torch
    p = tprof.Profiler()
    p.start_device_trace(str(tmp_path / "dev"))
    p.set_state(True)
    with p.scope("host-span"):
        torch.ones(64).sum()
    path = p.stop_device_trace()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "host-span" in names
    assert p.stop_device_trace() is None
