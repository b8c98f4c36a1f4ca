"""The port's client and server features beyond tests/test_service.py,
held against the JAX package's semantics over the three fleets of
tests/test_torch_service.py (port with port, a JAX server with port
clients, port servers with JAX clients): resend under drop injection
and its dedup, P3 chunked pushes and pulls, row-sparse pushes with the
lazy optimizer, DGT pushes with their fp16 tail and best-effort blocks,
TSEngine's ASK1 relay tree, and a worker's recover()."""

import time

import numpy as np
import pytest

from test_torch_service import FLEETS, T, _push

import geomx_tpu.service.client as jclient
import geomx_tpu_torch.service.client as tclient


@pytest.fixture(params=list(FLEETS))
def fleet(request):
    import types
    s, c = FLEETS[request.param]
    return types.SimpleNamespace(S=s.Server, C=c.Client, srv=s, cli=c)


def test_push_pull_survives_drops_and_resend_dedups(fleet, monkeypatch):
    monkeypatch.setenv("GEOMX_DROP_MSG", "20")
    server = fleet.S(num_workers=1, mode="sync", accumulate=True).start()
    c = fleet.C(("127.0.0.1", server.port), sender_id=0,
                resend_timeout_ms=50)
    n = 256
    c.init("w", np.zeros(n, np.float32))
    for r in range(20):
        _push(c, "w", np.ones(n, np.float32))
        np.testing.assert_allclose(c.pull("w", timeout=T), r + 1.0)
    monkeypatch.setenv("GEOMX_DROP_MSG", "0")
    # a replayed signature (same sender, same rid) merges once
    proto = fleet.cli.proto
    m = proto.Msg(proto.MsgType.PUSH, key="w", array=np.ones(n, np.float32))
    m.sender = 0
    m.meta.update(rid=10_000, resend=True)
    frame = m.encode()
    for _ in range(3):
        c._sendq.push(frame, 0)
    time.sleep(0.3)
    np.testing.assert_allclose(c.pull("w", timeout=T), 21.0)
    c.stop_server()
    c.close()
    server.join(5)


def test_p3_chunked_push_and_pull(fleet):
    server = fleet.S(num_workers=1, mode="sync").start()
    c = fleet.C(("127.0.0.1", server.port), sender_id=0,
                p3_slice_elems=1000)
    c.reply_log = []
    n = 4096
    g = np.random.RandomState(0).randn(n).astype(np.float32)
    c.init("w", np.zeros(n, np.float32))
    _push(c, "w", g)
    assert np.array_equal(c.pull("w", timeout=T), g)
    chunks = [e for e in server.push_log if e[1] == "w" and e[2] is not None]
    assert len(chunks) == 5  # 4096 at slice 1000
    pulled = [e for e in c.reply_log if e[0] == "w" and e[1] is not None]
    assert len(pulled) == 5
    c.stop_server()
    c.close()


def test_row_sparse_accumulate_and_lazy_optimizer(fleet, monkeypatch):
    server = fleet.S(num_workers=1, mode="sync").start()
    c = fleet.C(("127.0.0.1", server.port), sender_id=0)
    c.init("emb", np.zeros((10, 4), np.float32))
    vals = np.stack([np.full(4, 1.0), np.full(4, 2.0),
                     np.full(4, 5.0)]).astype(np.float32)
    c.push_row_sparse("emb", np.array([1, 3, 3]), vals, timeout=T)
    got = c.pull_row_sparse("emb", [1, 3, 0], timeout=T)
    np.testing.assert_allclose(got[0], 1.0)
    np.testing.assert_allclose(got[1], 7.0)
    np.testing.assert_allclose(got[2], 0.0)
    c.init("tab", np.ones((6, 3), np.float32))
    monkeypatch.setenv("GEOMX_NATIVE_SGD", "0")
    c.set_optimizer("momentum", learning_rate=0.5, momentum=0.9)
    monkeypatch.delenv("GEOMX_NATIVE_SGD")
    for step in range(2):
        c.push_row_sparse("tab", [0, 2], np.full((2, 3), 1.0, np.float32),
                          timeout=T)
    out = c.pull("tab", timeout=T)
    # two momentum steps on the touched rows: 1 - 0.5 * (1 + 1.9)
    np.testing.assert_allclose(out[[0, 2]], 1.0 - 0.5 * 2.9, rtol=1e-6)
    np.testing.assert_allclose(out[[1, 3, 4, 5]], 1.0)
    c.stop_server()
    c.close()


def test_dgt_push_fp16_tail_and_best_effort(fleet, monkeypatch):
    server = fleet.S(num_workers=1, mode="sync").start()
    c = fleet.C(("127.0.0.1", server.port), sender_id=0)
    n, block = 4096, 512
    g = np.zeros(n, np.float32)
    g[2 * block:3 * block] = 3.0
    g[5 * block:6 * block] = -4.0
    g[:block] = 0.001
    c.init("w", np.zeros(n, np.float32))
    c.wait(c.push_dgt("w", g, k=0.25, block_elems=block, channels=2,
                      wait=False), timeout=T)
    out = c.pull("w", timeout=T)
    np.testing.assert_allclose(out[2 * block:3 * block], 3.0)
    np.testing.assert_allclose(out[5 * block:6 * block], -4.0)
    np.testing.assert_allclose(out, g.astype(np.float16).astype(np.float32),
                               atol=1e-3)
    # best effort: every deferred block lost, the round still completes
    # on the reliable top-k blocks after the deadline
    monkeypatch.setenv("GEOMX_DGT_DEADLINE_MS", "100")
    monkeypatch.setenv("GEOMX_DROP_MSG", "100")
    c.init("v", np.zeros(n, np.float32))
    c.push_dgt("v", g, k=0.25, block_elems=block, channels=2,
               best_effort=True)
    # the server decides a drop when a frame arrives, and the deferred
    # blocks are still in flight when push_dgt returns: keep the drop
    # rate on through the pull, which is never droppable
    out = c.pull("v", timeout=T, meta={"min_round": 1})
    monkeypatch.setenv("GEOMX_DROP_MSG", "0")
    np.testing.assert_allclose(out[2 * block:3 * block], 3.0)
    np.testing.assert_allclose(out[5 * block:6 * block], -4.0)
    assert np.all(out[:block] == 0.0)
    c.stop_server()
    c.close()


def test_dscp_ladder_parsing_equal():
    for spec in (None, "", "off", "0", "46,34", "EF,af41,cs1"):
        assert tclient.GeoPSClient._parse_dscp(spec) == \
            jclient.GeoPSClient._parse_dscp(spec)
    for bad in ("99", "gold"):
        with pytest.raises(ValueError):
            tclient.GeoPSClient._parse_dscp(bad)


def test_intra_ts_relay_aggregate_equals_direct_sum(fleet):
    server = fleet.S(num_workers=3, mode="sync", auto_pull=True).start()
    clients = [fleet.C(("127.0.0.1", server.port), sender_id=i,
                       auto_pull=True, ts_node=i + 1) for i in range(3)]
    n = 500
    rng = np.random.RandomState(0)
    grads = [rng.randn(n).astype(np.float32) for _ in range(3)]
    for c in clients:
        c.init("w", np.zeros(n, np.float32))
    for c, g in zip(clients, grads):
        c.ts_push("w", g)
    outs = [c.auto_pull("w", min_version=1, timeout=T) for c in clients]
    for out in outs:
        np.testing.assert_allclose(out, np.sum(grads, axis=0), rtol=1e-5,
                                   atol=1e-5)
    assert len([e for e in server.push_log if e[1] == "w"]) == 1
    for c in clients:
        c.stop_server()
        c.close()


def test_worker_restart_recovers_its_rounds(fleet):
    server = fleet.S(num_workers=2, mode="sync", accumulate=True).start()
    c0 = fleet.C(("127.0.0.1", server.port), sender_id=0)
    c1 = fleet.C(("127.0.0.1", server.port), sender_id=1)
    n = 200
    for c in (c0, c1):
        c.init("w", np.zeros(n, np.float32))
    _push(c0, "w", np.full(n, 1.0, np.float32))
    _push(c1, "w", np.full(n, 2.0, np.float32))
    assert np.allclose(c0.pull("w", timeout=T), 3.0)
    c1._sock.close()
    c1b = fleet.C(("127.0.0.1", server.port), sender_id=1)
    c1b.init("w", np.zeros(n, np.float32))
    assert c1b.recover()["w"] == 1
    _push(c0, "w", np.full(n, 1.0, np.float32))
    _push(c1b, "w", np.full(n, 2.0, np.float32))
    assert np.allclose(c0.pull("w", timeout=T), 6.0)
    assert np.allclose(c1b.pull("w", timeout=T), 6.0)
    c0.stop_server()
    c1b.stop_server()
    for c in (c0, c1b):
        c.close()
