"""Port parity: the serving plane's registry, replica and wires
(geomx_tpu_torch/serve/registry.py, replica.py, infer_wire.py) against
the JAX package's (geomx_tpu/serve/).

The same seeded numpy inputs go through both packages' registries and
replicas: materialized weights, refresh plans, dedup counters and the
O(k) fast path's counters agree exactly, and both track a dense
``np.add.at`` checkpoint bit for bit.  Every registry frame and every
``INFER`` frame a port client sends is byte-identical to the JAX
client's for the same calls (a recording peer on a socket keeps both
streams), the replies a port ``RegistryServer`` sends are
byte-identical to a JAX server's for the same state, and a port client
and replica sync from a JAX server and the other way round.  The cases
of ``tests/test_serve.py``'s registry, replica and native-lane tests
run against the port.
"""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

import geomx_tpu.serve.infer_wire as jwire
import geomx_tpu.serve.registry as jreg
import geomx_tpu.serve.replica as jrep
import geomx_tpu.service.protocol as jproto
import geomx_tpu_torch.serve.infer_wire as twire
import geomx_tpu_torch.serve.registry as treg
import geomx_tpu_torch.serve.replica as trep
import geomx_tpu_torch.service.protocol as tproto
from geomx_tpu_torch.serve.gateway import InferenceGateway
from geomx_tpu_torch.telemetry.ledger import (get_request_ledger,
                                              reset_request_ledger)

PKGS = {"jax": (jreg, jrep, jproto, jwire),
        "port": (treg, trep, tproto, twire)}


def _wait_for(cond, timeout=10.0, what="condition"):
    """Poll ``cond`` until it holds or the deadline passes."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# --------------------------------------------------------------------------
# registry core, both packages on the same inputs
# --------------------------------------------------------------------------

def _publish_with_deltas(reg, rng, version="v1", rounds=3, layers=2,
                         dims=(12, 5)):
    params = {f"{i:04d}/layer{i}": rng.normal(size=(dims[i % len(dims)],))
              .astype(np.float32) for i in range(layers)}
    reg.publish(version, params)
    dense = {k: v.copy() for k, v in params.items()}
    for r in range(1, rounds + 1):
        for k in params:
            n = dense[k].size
            idx = rng.choice(n, size=max(1, n // 3),
                             replace=False).astype(np.int64)
            vals = rng.normal(size=idx.size).astype(np.float32)
            assert reg.apply_delta(version, k, r, vals, idx,
                                   sender=1, rid=f"{r}/{k}")
            np.add.at(dense[k].reshape(-1), idx, vals)
    return params, dense


def _both(seed, durable=None, **kw):
    """Each package's registry fed the same seeded publish + deltas."""
    out = {}
    for pkg, (reg_mod, *_rest) in PKGS.items():
        d = None if durable is None else os.path.join(durable, pkg)
        reg = reg_mod.ModelRegistry(durable_dir=d)
        params, dense = _publish_with_deltas(
            reg, np.random.default_rng(seed), **kw)
        out[pkg] = (reg, params, dense)
    return out


def test_base_plus_delta_reconstruction_bit_exact():
    """materialize() == a dense np.add.at checkpoint, bit for bit, in
    both packages."""
    both = _both(0, rounds=4)
    for pkg, (reg, params, dense) in both.items():
        mat = reg.materialize("v1")
        for k in params:
            assert np.array_equal(mat[k], dense[k]), (pkg, k)
    jm, tm = (both[p][0].materialize("v1") for p in ("jax", "port"))
    assert list(jm) == list(tm)
    for k in jm:
        assert jm[k].tobytes() == tm[k].tobytes(), k


def test_delta_apply_idempotent_both_dedup_keys():
    """A re-push of an applied (layer, round) and a (sender, rid) replay
    under a new round both dedup, in both packages alike."""
    for pkg, (reg, params, _dense) in _both(1, rounds=2).items():
        k = next(iter(params))
        vals = np.ones(2, np.float32)
        idx = np.array([0, 1], np.int64)
        before = reg.materialize("v1")
        assert reg.apply_delta("v1", k, 2, vals, idx,
                               sender=1, rid="fresh") is False
        assert reg.apply_delta("v1", k, 99, vals, idx,
                               sender=1, rid=f"2/{k}") is False
        assert reg.replays_deduped == 2, pkg
        after = reg.materialize("v1")
        for name in params:
            assert np.array_equal(before[name], after[name]), (pkg, name)


def _plan_key(plan):
    return [(f["layer"], f["base"], f["round"],
             (f["arr"] if f["base"] else f["vals"]).tobytes(),
             b"" if f["base"] else f["idx"].tobytes()) for f in plan]


def test_pending_plan_is_early_layer_first():
    """P3 refresh order: bases in publish order, then deltas layer-major
    with rounds ascending — the same plan in both packages."""
    both = _both(2, rounds=3, layers=3, dims=(8, 6, 4))
    plans = {}
    for pkg, (reg, params, _dense) in both.items():
        order = list(params)
        plan = reg.pending("v1", since_round=0, need_base=True)
        bases = [f for f in plan if f["base"]]
        deltas = [f for f in plan if not f["base"]]
        assert plan[:len(bases)] == bases
        assert [f["layer"] for f in bases] == order
        ranks = [(order.index(f["layer"]), f["round"]) for f in deltas]
        assert ranks == sorted(ranks)
        inc = reg.pending("v1", since_round=2, need_base=False)
        assert all(not f["base"] and f["round"] > 2 for f in inc)
        assert len(inc) == len(order)
        plans[pkg] = _plan_key(plan)
    assert plans["port"] == plans["jax"]


def test_torn_journal_tail_truncates_and_replays(tmp_path):
    """A kill mid-append: garbage after the last whole record is cut on
    reload and the replay materializes bit-exact, dedup state kept."""
    rng = np.random.default_rng(3)
    reg = treg.ModelRegistry(durable_dir=str(tmp_path))
    params, dense = _publish_with_deltas(reg, rng, rounds=3)
    reg.close()
    journal = os.path.join(str(tmp_path), "registry.journal")
    size = os.path.getsize(journal)
    with open(journal, "ab") as f:
        f.write(b"\x00TORN-MID-DELTA\xff" * 3)
    reg2 = treg.ModelRegistry(durable_dir=str(tmp_path))
    assert os.path.getsize(journal) == size
    mat = reg2.materialize("v1")
    for k in params:
        assert np.array_equal(mat[k], dense[k]), k
    assert reg2.apply_delta("v1", next(iter(params)), 1,
                            np.ones(1, np.float32), np.zeros(1, np.int64),
                            sender=1, rid="anything") is False
    reg2.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_registry_journal_reads_across_packages(tmp_path, writer,
                                                reader):
    """A registry journaled by one package recovers in the other: the
    same weights bit for bit and the same dedup state."""
    rng = np.random.default_rng(15)
    reg = PKGS[writer][0].ModelRegistry(durable_dir=str(tmp_path))
    params, dense = _publish_with_deltas(reg, rng, rounds=3)
    reg.close()
    other = PKGS[reader][0].ModelRegistry(durable_dir=str(tmp_path))
    mat = other.materialize("v1")
    for k in params:
        assert np.array_equal(mat[k], dense[k]), k
    assert other.generation == 2
    assert other.apply_delta("v1", next(iter(params)), 2,
                             np.ones(1, np.float32), np.zeros(1, np.int64),
                             sender=1, rid="x") is False
    other.close()


def test_compaction_preserves_state_and_dedup(tmp_path):
    rng = np.random.default_rng(5)
    reg = treg.ModelRegistry(durable_dir=str(tmp_path))
    params, dense = _publish_with_deltas(reg, rng, rounds=3)
    pre = reg.journal_bytes()
    reg.compact()
    assert reg.journal_bytes() < pre
    reg.close()
    reg2 = treg.ModelRegistry(durable_dir=str(tmp_path))
    mat = reg2.materialize("v1")
    for k in params:
        assert np.array_equal(mat[k], dense[k]), k
    assert reg2.apply_delta("v1", next(iter(params)), 3,
                            np.ones(1, np.float32), np.zeros(1, np.int64),
                            sender=1, rid="x") is False
    reg2.close()


# --------------------------------------------------------------------------
# the registry wire
# --------------------------------------------------------------------------

def _server(pkg, **kw):
    return PKGS[pkg][0].RegistryServer(**kw).start()


def _stop(srv):
    srv.stop()
    srv.join(5.0)


@pytest.mark.parametrize("srv_pkg,cli_pkg", [("port", "port"),
                                             ("jax", "port"),
                                             ("port", "jax")])
def test_generation_token_detects_restart(tmp_path, srv_pkg, cli_pkg):
    """Every server start on the same durable dir bumps the generation;
    a replica syncing across a restart reports it and ends bit-exact —
    across packages too."""
    rng = np.random.default_rng(4)
    reg = PKGS[srv_pkg][0].ModelRegistry(durable_dir=str(tmp_path))
    params, dense = _publish_with_deltas(reg, rng, rounds=2)
    reg.close()
    reg_mod, rep_mod = PKGS[cli_pkg][0], PKGS[cli_pkg][1]
    srv = _server(srv_pkg, durable_dir=str(tmp_path))
    cli = reg_mod.RegistryClient(srv.addr, sender=5, timeout_s=10.0)
    rep = rep_mod.ServingReplica("v1")
    out = rep.sync(cli)
    assert out["applied"] > 0 and not out["restart_detected"]
    gen1 = out["gen"]
    cli.close()
    srv.crash()
    srv.join(5.0)
    srv2 = _server(srv_pkg, durable_dir=str(tmp_path))
    try:
        assert srv2.generation == gen1 + 1
        cli2 = reg_mod.RegistryClient(srv2.addr, sender=5, timeout_s=10.0)
        out2 = rep.sync(cli2)
        assert out2["restart_detected"] is True
        assert rep.restarts_detected == 1
        for k in params:
            assert np.array_equal(rep.params()[k], dense[k]), k
        cli2.close()
    finally:
        _stop(srv2)


def test_partial_round_push_is_not_lost_across_sync():
    """The per-layer since map keeps a straggler layer's round pending
    after a sync that landed mid-round."""
    rng = np.random.default_rng(12)
    srv = _server("port")
    trainer = treg.RegistryClient(srv.addr, sender=0, timeout_s=10.0)
    rcli = treg.RegistryClient(srv.addr, sender=1, timeout_s=10.0)
    try:
        params = {"0000/a": rng.normal(size=(8,)).astype(np.float32),
                  "0001/b": rng.normal(size=(6,)).astype(np.float32)}
        trainer.publish("v1", params)
        dense = {k: v.copy() for k, v in params.items()}
        rep = trep.ServingReplica("v1")
        rep.sync(rcli)
        va, ia = np.float32([0.5, -0.5]), np.array([0, 3], np.int64)
        trainer.push_delta("v1", 1, {"0000/a": (va, ia)})
        np.add.at(dense["0000/a"], ia, va)
        mid = rep.sync(rcli)
        assert mid["applied"] == 1 and rep.last_round() == 1
        vb, ib = np.float32([1.0]), np.array([2], np.int64)
        trainer.push_delta("v1", 1, {"0001/b": (vb, ib)})
        np.add.at(dense["0001/b"], ib, vb)
        out = rep.sync(rcli)
        assert out["applied"] == 1, "straggler layer's round was lost"
        for k in dense:
            assert np.array_equal(rep.params()[k], dense[k]), k
    finally:
        trainer.close()
        rcli.close()
        _stop(srv)


def test_bad_push_answers_error_frame_not_dead_socket():
    rng = np.random.default_rng(13)
    srv = _server("port")
    cli = treg.RegistryClient(srv.addr, sender=0, timeout_s=10.0)
    try:
        vals, idx = np.ones(1, np.float32), np.zeros(1, np.int64)
        with pytest.raises(RuntimeError, match="unpublished"):
            cli.push_delta("ghost", 1, {"0000/w": (vals, idx)})
        cli.publish("v1", {"0000/w": rng.normal(size=(4,))
                           .astype(np.float32)})
        with pytest.raises(RuntimeError, match="no base layer"):
            cli.push_delta("v1", 1, {"9999/nope": (vals, idx)})
        ack = cli.push_delta("v1", 1, {"0000/w": (vals, idx)})
        assert ack["applied_layers"] == 1
        assert cli.replays_sent == 0
    finally:
        cli.close()
        _stop(srv)


class _RecordingPeer:
    """A socket peer that records every frame it receives and answers
    each with one fixed ACK frame (encoded by the JAX package)."""

    def __init__(self):
        self.frames = []
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.addr = self._srv.getsockname()
        ack = jproto.Msg(jproto.MsgType.ACK, sender=-1,
                         meta={"gen": 1, "applied": 1, "rid": 0,
                               "last_round": 0}).encode()
        self._ack = struct.pack("<I", len(ack)) + ack
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _recv(self, conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _run(self):
        conn, _ = self._srv.accept()
        with conn:
            while True:
                head = self._recv(conn, 4)
                if head is None:
                    return
                body = self._recv(conn, struct.unpack("<I", head)[0])
                if body is None:
                    return
                self.frames.append(head + body)
                conn.sendall(self._ack)

    def close(self):
        self._srv.close()
        self._t.join(5.0)


def _client_frames(pkg, calls):
    peer = _RecordingPeer()
    cli = PKGS[pkg][0].RegistryClient(peer.addr, sender=3, timeout_s=10.0)
    try:
        calls(cli)
    finally:
        cli.close()
        peer.close()
    return peer.frames


def test_registry_client_frames_byte_identical():
    """publish, push_delta (pair payloads), pull (with and without the
    per-layer since map), info and compact: the port client's frames
    are the JAX client's, byte for byte."""
    rng = np.random.default_rng(21)
    params = {f"{i:04d}['params']['l{i}']": rng.normal(size=(5, 3))
              .astype(np.float32) for i in range(3)}
    deltas = {k: (rng.normal(size=4).astype(np.float32),
                  rng.choice(15, 4, replace=False).astype(np.int64))
              for k in params}

    def calls(cli):
        cli.publish("v1", params)
        cli.push_delta("v1", 1, deltas)
        cli.pull_updates("v1", 0, need_base=True)
        cli.pull_updates("v1", 1, since_layers={k: 1 for k in params})
        cli.info()
        cli.compact()

    jf, tf = _client_frames("jax", calls), _client_frames("port", calls)
    assert len(tf) == len(jf) == 3 + 3 + 2 + 2
    for i, (a, b) in enumerate(zip(jf, tf)):
        assert a == b, i


def _raw_exchange(addr, frame_bytes, until_ack=True):
    """Send raw frames; collect every reply frame's bytes up to ACK."""
    with socket.create_connection(addr, timeout=10.0) as s:
        s.sendall(frame_bytes)
        out = []
        while True:
            head = b""
            while len(head) < 4:
                head += s.recv(4 - len(head))
            n = struct.unpack("<I", head)[0]
            body = b""
            while len(body) < n:
                body += s.recv(n - len(body))
            out.append(head + body)
            msg = jproto.Msg.decode(body)
            if msg.type in (jproto.MsgType.ACK, jproto.MsgType.ERROR) \
                    or not until_ack:
                return out


def test_registry_server_replies_byte_identical():
    """The same PULL frames to a JAX and a port server holding the same
    published state get the same reply streams, byte for byte (bases,
    pair deltas, the terminal ACK; errors too)."""
    rng = np.random.default_rng(22)
    params = {f"{i:04d}/w{i}": rng.normal(size=(7,)).astype(np.float32)
              for i in range(3)}
    rounds = [{k: (rng.normal(size=3).astype(np.float32),
                   rng.choice(7, 3, replace=False).astype(np.int64))
               for k in params} for _ in range(2)]
    pulls = [jproto.Msg(jproto.MsgType.PULL, key="v1", sender=9,
                        meta={"since": 0, "need_base": 1, "rid": 1}),
             jproto.Msg(jproto.MsgType.PULL, key="v1", sender=9,
                        meta={"since": 1, "need_base": 0, "rid": 2,
                              "since_layers": {"0000/w0": 2}}),
             jproto.Msg(jproto.MsgType.PUSH, key="nope/x", sender=9,
                        meta={"base": 0, "round": 1, "rid": 3},
                        array=np.zeros(4, np.float32))]
    got = {}
    for pkg in PKGS:
        srv = _server(pkg)
        cli = PKGS[pkg][0].RegistryClient(srv.addr, sender=0,
                                          timeout_s=10.0)
        try:
            cli.publish("v1", params)
            for r, layers in enumerate(rounds, 1):
                cli.push_delta("v1", r, layers)
            got[pkg] = []
            for m in pulls:
                data = m.encode()
                got[pkg].append(_raw_exchange(
                    srv.addr, struct.pack("<I", len(data)) + data))
        finally:
            cli.close()
            _stop(srv)
    assert [len(x) for x in got["port"]] == [len(x) for x in got["jax"]]
    assert [len(x) for x in got["jax"]] == [3 + 6 + 1, 2 + 1, 1]
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("srv_pkg,cli_pkg", [("jax", "port"),
                                             ("port", "jax")])
def test_train_while_serving_across_packages(srv_pkg, cli_pkg):
    """One package's trainer and replica against the other's server:
    rounds of deltas land bit-exact on the replica."""
    rng = np.random.default_rng(8)
    srv = _server(srv_pkg)
    reg_mod, rep_mod = PKGS[cli_pkg][0], PKGS[cli_pkg][1]
    trainer = reg_mod.RegistryClient(srv.addr, sender=0, timeout_s=10.0)
    rcli = reg_mod.RegistryClient(srv.addr, sender=1, timeout_s=10.0)
    try:
        params = {"0000/w": rng.normal(size=(6, 3)).astype(np.float32),
                  "0001/b": rng.normal(size=(3,)).astype(np.float32)}
        trainer.publish("v1", params)
        dense = {k: v.copy() for k, v in params.items()}
        rep = rep_mod.ServingReplica("v1", party=1)
        rep.sync(rcli)
        for r in range(1, 4):
            layers = {}
            for k, v in dense.items():
                idx = rng.choice(v.size, 2, replace=False).astype(np.int64)
                vals = rng.normal(size=2).astype(np.float32)
                layers[k] = (vals, idx)
                np.add.at(v.reshape(-1), idx, vals)
            assert trainer.push_delta("v1", r, layers)[
                "applied_layers"] == 2
            assert rep.sync(rcli)["applied"] == 2
            for k in dense:
                assert np.array_equal(rep.params()[k], dense[k]), (r, k)
    finally:
        trainer.close()
        rcli.close()
        _stop(srv)


def test_registry_frames_book_the_round_ledger():
    """Base and delta PUSH frames carry meta round + wire_declared, so
    the round ledger books every registry byte by (key, round), declared
    never above actual."""
    from geomx_tpu_torch.telemetry.ledger import (get_round_ledger,
                                                  reset_round_ledger)
    reset_round_ledger()
    rng = np.random.default_rng(23)
    srv = _server("port")
    cli = treg.RegistryClient(srv.addr, sender=0, timeout_s=10.0)
    try:
        params = {"0000/w": rng.normal(size=(64,)).astype(np.float32)}
        cli.publish("v1", params)
        idx = np.array([1, 5, 9], np.int64)
        cli.push_delta("v1", 1, {"0000/w": (np.ones(3, np.float32), idx)})
        recs = {(r["key"], int(r["round"])): r
                for r in get_round_ledger().records()
                if str(r.get("key", "")).startswith("v1/")}
        assert set(recs) == {("v1/0000/w", 0), ("v1/0000/w", 1)}
        base, delta = recs[("v1/0000/w", 0)], recs[("v1/0000/w", 1)]
        assert base["wire"]["push_rx_bytes"] > 64 * 4
        got = delta["wire"]["push_rx_bytes"]
        assert 0 < int(delta["declared_rx_bytes"]) <= got < 64 * 4
    finally:
        cli.close()
        _stop(srv)
        reset_round_ledger()


# --------------------------------------------------------------------------
# replica
# --------------------------------------------------------------------------

def test_replica_dedups_replayed_frames():
    rng = np.random.default_rng(6)
    rep = trep.ServingReplica("v1")
    base = rng.normal(size=(10,)).astype(np.float32)
    rep.install_base("0000/w", base, order=0)
    vals = rng.normal(size=3).astype(np.float32)
    idx = np.array([1, 4, 7], np.int64)
    assert rep.apply_delta("0000/w", 1, vals, idx)
    once = rep.params()["0000/w"].copy()
    assert rep.apply_delta("0000/w", 1, vals, idx) is False
    assert np.array_equal(rep.params()["0000/w"], once)
    assert rep.replays_deduped == 1
    expect = base.copy()
    np.add.at(expect, idx, vals)
    assert np.array_equal(once, expect)


def test_replica_staleness_tracking():
    rep = trep.ServingReplica("v1")
    assert rep.staleness_s() == float("inf")
    assert rep.snapshot()["staleness_s"] is None
    rep.install_base("0000/w", np.zeros(4, np.float32), order=0)
    assert rep.staleness_s(rep._refresh_mono + 2.5) == pytest.approx(2.5)
    assert rep.snapshot()["staleness_s"] is not None


def test_replica_o1_fast_path_bit_exact_and_counted():
    """The ping-pong O(k) refresh: bit-exact against np.add.at while a
    reader holds an old snapshot, with the same o1/dense counts as the
    JAX replica on the same sequence."""
    snaps = {}
    for pkg, (_reg, rep_mod, *_r) in PKGS.items():
        rng = np.random.default_rng(11)
        rep = rep_mod.ServingReplica("v1")
        base = rng.normal(size=(64,)).astype(np.float32)
        rep.install_base("0000/w", base, order=0)
        dense = base.copy()
        held = rep.params()
        held_copy = {k: v.copy() for k, v in held.items()}
        for r in range(1, 21):
            idx = rng.choice(64, size=7, replace=False).astype(np.int64)
            vals = rng.normal(size=7).astype(np.float32)
            assert rep.apply_delta("0000/w", r, vals, idx)
            np.add.at(dense, idx, vals)
            assert np.array_equal(rep.params()["0000/w"], dense), (pkg, r)
        assert np.array_equal(held["0000/w"], held_copy["0000/w"])
        snap = rep.snapshot()
        assert snap["o1_applies"] > 0
        assert snap["o1_applies"] + snap["dense_copies"] == 20
        snaps[pkg] = (snap["o1_applies"], snap["dense_copies"],
                      rep.params()["0000/w"].tobytes())
    assert snaps["port"] == snaps["jax"]


def test_replica_held_snapshot_is_never_written():
    rng = np.random.default_rng(16)
    rep = trep.ServingReplica("v1")
    rep.install_base("0000/w", rng.normal(size=(32,)).astype(np.float32),
                     order=0)
    held = rep.params()
    copy = held["0000/w"].copy()
    for r in range(1, 9):
        idx = rng.choice(32, size=4, replace=False).astype(np.int64)
        rep.apply_delta("0000/w", r, np.ones(4, np.float32), idx)
    assert np.array_equal(held["0000/w"], copy)
    assert rep.snapshot()["dense_copies"] >= 1


def test_scatter_goes_through_the_native_runtime(monkeypatch):
    """The replica's in-place scatter calls the port's ctypes binding
    (``runtime.native.scatter_pairs``) and falls back to the numpy fold
    only when the library is missing."""
    import geomx_tpu_torch.runtime.native as native
    calls = []
    real = native.scatter_pairs

    def spy(flat, vals, idx):
        calls.append(int(vals.size))
        return real(flat, vals, idx)

    monkeypatch.setattr(native, "scatter_pairs", spy)
    flat = np.zeros(8, np.float32)
    trep._scatter_inplace(flat, np.float32([1, 2]),
                          np.array([3, 3], np.int64))
    assert calls == [2] and flat[3] == 3.0
    monkeypatch.setattr(native, "scatter_pairs", lambda *a: None)
    trep._scatter_inplace(flat, np.float32([1]), np.array([0], np.int64))
    assert flat[0] == 1.0


# --------------------------------------------------------------------------
# the native INFER lane
# --------------------------------------------------------------------------

def _matmul_gateway(max_batch=8, queue_ms=2.0, dim=6, out_dim=3, seed=7):
    rng = np.random.default_rng(seed)
    rep = trep.ServingReplica("v1")
    W = rng.normal(size=(dim, out_dim)).astype(np.float32)
    rep.install_base("0000/w", W, order=0)
    gw = InferenceGateway(rep, treedef=None, max_batch=max_batch,
                          queue_ms=queue_ms, device="cpu",
                          apply_fn=lambda named, xb: xb @ named["0000/w"])
    return gw, rep, W


def test_infer_client_frames_byte_identical():
    """The INFER frames both packages' clients send for the same rows."""
    xs = [np.arange(12, dtype=np.float32).reshape(2, 6) / 7.0,
          np.ones(6, np.float32)]
    frames = {}
    for pkg in PKGS:
        peer = _RecordingPeer()
        cli = PKGS[pkg][3].NativeInferenceClient(peer.addr, timeout_s=10.0)
        try:
            for x in xs:
                cli.infer(x)
        finally:
            cli.close()
            peer.close()
        frames[pkg] = peer.frames
    assert len(frames["port"]) == 2
    assert frames["port"] == frames["jax"]


def test_infer_reply_frames_byte_identical():
    """INFER_REPLY with the additive provenance meta, and the error
    replies, encode to the same bytes in both packages."""
    out = np.arange(6, dtype=np.float32).reshape(2, 3)
    metas = [({"rid": 4, "version": "v1", "round": 7,
               "batch_sizes": [2, 2], "staleness_s": 0.25,
               "layer_rounds": {"0000/w": 7, "0001/b": 6},
               "wire_declared": int(out.nbytes)}, out),
             ({"rid": 5, "error": "shed", "shed": 2}, None),
             ({"rid": 6, "error": "timeout"}, None)]
    for meta, arr in metas:
        enc = {pkg: PKGS[pkg][2].Msg(
            PKGS[pkg][2].MsgType.INFER_REPLY, key="infer" if arr is not
            None else "", sender=-1, meta=dict(meta), array=arr).encode()
            for pkg in PKGS}
        assert enc["port"] == enc["jax"], meta


@pytest.mark.parametrize("cli_pkg", ["port", "jax"])
def test_native_wire_roundtrip_and_ledger_accounting(cli_pkg):
    """The native lane end to end on one persistent connection (a JAX
    client against the port server too): outputs, provenance, and the
    request ledger's byte-true lanes.  The reply's tx bytes are booked
    after the frame is sent (as in the JAX package), so the test waits,
    with a deadline, for the ledger to show both frames of the second
    exchange before it asserts the exact counts."""
    reset_request_ledger()
    gw, rep, W = _matmul_gateway(max_batch=8, dim=784)
    gw.start()
    srv = twire.NativeInferenceServer(gw, port=0).start()
    cli = PKGS[cli_pkg][3].NativeInferenceClient(("127.0.0.1", srv.port),
                                                 timeout_s=20.0)
    try:
        x = np.arange(2 * 784, dtype=np.float32).reshape(2, 784) / 784.0
        out = cli.infer(x)
        assert "error" not in out, out
        np.testing.assert_allclose(out["outputs"], x @ W, rtol=1e-4)
        assert out["version"] == "v1" and len(out["batch_sizes"]) == 2
        assert out["layer_rounds"] == {"0000/w": 0}
        out2 = cli.infer(np.ones((1, 784), np.float32))
        np.testing.assert_allclose(
            out2["outputs"], np.ones((1, 784), np.float32) @ W, rtol=1e-4)

        def booked():
            s = get_request_ledger().summary()
            return (s["by_transport"].get("native", 0) == 3
                    and s["wire"].get("native", {}).get("frames") == 4)

        _wait_for(booked, what="the ledger to book both exchanges")
        s = get_request_ledger().summary()
        lane = s["wire"]["native"]
        assert lane["rx_declared_actual"] >= lane["rx_declared"] > 0
        assert 1.0 <= lane["honesty_ratio_rx"] <= 1.02
        assert srv.frames_served == 2
    finally:
        cli.close()
        srv.stop()
        srv.join(5.0)
        gw.stop()
        reset_request_ledger()


def test_native_wire_shed_is_explicit_reply_not_torn_socket():
    gw, rep, W = _matmul_gateway(max_batch=4)
    gw.start()
    srv = twire.NativeInferenceServer(gw, port=0).start()
    cli = twire.NativeInferenceClient(("127.0.0.1", srv.port),
                                      timeout_s=20.0)
    try:
        gw.set_shed_fraction(1.0)
        out = cli.infer(np.ones((2, 6), np.float32))
        assert out.get("error") == "shed" and out.get("shed") == 2
        gw.set_shed_fraction(0.0)
        assert "outputs" in cli.infer(np.ones((1, 6), np.float32))
    finally:
        cli.close()
        srv.stop()
        srv.join(5.0)
        gw.stop()


def test_native_wire_bad_batch_and_unhandled_frame():
    """A malformed batch answers an INFER_REPLY error; a non-INFER frame
    an ERROR frame — the connection keeps serving."""
    gw, rep, W = _matmul_gateway(max_batch=4)
    gw.start()
    srv = twire.NativeInferenceServer(gw, port=0).start()
    try:
        bad = tproto.Msg(tproto.MsgType.INFER, key="infer", sender=0,
                         meta={"rid": 1},
                         array=np.zeros((0, 6), np.float32)).encode()
        other = tproto.Msg(tproto.MsgType.PULL, key="x", sender=0,
                           meta={"rid": 2}).encode()
        good = tproto.Msg(tproto.MsgType.INFER, key="infer", sender=0,
                          meta={"rid": 3},
                          array=np.ones((1, 6), np.float32)).encode()
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=10.0) as s:
            replies = []
            for data in (bad, other, good):
                s.sendall(struct.pack("<I", len(data)) + data)
                got = tproto.recv_frame(s)
                replies.append(got)
        assert replies[0].type == tproto.MsgType.INFER_REPLY
        assert "bad request" in replies[0].meta["error"]
        assert replies[1].type == tproto.MsgType.ERROR
        np.testing.assert_allclose(replies[2].array,
                                   np.ones((1, 6), np.float32) @ W,
                                   rtol=1e-5)
    finally:
        srv.stop()
        srv.join(5.0)
        gw.stop()


@pytest.mark.parametrize("value,started", [("1", True), ("0", False)])
def test_serve_native_honors_the_knob(monkeypatch, value, started):
    monkeypatch.setenv("GEOMX_SERVE_NATIVE_WIRE", value)
    gw, rep, W = _matmul_gateway()
    srv = twire.serve_native(gw, port=0)
    try:
        assert (srv is not None) is started
    finally:
        if srv is not None:
            srv.stop()
            srv.join(5.0)
