"""Port parity: the inference gateway and the serving plane's hooks
(geomx_tpu_torch/serve/gateway.py, the scheduler's serving surface, the
request ledger's call sites, FleetScope's serve nodes, SloPolicy on a
gateway) against the JAX package's (geomx_tpu/serve/gateway.py and the
cases of tests/test_serve.py and tests/test_fleetscope.py).

Gateway parity: the MLP and a small SeqClassifier (2 layers, L 64) are
initialized by flax, their weights carried across by
``models/convert.from_flax`` (and published to both packages' replicas
under the same names), and the same seeded requests go through the JAX
gateway and the port's on the CPU: the answers agree within fp32 1e-5.
On the CPU the port's forward runs eagerly; the captured CUDA graphs
and kernel 10 inside them run on the card (``chip_smoke.py``'s
``serve_seq_flash``).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from geomx_tpu_torch.control.policy import GraftPilot, SloPolicy
from geomx_tpu_torch.control.sensors import ControlObservation
from geomx_tpu_torch.serve import (register_serving_surface,
                                   reset_serving_surface, serving_surface)
from geomx_tpu_torch.serve.gateway import (InferenceGateway,
                                           default_buckets,
                                           flatten_params,
                                           unflatten_params)
from geomx_tpu_torch.serve.registry import RegistryClient, RegistryServer
from geomx_tpu_torch.serve.replica import ServingReplica
from geomx_tpu_torch.telemetry.ledger import (REQUEST_PHASES,
                                              RequestLedger,
                                              get_request_ledger,
                                              reset_request_ledger)

torch.set_num_threads(2)


def _wait_for(cond, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _matmul_gateway(max_batch=8, queue_ms=2.0, dim=6, out_dim=3, seed=7,
                    **kw):
    rng = np.random.default_rng(seed)
    rep = ServingReplica("v1")
    W = rng.normal(size=(dim, out_dim)).astype(np.float32)
    rep.install_base("0000/w", W, order=0)
    gw = InferenceGateway(rep, treedef=None, max_batch=max_batch,
                          queue_ms=queue_ms, device="cpu",
                          apply_fn=lambda named, xb: xb @ named["0000/w"],
                          **kw)
    return gw, rep, W


# --------------------------------------------------------------------------
# gateway: continuous batching
# --------------------------------------------------------------------------

def test_gateway_padding_buckets_and_cache_bounded():
    gw, rep, W = _matmul_gateway(max_batch=8)
    assert gw.buckets == default_buckets(8) == (1, 2, 4, 8)
    assert [gw.bucket_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    gw.start()
    try:
        for n in (1, 2, 3, 4, 5, 7, 8):
            reqs = [gw.submit(np.full(6, i + 1, np.float32))
                    for i in range(n)]
            for r in reqs:
                assert r.event.wait(30), "request timed out"
                assert r.error is None, r.error
                assert r.batch_size <= 8 and r.bucket in gw.buckets
                assert r.bucket >= r.batch_size
                np.testing.assert_allclose(
                    np.asarray(r.result),
                    np.full(6, 1, np.float32) * (r.x[0]) @ W, rtol=1e-5)
        assert gw.jit_cache_size() <= len(gw.buckets)
    finally:
        gw.stop()


def test_gateway_coalesces_up_to_max_batch():
    gw, rep, W = _matmul_gateway(max_batch=4, queue_ms=25.0)
    gw.start()
    try:
        reqs = [gw.submit(np.ones(6, np.float32)) for _ in range(4)]
        for r in reqs:
            assert r.event.wait(30) and r.error is None
        assert max(r.batch_size for r in reqs) > 1
        assert gw.batches_dispatched < len(reqs)
        assert max(r.batch_size for r in reqs) <= 4
    finally:
        gw.stop()


def test_gateway_shed_is_explicit_not_lost():
    reset_request_ledger()
    gw, rep, W = _matmul_gateway()
    gw.start()
    try:
        gw.set_shed_fraction(1.0)
        r = gw.submit(np.ones(6, np.float32))
        assert r.event.wait(10) and r.error == "shed"
        gw.set_shed_fraction(0.0)
        r2 = gw.submit(np.ones(6, np.float32))
        assert r2.event.wait(10) and r2.error is None
        assert gw.requests_shed == 1
        assert get_request_ledger().summary()["by_status"] == {
            "ok": 1, "shed": 1}
    finally:
        gw.stop()
        reset_request_ledger()


def test_unflatten_params_handles_five_digit_leaf_indices():
    """10000+ leaves: names order by their integer prefix, a gap is
    refused — and the names are the JAX package's for the same tree."""
    from geomx_tpu.serve.gateway import flatten_params as jflatten
    tree = [np.float32([i]) for i in range(10001)]
    named, treedef = flatten_params(tree)
    assert list(named) == list(jflatten(tree)[0])
    assert sorted(named) != list(named)
    rebuilt = unflatten_params(treedef, named)
    assert all(np.array_equal(a, b) for a, b in zip(rebuilt, tree))
    broken = dict(named)
    broken.pop(next(iter(broken)))
    with pytest.raises(ValueError, match="contiguous"):
        unflatten_params(treedef, broken)


def test_flatten_names_match_flax_variables():
    """A port zoo model flattens to the names (and leaf order) flax
    variables of the same model flatten to in the JAX package."""
    import jax

    from geomx_tpu.models import get_model as jget
    from geomx_tpu.serve.gateway import flatten_params as jflatten
    from geomx_tpu_torch.models import get_model
    for name, x in (("mlp", np.zeros((1, 784), np.float32)),
                    ("resnet20", np.zeros((1, 32, 32, 3), np.float32))):
        variables = jax.eval_shape(
            lambda: jget(name).init(jax.random.PRNGKey(0), x))
        jnames = list(jflatten(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), variables))[0])
        m = get_model(name)
        if not getattr(m, "built", True):
            m.build(x.shape[1:])
        assert list(flatten_params(m)[0]) == jnames, name


def test_timed_out_request_never_counted_ok():
    """A request that ages out in the queue answers 500/"timeout" and
    the worker later skips it (stop() joins the worker, which drains the
    queue, so no sleep is needed to wait for it)."""
    reset_request_ledger()
    rng = np.random.default_rng(14)
    rep = ServingReplica("v1")
    rep.install_base("0000/w", rng.normal(size=(6, 3)).astype(np.float32),
                     order=0)
    gw = InferenceGateway(rep, treedef=None, max_batch=4, queue_ms=1.0,
                          apply_fn=lambda named, xb: xb @ named["0000/w"],
                          request_timeout_s=0.05, device="cpu")
    status, body, _ = gw.infer_route(
        json.dumps({"inputs": [[1, 0, 0, 0, 0, 0]]}).encode())
    assert status == 500 and b"timeout" in body
    assert gw.requests_timeout == 1
    gw.start()
    _wait_for(lambda: gw._queue.qsize() == 0, what="the queue to drain")
    gw.stop()
    assert gw.requests_ok == 0
    assert gw.batches_dispatched == 0
    assert gw.surface_snapshot()["requests"]["timeout"] == 1
    reset_request_ledger()


def test_gateway_stop_drains_queue():
    gw, rep, W = _matmul_gateway(max_batch=2, queue_ms=50.0)
    gw.start()
    reqs = [gw.submit(np.ones(6, np.float32)) for _ in range(6)]
    gw.stop()
    for r in reqs:
        assert r.event.wait(10), "stranded request"
        assert r.error is None or r.error in ("shutdown", "shed")


def test_gateway_prewarm_compiles_before_first_request():
    gw, rep, W = _matmul_gateway(max_batch=8, warmup_shapes=[(6,)],
                                 warmup=True)
    gw.start()
    try:
        assert gw.warmup_compiles == len(gw.buckets) == 4
        assert gw.jit_cache_size() == gw.warmup_compiles
        for n in (1, 3, 5, 8):
            reqs = [gw.submit(np.full(6, i + 1, np.float32))
                    for i in range(n)]
            for r in reqs:
                assert r.event.wait(30) and r.error is None
        assert gw.jit_cache_size() == gw.warmup_compiles
        assert gw.surface_snapshot()["warmup_compiles"] == 4
    finally:
        gw.stop()


def test_gateway_concurrent_load_zero_lost_exact_shed():
    rng = np.random.default_rng(3)
    rep = ServingReplica("v1")
    rep.install_base("0000/w", rng.normal(size=(6, 3)).astype(np.float32),
                     order=0)
    gw = InferenceGateway(
        rep, treedef=None, max_batch=4, queue_ms=1.0, queue_cap=8,
        apply_fn=lambda named, xb: xb @ named["0000/w"], device="cpu")
    gw.start()
    results = []
    lock = threading.Lock()

    def loadgen(wid):
        r = np.random.default_rng(100 + wid)
        got = []
        for _ in range(40):
            req = gw.submit(r.normal(size=6).astype(np.float32))
            assert req.event.wait(30), "request never resolved"
            got.append(req.error or "ok")
        with lock:
            results.extend(got)

    threads = [threading.Thread(target=loadgen, args=(w,))
               for w in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        gw.stop()
    assert len(results) == 8 * 40
    counts = {k: results.count(k) for k in set(results)}
    assert set(counts) <= {"ok", "shed", "timeout"}, counts
    assert counts.get("ok", 0) == gw.requests_ok
    assert counts.get("shed", 0) == gw.requests_shed
    assert counts.get("timeout", 0) == gw.requests_timeout
    assert gw.requests_error == 0
    assert (gw.requests_ok + gw.requests_shed + gw.requests_timeout
            == 8 * 40)


def test_gateway_refuses_the_card_without_one():
    """An entry point runs on the card unless the caller asks for the
    CPU: without a card and without ``device="cpu"`` it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceGateway(ServingReplica("v1"), treedef=None,
                         apply_fn=lambda n, x: x)


def test_gateway_weight_copy_only_on_a_new_weight_set():
    """The static weights are copied when the replica's dict changes
    (a delta or a base), never per batch."""
    gw, rep, W = _matmul_gateway(max_batch=2, queue_ms=0.0)
    gw.start()
    try:
        for _ in range(3):
            r = gw.submit(np.ones(6, np.float32))
            assert r.event.wait(10) and r.error is None
        assert gw.weight_loads == 1
        rep.apply_delta("0000/w", 1, np.float32([2.0]),
                        np.array([0], np.int64))
        r = gw.submit(np.ones(6, np.float32))
        assert r.event.wait(10) and r.error is None
        assert gw.weight_loads == 2 and r.model_round == 1
        np.testing.assert_allclose(r.result, np.ones(6, np.float32)
                                   @ rep.params()["0000/w"], rtol=1e-6)
    finally:
        gw.stop()


# --------------------------------------------------------------------------
# gateway parity with the JAX gateway (flax weights, the same requests)
# --------------------------------------------------------------------------

def _serve_both(jgw, tgw, xs):
    jgw.start()
    tgw.start()
    try:
        out = {}
        for name, gw in (("jax", jgw), ("port", tgw)):
            reqs = [gw.submit(x) for x in xs]
            for r in reqs:
                assert r.event.wait(60) and r.error is None, r.error
            out[name] = np.stack([np.asarray(r.result) for r in reqs])
        return out
    finally:
        jgw.stop()
        tgw.stop()


def _replicas(named):
    from geomx_tpu.serve.replica import ServingReplica as JRep
    out = []
    for cls in (JRep, ServingReplica):
        rep = cls("v1")
        for i, (k, v) in enumerate(named.items()):
            rep.install_base(k, v, order=i)
        out.append(rep)
    return out


def test_mlp_gateway_matches_jax_gateway():
    """Flax-initialized MLP weights published under the JAX names serve
    the same logits through both gateways (fp32 1e-5)."""
    import jax

    from geomx_tpu.models import get_model as jget
    from geomx_tpu.serve.gateway import InferenceGateway as JGateway
    from geomx_tpu.serve.gateway import flatten_params as jflatten
    variables = jget("mlp").init(jax.random.PRNGKey(0),
                                 np.zeros((1, 784), np.float32))
    named, jtree = jflatten(variables)
    jrep, trep = _replicas(named)
    jgw = JGateway(jrep, treedef=jtree, model_name="mlp", max_batch=4,
                   queue_ms=1.0, warmup_shapes=[(784,)], warmup=True)
    tgw = InferenceGateway(trep, treedef=None, model_name="mlp",
                           max_batch=4, queue_ms=1.0,
                           warmup_shapes=[(784,)], warmup=True,
                           device="cpu")
    xs = list(np.random.default_rng(31).normal(size=(7, 784))
              .astype(np.float32))
    out = _serve_both(jgw, tgw, xs)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5,
                               atol=1e-5)
    assert tgw.jit_cache_size() == jgw.jit_cache_size() == 3
    # the port's module holds exactly the flax weights from_flax carries
    from geomx_tpu_torch.models.convert import from_flax
    params, _ = from_flax(jax.device_get(variables["params"]))
    owned = dict(tgw.model().named_parameters())
    for k, v in params.items():
        assert torch.equal(owned[k], v), k


SEQ = dict(vocab=64, max_len=64, dim=32, num_heads=4, num_layers=2,
           num_classes=4)


def test_seq_classifier_gateway_matches_jax_gateway():
    """A small SeqClassifier (2 layers, L 64): token rows cross as fp32
    (as the wires carry them) and the port's gateway casts them to
    int32 for the embedding; the JAX gateway's injected forward does the
    same.  Both gateways answer within fp32 1e-5, across a mid-run
    delta too."""
    import jax
    import jax.numpy as jnp

    from geomx_tpu.models.seq_classifier import SeqClassifier as FlaxSeq
    from geomx_tpu.serve.gateway import InferenceGateway as JGateway
    from geomx_tpu.serve.gateway import flatten_params as jflatten
    from geomx_tpu.serve.gateway import unflatten_params as junflatten
    from geomx_tpu_torch.models import SeqClassifier
    fm = FlaxSeq(**SEQ)
    variables = jax.jit(lambda r: fm.init(
        r, jnp.zeros((1, 64), jnp.int32)))(jax.random.PRNGKey(3))
    named, jtree = jflatten(variables)
    jrep, trep = _replicas(named)

    def japply(nm, xb):
        return fm.apply(junflatten(jtree, nm), xb.astype(jnp.int32))

    jgw = JGateway(jrep, treedef=jtree, apply_fn=japply, max_batch=4,
                   queue_ms=1.0, warmup=False)
    tgw = InferenceGateway(trep, treedef=None, model=SeqClassifier(**SEQ),
                           max_batch=4, queue_ms=1.0, warmup=False,
                           device="cpu")
    rng = np.random.default_rng(32)
    xs = list(rng.integers(0, 64, size=(6, 64)).astype(np.float32))
    out = _serve_both(jgw, tgw, xs)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5,
                               atol=1e-5)
    # a delta on one attention kernel lands in both replicas
    k = next(n for n in named if "qkv" in n)
    idx = rng.choice(named[k].size, 64, replace=False).astype(np.int64)
    vals = rng.normal(0, 0.2, size=64).astype(np.float32)
    for rep in (jrep, trep):
        assert rep.apply_delta(k, 1, vals, idx)
    out2 = _serve_both(jgw, tgw, xs)
    np.testing.assert_allclose(out2["port"], out2["jax"], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(out2["port"] - out["port"]).max() > 1e-4


def test_train_while_serving_delta_refresh_bit_exact(tmp_path):
    rng = np.random.default_rng(8)
    srv = RegistryServer(durable_dir=str(tmp_path)).start()
    trainer = RegistryClient(srv.addr, sender=0, timeout_s=10.0)
    replica_cli = RegistryClient(srv.addr, sender=1, timeout_s=10.0)
    params = {"0000/w": rng.normal(size=(6, 3)).astype(np.float32),
              "0001/b": rng.normal(size=(3,)).astype(np.float32)}
    trainer.publish("v1", params)
    dense = {k: v.copy() for k, v in params.items()}
    rep = ServingReplica("v1", party=1)
    rep.sync(replica_cli)
    gw = InferenceGateway(
        rep, treedef=None, max_batch=4, queue_ms=2.0, device="cpu",
        apply_fn=lambda named, xb: xb @ named["0000/w"] + named["0001/b"])
    gw.start()
    try:
        for r in range(1, 4):
            layers = {}
            for k, v in dense.items():
                idx = rng.choice(v.size, 2, replace=False).astype(np.int64)
                vals = rng.normal(size=2).astype(np.float32)
                layers[k] = (vals, idx)
                np.add.at(v.reshape(-1), idx, vals)
            assert trainer.push_delta("v1", r, layers)[
                "applied_layers"] == len(layers)
            assert rep.sync(replica_cli)["applied"] == len(layers)
            for k in dense:
                assert np.array_equal(rep.params()[k], dense[k]), (r, k)
            x = np.ones(6, np.float32)
            req = gw.submit(x)
            assert req.event.wait(30) and req.error is None
            assert req.model_round == r
            np.testing.assert_allclose(
                np.asarray(req.result),
                x @ dense["0000/w"] + dense["0001/b"], rtol=1e-5)
    finally:
        gw.stop()
        trainer.close()
        replica_cli.close()
        srv.stop()
        srv.join(5.0)


# --------------------------------------------------------------------------
# request ledger (the port's against the JAX package's)
# --------------------------------------------------------------------------

def _ledgers():
    from geomx_tpu.telemetry.ledger import RequestLedger as JLedger
    return {"jax": JLedger, "port": RequestLedger}


def test_request_ledger_phases_and_percentiles():
    sums = {}
    for pkg, cls in _ledgers().items():
        led = cls(capacity=64)
        for i in range(100):
            led.observe(rid=i, t_enqueue=1000.0 + i * 0.01,
                        queue_s=0.001 * (i + 1), forward_s=0.002,
                        reply_s=0.0005, batch_size=4, bucket=4)
        s = led.summary()
        assert s["observed_total"] == 100 and s["requests"] == 64
        for phase in REQUEST_PHASES + ("total",):
            assert s[f"{phase}_p50_s"] <= s[f"{phase}_p99_s"]
        assert 0.098 <= s["queue_p99_s"] <= 0.100
        assert s["batch_size_mean"] == pytest.approx(4.0)
        assert s["by_status"] == {"ok": 64}
        sums[pkg] = s
    assert json.dumps(sums["port"], sort_keys=True) == \
        json.dumps(sums["jax"], sort_keys=True)


def test_request_ledger_tracks_status():
    for cls in _ledgers().values():
        led = cls(capacity=16)
        led.observe(rid=1, t_enqueue=0.0, queue_s=0.1, forward_s=0.0,
                    reply_s=0.0, batch_size=0, bucket=0, status="shed")
        led.observe(rid=2, t_enqueue=0.1, queue_s=0.01, forward_s=0.01,
                    reply_s=0.001, batch_size=1, bucket=1)
        s = led.summary()
        assert s["by_status"] == {"ok": 1, "shed": 1}
        assert s["queue_p99_s"] == pytest.approx(0.01)


def test_request_ledger_wire_lanes_per_direction_honesty():
    lanes = {}
    for pkg, cls in _ledgers().items():
        led = cls(capacity=16)
        led.account_wire("native", "rx", 1010, declared=1000)
        led.account_wire("native", "tx", 200, declared=100)
        led.account_wire("native", "rx", 50)
        led.account_wire("http", "rx", 300)
        s = led.summary()
        lane = s["wire"]["native"]
        assert lane["rx_bytes"] == 1060 and lane["tx_bytes"] == 200
        assert lane["frames"] == 3
        assert lane["honesty_ratio_rx"] == pytest.approx(1.01)
        assert lane["honesty_ratio_tx"] == pytest.approx(2.0)
        assert s["wire"]["http"]["honesty_ratio_rx"] is None
        lanes[pkg] = s["wire"]
    assert lanes["port"] == lanes["jax"]


def _observe(led, rid, **kw):
    led.observe(rid, t_enqueue=float(rid), queue_s=0.001,
                forward_s=0.002, reply_s=0.0005, batch_size=1,
                bucket=1, **kw)


def test_request_ledger_provenance_fields_and_summary():
    docs = {}
    for pkg, cls in _ledgers().items():
        led = cls(capacity=8)
        _observe(led, 1, transport="http", model_version="v1",
                 model_round=7, staleness_s=0.5)
        _observe(led, 2, transport="native", model_version="v1",
                 model_round=9, staleness_s=0.1)
        _observe(led, 3)
        recs = led.records()
        assert recs[0]["model_round"] == 7
        assert "model_round" not in recs[2]
        fresh = led.summary()["freshness"]
        assert fresh == {"records": 2, "model_round_min": 7,
                         "model_round_max": 9,
                         "staleness_max_s": pytest.approx(0.5)}
        docs[pkg] = (recs, fresh)
    assert docs["port"] == docs["jax"]


def test_gateway_books_every_phase_status_and_transport():
    """The gateway's call sites: ok, shed and timeout requests each land
    with their transport and phases; provenance on the ok ones."""
    reset_request_ledger()
    gw, rep, W = _matmul_gateway(max_batch=2)
    gw.start()
    try:
        r = gw.submit(np.ones(6, np.float32), transport="native")
        assert r.event.wait(10) and r.error is None
        gw.set_shed_fraction(1.0)
        gw.submit(np.ones(6, np.float32), transport="http")
        gw.set_shed_fraction(0.0)
        status, _, _ = gw.infer_route(json.dumps(
            {"inputs": [[1, 0, 0, 0, 0, 0]]}).encode())
        assert status == 200
        s = get_request_ledger().summary()
        assert s["by_status"] == {"ok": 2, "shed": 1}
        assert s["by_transport"] == {"native": 1, "http": 2}
        assert s["wire"]["http"]["rx_bytes"] > 0
        assert s["wire"]["http"]["tx_bytes"] > 0
        ok = [x for x in get_request_ledger().records()
              if x["status"] == "ok"]
        assert all(x["model_version"] == "v1" and x["model_round"] == 0
                   for x in ok)
        assert all(x["forward_s"] >= 0.0 and x["queue_s"] >= 0.0
                   for x in ok)
    finally:
        gw.stop()
        reset_request_ledger()


# --------------------------------------------------------------------------
# SLO policy on a live gateway
# --------------------------------------------------------------------------

def _obs(step, links=None):
    return ControlObservation(step=step, links=links or {},
                              exposed_comms=0.0, hidden_comms=0.0,
                              compute_s=0.0, ef_residual_norm=0.0,
                              grad_norm=0.0, dc_dense_bytes=0)


def test_slo_policy_shed_hysteresis_and_bounds():
    from geomx_tpu.control.policy import SloPolicy as JSlo
    seqs = {}
    for cls in (JSlo, SloPolicy):
        stats = {"p99_s": 0.1}
        pol = cls(lambda: stats, target_p99_s=0.5, shed_step=0.4,
                  shed_max=0.6, confirm=2, cooldown=1)
        seq = []
        for s, p99 in enumerate([0.1, 3.0, 3.0, 3.0, 3.0, 0.3, 0.3, 0.3,
                                 0.3, 0.05, 0.05]):
            stats["p99_s"] = p99
            d = pol.decide(_obs(s))
            if d is not None:
                assert d.kind == "slo"
                seq.append((s, d.to_json()))
        seqs[cls.__module__.split(".")[0]] = seq
    port = seqs["geomx_tpu_torch"]
    assert [(s, tuple(d["value"])) for s, d in port] == [
        (2, ("shed", 0.4)), (4, ("shed", 0.6)),
        (10, ("shed", pytest.approx(0.2)))]
    assert json.dumps(port) == json.dumps(seqs["geomx_tpu"])


def test_slo_policy_routes_on_widest_confident_uplink():
    stats = {"p99_s": 0.1}
    pol = SloPolicy(lambda: stats, peer="global", min_confidence=0.5)
    links = {"0:g": {"party": 0, "peer": "global",
                     "throughput_bps": 1e6, "confidence": 0.9},
             "1:g": {"party": 1, "peer": "global",
                     "throughput_bps": 9e6, "confidence": 0.9}}
    d = pol.decide(_obs(1, links))
    assert d is not None and d.value[0] == "route"
    links["1:g"]["throughput_bps"] = 1e3
    d2 = None
    for s in range(2, 8):
        d2 = pol.decide(_obs(s, links))
        if d2 is not None:
            break
    assert d2 is not None and d2.value[0] == "route"
    assert d2.value != d.value


def test_pilot_accepts_slo_family():
    pilot = GraftPilot(sensors=None, slo=SloPolicy(lambda: {"p99_s": 0.0}))
    assert len(pilot.policies) == 1 and pilot.policies[0].knob == "slo"


class _Sensors:
    def observe(self, step, now=None):
        return _obs(step)


def test_slo_policy_sheds_a_live_gateway():
    """``SloPolicy(gw.serving_stats)`` in a GraftPilot: the gateway's
    request-ledger p99 over target makes a shed decision, which the
    caller hands to ``gw.set_shed_fraction``; the gateway then refuses
    that share of requests explicitly, and a recovered p99 releases."""
    reset_request_ledger()
    gw, rep, W = _matmul_gateway(max_batch=2)
    gw.start()
    try:
        # one slow request in the ledger puts p99 over a 0.2 s target
        led = get_request_ledger()
        led.observe(rid=10_000, t_enqueue=0.0, queue_s=0.5,
                    forward_s=0.5, reply_s=0.0, batch_size=1, bucket=1)
        pilot = GraftPilot(sensors=_Sensors(), slo=SloPolicy(
            gw.serving_stats, target_p99_s=0.2, shed_step=0.5,
            confirm=1, cooldown=1))
        decisions = pilot.tick(1)
        assert [d.kind for d in decisions] == ["slo"]
        kind, frac = decisions[0].value
        assert kind == "shed" and frac == pytest.approx(0.5)
        gw.set_shed_fraction(frac)
        reqs = [gw.submit(np.ones(6, np.float32)) for _ in range(4)]
        for r in reqs:
            assert r.event.wait(10)
        assert sum(r.error == "shed" for r in reqs) == 2
        assert gw.serving_stats()["shed_fraction"] == pytest.approx(0.5)
        reset_request_ledger()
        r = gw.submit(np.ones(6, np.float32))
        gw.set_shed_fraction(0.0)
        assert r.event.wait(10)
        r = gw.submit(np.ones(6, np.float32))
        assert r.event.wait(10) and r.error is None
        d = pilot.tick(2)
        assert d and d[0].value == ("shed", 0.0)
    finally:
        gw.stop()
        reset_request_ledger()


# --------------------------------------------------------------------------
# surfaces: healthz + metrics + /infer + /ledger
# --------------------------------------------------------------------------

def test_serving_surface_registry_merges_providers():
    reset_serving_surface()
    assert serving_surface() is None
    register_serving_surface("a", lambda: {"x": 1})
    register_serving_surface("b", lambda: {"y": 2})
    register_serving_surface("c", lambda: 1 / 0)
    got = serving_surface()
    assert got["a"] == {"x": 1} and got["b"] == {"y": 2}
    assert "ZeroDivisionError" in got["c"]["error"]
    register_serving_surface("a", None)
    register_serving_surface("c", None)
    assert serving_surface() == {"b": {"y": 2}}
    reset_serving_surface()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def test_gateway_http_healthz_metrics_and_infer():
    reset_request_ledger()
    reset_serving_surface()
    gw, rep, W = _matmul_gateway(dim=4)
    gw.start()
    httpd = gw.serve_http(port=0)
    port = httpd.server_address[1]
    try:
        body = json.dumps({"inputs": [[1, 0, 0, 0], [0, 1, 0, 0]]}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/infer", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.loads(r.read())
        np.testing.assert_allclose(doc["outputs"][0], W[0], rtol=1e-6)
        np.testing.assert_allclose(doc["outputs"][1], W[1], rtol=1e-6)
        assert doc["version"] == "v1" and doc["layer_rounds"] == {
            "0000/w": 0}
        h = json.loads(_get(port, "/healthz"))
        srv = h["serving"]["gateway"]
        assert srv["replica"]["version"] == "v1"
        assert srv["replica"]["staleness_s"] is not None
        assert srv["queue_depth"] == 0 and srv["requests"]["ok"] >= 2
        text = _get(port, "/metrics").decode()
        for name in ("geomx_serve_requests_total", "geomx_serve_batch_size",
                     "geomx_serve_replica_staleness_seconds"):
            assert name in text, name
        led = json.loads(_get(port, "/ledger"))
        assert led["requests"]["summary"]["observed_total"] >= 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        gw.stop()
        reset_serving_surface()
        reset_request_ledger()


def test_infer_route_rejects_bad_payloads():
    gw, rep, W = _matmul_gateway()
    assert gw.infer_route(b"not json")[0] == 400
    assert gw.infer_route(json.dumps({"nope": 1}).encode())[0] == 400


def test_ledger_document_summary_and_bounded_modes():
    from geomx_tpu_torch.telemetry.export import ledger_document
    from geomx_tpu_torch.telemetry.ledger import reset_round_ledger
    reset_round_ledger()
    led = reset_request_ledger(capacity=8)
    try:
        for rid in (1, 2, 3):
            _observe(led, rid, model_round=rid)
        full = ledger_document()
        assert len(full["requests"]["records"]) == 3 and "records" in full
        brief = ledger_document(summary_only=True)
        assert "records" not in brief and "records" not in brief["requests"]
        assert brief["requests"]["summary"]["freshness"]["records"] == 3
        bounded = ledger_document(max_records=2)
        assert [r["rid"] for r in bounded["requests"]["records"]] == [2, 3]
    finally:
        reset_request_ledger()
        reset_round_ledger()


def test_ledger_http_route_query_modes():
    from geomx_tpu_torch.telemetry.export import start_http_exporter
    from geomx_tpu_torch.telemetry.ledger import reset_round_ledger
    reset_round_ledger()
    led = reset_request_ledger(capacity=8)
    for rid in (1, 2, 3):
        _observe(led, rid)
    srv = start_http_exporter("127.0.0.1", 0)
    port = srv.server_address[1]
    try:
        def get(path):
            return json.loads(_get(port, path).decode("utf-8"))

        assert len(get("/ledger")["requests"]["records"]) == 3
        assert "records" not in get("/ledger?summary=1")["requests"]
        assert len(get("/ledger?n=1")["requests"]["records"]) == 1
        assert len(get("/ledger?n=bogus")["requests"]["records"]) == 3
    finally:
        srv.shutdown()
        srv.server_close()
        reset_request_ledger()
        reset_round_ledger()


# --------------------------------------------------------------------------
# FleetScope's serve nodes: watermarks, propagation, roster, named death
# --------------------------------------------------------------------------

def test_replica_publishes_layer_round_watermarks():
    from geomx_tpu_torch.telemetry import reset_registry
    from geomx_tpu_torch.telemetry.fleetscope import (
        get_propagation_tracker, reset_propagation_tracker)
    reg = reset_registry()
    reset_propagation_tracker()
    try:
        rep = ServingReplica("v1")
        rep.install_base("w0", np.zeros(4, np.float32), 0)
        assert rep.apply_delta("w0", 3, np.array([1.5], np.float32),
                               np.array([0], np.int64))
        assert rep.layer_rounds() == {"w0": 3}
        assert rep.snapshot()["layer_rounds"] == {"w0": 3}
        fam = reg.get("geomx_serve_replica_round")
        vals = {lv[0]: child.value for lv, child in fam.children()}
        assert vals == {"w0": 3.0}
        (rec,) = get_propagation_tracker().rounds()
        assert rec["round"] == 3 and "apply" in rec
    finally:
        reset_registry()
        reset_propagation_tracker()


def test_propagation_hops_publish_apply_served():
    """A round's publish (registry), apply (replica) and served
    (gateway, per transport) hops land in the propagation join."""
    from geomx_tpu_torch.serve.registry import ModelRegistry
    from geomx_tpu_torch.telemetry.fleetscope import (
        get_propagation_tracker, reset_propagation_tracker)
    reset_propagation_tracker()
    gw = None
    try:
        reg = ModelRegistry()
        reg.publish("v1", {"0000/w": np.eye(6, 3, dtype=np.float32)})
        assert reg.apply_delta("v1", "0000/w", 4, np.float32([1.0]),
                               np.array([0], np.int64))
        rep = ServingReplica("v1")
        for i, (k, v) in enumerate(reg.materialize("v1").items()):
            rep.install_base(k, v, order=i)
        rep.apply_delta("0000/w", 4, np.float32([1.0]),
                        np.array([0], np.int64))
        gw = InferenceGateway(rep, treedef=None, max_batch=2,
                              device="cpu",
                              apply_fn=lambda n, x: x @ n["0000/w"]).start()
        r = gw.submit(np.ones(6, np.float32), transport="native")
        assert r.event.wait(10) and r.error is None
        _wait_for(lambda: any("served" in x or "served_by" in x
                              for x in get_propagation_tracker().rounds()),
                  what="the served hop")
        (rec,) = get_propagation_tracker().rounds()
        assert rec["round"] == 4
        assert {"publish", "apply"} <= set(rec)
        assert "native" in rec.get("served_by", {})
    finally:
        if gw is not None:
            gw.stop()
        reset_propagation_tracker()


def test_serve_registration_named_death_and_healthz_serving():
    """A gateway joins the port's scheduler as a ``serve`` node through
    ``register_with_scheduler``; the scheduler's /healthz carries the
    serving surface; a gateway that stops heartbeating dies by name."""
    from geomx_tpu_torch.service.scheduler import GeoScheduler
    reset_serving_surface()
    sched = GeoScheduler(port=0, heartbeat_timeout=0.6)
    sched.start()
    gw, rep, W = _matmul_gateway()
    gw.start()
    cli = None
    try:
        cli = gw.register_with_scheduler(("127.0.0.1", sched.port),
                                         http_port=8123,
                                         heartbeat_interval_s=0.1)
        snap = sched.health_snapshot()
        assert snap["roster"].get("serve") == 1
        assert snap["dead_nodes"] == []
        assert snap["serving"]["gateway"]["replica"]["version"] == "v1"
        assert 900 <= cli.node_id < 1000
        cli.close()     # the gateway's heartbeats stop
        _wait_for(lambda: sched.health_snapshot()["dead_nodes"],
                  what="the gateway's named death")
        dead = sched.health_snapshot()["dead_nodes"]
        assert dead[0]["role"] == "serve" and dead[0]["tag"] == "gateway"
        assert dead[0]["id"] == cli.node_id
    finally:
        if cli is not None:
            cli.close()
        gw.stop()
        sched.stop()
        reset_serving_surface()
    assert "serving" not in sched.health_snapshot()


# --------------------------------------------------------------------------
# the knobs are host-plane only
# --------------------------------------------------------------------------

SERVE_ENV = {"GEOMX_SERVE_PORT": "18080", "GEOMX_SERVE_MAX_BATCH": "64",
             "GEOMX_SERVE_QUEUE_MS": "9.0", "GEOMX_SERVE_STALENESS_S": "1.0",
             "GEOMX_SERVE_TIMEOUT_S": "5.0", "GEOMX_SERVE_WARMUP": "0",
             "GEOMX_SERVE_NATIVE_WIRE": "0"}


def test_serve_knobs_from_env_reach_the_gateway(monkeypatch):
    monkeypatch.setenv("GEOMX_SERVE_TIMEOUT_S", "12.5")
    monkeypatch.setenv("GEOMX_SERVE_WARMUP", "0")
    gw = InferenceGateway(ServingReplica("v1"), treedef=None,
                          apply_fn=lambda named, xb: xb, device="cpu",
                          warmup_shapes=[(4,)])
    assert gw.request_timeout_s == 12.5
    assert gw._warmup_enabled is False


def test_serve_knobs_keep_the_step_ops_identical(monkeypatch):
    """The port's form of the byte-identical-jaxpr pin: every
    GEOMX_SERVE_* knob set leaves a Trainer step's ATen op sequence
    unchanged."""
    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.analysis import record_program
    from geomx_tpu_torch.models import MLP
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    rng = np.random.RandomState(0)
    x = (rng.rand(8, 8, 8, 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, size=8).astype(np.int64)

    def ops():
        cfg = GeoConfig.from_env(num_parties=2, workers_per_party=1,
                                 compression="bsc,0.05,min_sparse_size=16",
                                 precision="fp32")
        tr = Trainer(MLP(num_classes=10, hidden=(32,)), HiPSTopology(2, 1),
                     sgd(0.1), config=cfg, device="cpu")
        st = tr.init_state(seed=0, sample_input=x[:2])
        return record_program(
            tr.train_step, st, torch.from_numpy(x).reshape(2, 1, 4, 8, 8, 3),
            torch.from_numpy(y).reshape(2, 1, 4)).ops(), cfg

    for var in SERVE_ENV:
        monkeypatch.delenv(var, raising=False)
    ops()       # the first step settles lazily built constants
    clean, cfg0 = ops()
    for var, value in SERVE_ENV.items():
        monkeypatch.setenv(var, value)
    serving, cfg1 = ops()
    assert cfg1.serve_max_batch == 64 and cfg0.serve_max_batch == 8
    assert serving == clean
