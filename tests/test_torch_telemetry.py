"""Port parity: the telemetry plane's training side and its read side
(geomx_tpu_torch/telemetry/) against the JAX package's
(geomx_tpu/telemetry/), on the same inputs made with numpy from a seed.

- export: the same registry contents render byte-identical Prometheus
  text, and each package parses the other's;
- tracing, attribution: the same Chrome-trace documents give equal
  merged timelines and equal phase fractions (exact: integer µs); a
  two-party in-process host-plane round in each package gives the same
  ``round_id`` groups;
- links: the same observations with explicit ``t`` give equal snapshots;
- flight: the same record sequence fires the same rules at the same
  steps, and the NaN case names the same party;
- probes: the JAX step and the port step from the same weights
  (``models/convert.py``) give probe dicts that agree — counts, flags
  and the wire accounting exactly, norms and fractions within rtol
  1e-5 — with every party live and with a dead party;
- the disabled path: with telemetry off the port step dispatches the
  same ATen op sequence as a build whose probe collector raises;
- the fit loop publishes the probes at its log boundaries, and the
  flight recorder names a poisoned party.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_train import FILTERS, STAGES

import geomx_tpu.telemetry as jtel
import geomx_tpu.telemetry.attribution as jattr
import geomx_tpu.telemetry.export as jexport
import geomx_tpu.telemetry.flight as jflight
import geomx_tpu.telemetry.links as jlinks
import geomx_tpu.telemetry.probes as jprobes
import geomx_tpu.telemetry.roofline as jroof
import geomx_tpu.telemetry.tracing as jtrace
import geomx_tpu_torch.telemetry as ttel
import geomx_tpu_torch.telemetry.attribution as tattr
import geomx_tpu_torch.telemetry.export as texport
import geomx_tpu_torch.telemetry.flight as tflight
import geomx_tpu_torch.telemetry.links as tlinks
import geomx_tpu_torch.telemetry.probes as tprobes
import geomx_tpu_torch.telemetry.roofline as troof
import geomx_tpu_torch.telemetry.tracing as ttrace
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.sync import FSA as JaxFSA
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.analysis import record_program
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as port_optim
from geomx_tpu_torch.sync import FSA
from geomx_tpu_torch.train import Trainer

BSC = "bsc,0.01,select=sampled"


@pytest.fixture()
def registries():
    regs = {"jax": jtel.reset_registry(), "port": ttel.reset_registry()}
    yield regs
    jtel.reset_registry()
    ttel.reset_registry()


# ---- export ----------------------------------------------------------------

def _fill(reg):
    """The same registry contents, written through a package's API."""
    c = reg.counter("t_rt_total", "with \"quotes\" and \\slashes", ("name",))
    c.labels(name='va"l\\ue\n2').inc(7)
    c.labels(name="plain").inc(2.5)
    reg.gauge("t_rt_gauge", "a gauge").set(-1.5)
    reg.gauge("t_rt_big", "big").set(3.0e15)
    reg.gauge("t_rt_nan", "nan").set(float("nan"))
    reg.gauge("t_rt_inf", "inf", ("side",)).labels(side="lo").set(
        float("-inf"))
    h = reg.histogram("t_rt_hist", "hist", ("op",), buckets=(1.0, 2.5))
    rng = np.random.RandomState(0)
    for v in rng.exponential(2.0, size=16):
        h.labels(op="push").observe(float(v))
    h.labels(op="pull").observe(0.5)


def test_prometheus_text_is_byte_identical_and_cross_parses():
    regs = {"jax": jtel.MetricRegistry(), "port": ttel.MetricRegistry()}
    for reg in regs.values():
        _fill(reg)
    text = {pkg: mod.render_prometheus(regs[pkg])
            for pkg, mod in (("jax", jexport), ("port", texport))}
    assert text["port"].encode() == text["jax"].encode()
    # each package parses the other's text to the same families
    a = texport.parse_prometheus_text(text["jax"])
    b = jexport.parse_prometheus_text(text["port"])
    assert json.dumps(a, sort_keys=True, default=repr) == \
        json.dumps(b, sort_keys=True, default=repr)
    assert a["t_rt_total"]["type"] == "counter"


@pytest.mark.parametrize("bad,match", [
    ("mystery_metric 1\n", "no TYPE"),
    ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\n'
     "h_sum 1\nh_count 3\n", "non-cumulative")])
def test_parser_rejects_like_jax(bad, match):
    for mod in (texport, jexport):
        with pytest.raises(ValueError, match=match):
            mod.parse_prometheus_text(bad)


def test_event_log_default_and_env(tmp_path, monkeypatch):
    """``log_event`` writes to the installed default log, else to
    ``GEOMX_TELEMETRY_EVENTS``, else nowhere — as in the JAX package."""
    monkeypatch.delenv("GEOMX_TELEMETRY_EVENTS", raising=False)
    texport.set_default_event_log(None)
    assert texport.get_event_log() is None
    texport.log_event("nothing")            # a no-op, no file
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("GEOMX_TELEMETRY_EVENTS", path)
    texport.log_event("via_env", x=1)
    assert texport.get_event_log().read()[-1]["kind"] == "via_env"
    log = texport.EventLog(str(tmp_path / "default.jsonl"))
    texport.set_default_event_log(log)
    try:
        texport.log_event("via_default", v=np.float32(2.5))
        assert log.read()[-1] == {**log.read()[-1], "kind": "via_default",
                                  "v": 2.5}
    finally:
        texport.set_default_event_log(None)


# ---- tracing and attribution ----------------------------------------------

def _party_doc(anchor_s, party, offset_us):
    """One party's Chrome trace: three steps of compute and comm spans
    with integer µs, the relay spans carrying (key, round_id)."""
    evs = []
    for i in range(3):
        t0 = offset_us + i * 10_000
        evs.append({"name": "train/step", "cat": "step", "ph": "X",
                    "ts": t0, "dur": 9_000, "pid": 0, "tid": 1,
                    "args": {"step": i}})
        evs.append({"name": "train/compute", "cat": "compute", "ph": "X",
                    "ts": t0, "dur": 5_000 + 500 * party, "pid": 0,
                    "tid": 1})
        evs.append({"name": "RelayToGlobal:w", "cat": "comm", "ph": "X",
                    "ts": t0 + 4_000, "dur": 3_000, "pid": 0, "tid": 2,
                    "args": {"key": "w", "round_id": i + 1,
                             "payload_bytes": 1 << 20}})
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "metadata": {"anchor_unix_us": anchor_s * 1e6, "rank": party}}


def test_merge_and_attribution_match_jax():
    docs = [_party_doc(1_000.0, 0, 0), _party_doc(1_000.25, 1, 3_000)]
    merged = {pkg: mod.merge_traces(docs, labels=["p0", "p1"])
              for pkg, mod in (("jax", jtrace), ("port", ttrace))}
    assert json.dumps(merged["port"], sort_keys=True) == \
        json.dumps(merged["jax"], sort_keys=True)
    rounds = {pkg: sorted((k, len(v)) for k, v in
                          mod.rounds_in_trace(merged[pkg]).items())
              for pkg, mod in (("jax", jtrace), ("port", ttrace))}
    assert rounds["port"] == rounds["jax"] == \
        [(("w", r), 2) for r in (1, 2, 3)]
    for doc in docs:
        a = tattr.attribute_trace(doc)
        assert a == jattr.attribute_trace(doc)
        assert a["num_steps"] == 3
    am = {pkg: mod.attribute_merged(docs, labels=["p0", "p1"])["parties"]
          for pkg, mod in (("jax", jattr), ("port", tattr))}
    assert am["port"] == am["jax"] and sorted(am["port"]) == ["p0", "p1"]
    reg = ttel.MetricRegistry()
    tattr.publish_attribution(am["port"]["p1"]["summary"], registry=reg)
    fam = reg.get("geomx_phase_fraction")
    assert sum(ch.value for _l, ch in fam.children()) == \
        pytest.approx(1.0)


def _host_round(pkg, tmp_path):
    """A two-party in-process host-plane run (a global server, two party
    servers, a worker each), profiled; the merged trace's round groups."""
    import geomx_tpu.service as jsvc
    import geomx_tpu_torch.service as tsvc
    S = {"jax": jsvc, "port": tsvc}[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    glob = S.GeoPSServer(num_workers=2, mode="sync", rank=0, **kw).start()
    locs = [S.GeoPSServer(num_workers=1, mode="sync", rank=r + 1,
                          global_addr=("127.0.0.1", glob.port),
                          **kw).start() for r in range(2)]
    for s in (glob, *locs):
        s.profiler.set_state(True)
    clients = [S.GeoPSClient(("127.0.0.1", s.port), sender_id=i)
               for i, s in enumerate(locs)]
    try:
        for c in clients:
            c.init("w", np.zeros(64, np.float32))
        for _rnd in range(3):
            for i, c in enumerate(clients):
                c.push("w", np.full(64, float(i + 1), np.float32))
            for c in clients:
                np.testing.assert_allclose(c.pull("w", timeout=60.0), 3.0)
        paths = [s.profiler.dump(str(tmp_path / f"{pkg}{s.rank}.json"))
                 for s in (glob, *locs)]
    finally:
        for c in clients:
            c.stop_server()
            c.close()
        glob.join(10)
        for s in locs:
            s.join(10)
    tr = {"jax": jtrace, "port": ttrace}[pkg]
    merged = tr.merge_traces(paths, labels=["global", "party0", "party1"])
    return {rk: sorted({e["name"].split(":")[0] for e in evs})
            for rk, evs in tr.rounds_in_trace(merged).items()
            if rk[0] == "w"}


def test_two_party_wan_rounds_share_round_id_like_jax(tmp_path):
    """Each package's host plane correlates the same rounds under the
    same ids, with the same span kinds in every round group."""
    got = {pkg: _host_round(pkg, tmp_path) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert sorted(r for _k, r in got["port"]) == [1, 2, 3]
    for names in got["port"].values():
        assert {"RelayToGlobal", "ServerMerge", "ServerPull",
                "ServerPush"} <= set(names)


# ---- links -------------------------------------------------------------------

def test_link_observatory_matches_jax():
    rng = np.random.RandomState(3)
    obs = {pkg: mod.LinkObservatory(alpha=0.35, stale_after_s=4.0)
           for pkg, mod in (("jax", jlinks), ("port", tlinks))}
    for i in range(24):
        t = float(i) * 0.5
        for p in range(3):
            ok = rng.rand() > 0.1
            sec = float(rng.uniform(0.01, 0.2))
            nb = float(rng.randint(1, 1 << 20))
            for o in obs.values():
                o.observe(f"party{p}", nbytes=nb, seconds=sec, ok=ok, t=t)
    for now in (3.0, 11.5, 30.0):
        a = obs["port"].snapshot(now=now)
        assert json.dumps(a, sort_keys=True) == \
            json.dumps(obs["jax"].snapshot(now=now), sort_keys=True)
    assert obs["port"].best_relay_order(now=11.5) == \
        obs["jax"].best_relay_order(now=11.5)
    doc = _party_doc(1_000.0, 0, 0)
    fresh = {pkg: mod.LinkObservatory() for pkg, mod in
             (("jax", jlinks), ("port", tlinks))}
    for o in fresh.values():
        assert o.ingest_trace(doc, party="party0") == 3
    assert fresh["port"].snapshot(now=1_000.1) == \
        fresh["jax"].snapshot(now=1_000.1)


# ---- flight ----------------------------------------------------------------

def _flight_sequence():
    rng = np.random.RandomState(5)
    recs = []
    for s in range(40):
        probes = {"grad_norm_global": float(rng.uniform(0.9, 1.1)),
                  "dc_nonzero_fraction": float(rng.uniform(0.009, 0.011)),
                  "party_grad_nonfinite": [0.0, 0.0, 0.0],
                  "grad_all_finite": 1.0}
        phases = {"exposed_comms": float(rng.uniform(0.05, 0.1))}
        if s == 12:
            probes["grad_norm_global"] = 40.0          # spike
        if s == 20:
            probes["dc_nonzero_fraction"] = 0.05       # density drift
        if s == 27:
            phases["exposed_comms"] = 0.6              # exposed jump
        if s == 33:
            probes["party_grad_nonfinite"] = [0.0, 1.0, 0.0]
            probes["grad_all_finite"] = 0.0
            probes["grad_norm_global"] = float("nan")
        recs.append((s, probes, phases))
    return recs


def test_flight_rules_fire_like_jax(tmp_path):
    fired = {}
    for pkg, F in (("jax", jflight), ("port", tflight)):
        fr = F.FlightRecorder(capacity=32,
                              dump_dir=str(tmp_path / pkg))
        out = []
        for s, probes, phases in _flight_sequence():
            for f in fr.record(s, probes, phases=phases):
                out.append((f["rule"], f["step"],
                            tuple(f.get("poisoned_parties", ()))))
        fired[pkg] = out
        assert len(fr.dumps) == len({s for _r, s, _p in out})
    assert fired["port"] == fired["jax"]
    rules = {r for r, _s, _p in fired["port"]}
    assert {tflight.GRAD_SPIKE, tflight.DENSITY_DRIFT,
            tflight.EXPOSED_JUMP, tflight.NONFINITE} <= rules
    assert (tflight.NONFINITE, 33, (1,)) in fired["port"]
    bundle = json.load(open(tmp_path / "port"
                            / "flight_step33_nonfinite_probe.json"))
    assert bundle["poisoned_parties"] == [1]
    assert len(bundle["ring"]) == 32


def test_host_incidents_fan_out(tmp_path, registries):
    """``notify_host_incident`` and ``announce_host_restart`` (through
    ``record_host_restart``) reach the registry, the event log and every
    installed flight recorder."""
    from geomx_tpu_torch.resilience.durability import record_host_restart
    log = texport.EventLog(str(tmp_path / "e.jsonl"))
    texport.set_default_event_log(log)
    fr = tflight.FlightRecorder(capacity=4)
    tflight.install_incident_recorder(fr)
    try:
        tflight.notify_host_incident("wire_crc_error", reason="crc")
        record_host_restart("server_r1", 3, rank=1)
        record_host_restart("scheduler", 2)
    finally:
        tflight.uninstall_incident_recorder(fr)
        texport.set_default_event_log(None)
    assert [i["kind"] for i in fr.incidents()] == \
        ["wire_crc_error", "server_restart", "scheduler_restart"]
    assert [e["kind"] for e in log.read()] == \
        ["wire_crc_error", "server_restart", "scheduler_restart"]
    reg = registries["port"]
    assert reg.get("geomx_host_generation").labels(
        node="server_r1").value == 3
    inc = dict(reg.get("geomx_host_incidents_total").children())
    assert inc[("server_restart",)].value == 1


def test_membership_epoch_is_logged(tmp_path):
    from geomx_tpu_torch.resilience import PartyLivenessController
    log = texport.EventLog(str(tmp_path / "m.jsonl"))
    texport.set_default_event_log(log)
    try:
        ctl = PartyLivenessController(3)
        ctl.mark_dead(1)
    finally:
        texport.set_default_event_log(None)
    ev = [e for e in log.read() if e["kind"] == "membership_epoch"]
    assert ev and ev[-1]["live_mask"] == [True, False, True]
    assert ev[-1]["num_live"] == 2


# ---- probes ------------------------------------------------------------------

def test_replicate_and_party_flags_match_jax():
    """``_replicate`` (worker mean, then the live-party mean) and the
    per-party NaN flag of the raw gradient against the JAX probes run
    under ``shard_map`` on the virtual CPU mesh, all parties live and
    party 1 dead."""
    topo = JaxTopology(num_parties=2, workers_per_party=2)
    mesh = topo.build_mesh()
    rng = np.random.RandomState(0)
    vals = rng.rand(2, 2).astype(np.float32)
    g = rng.randn(2, 2, 64).astype(np.float32)
    g[1, 1, 7] = np.nan
    for mask in ((True, True), (True, False)):
        jsync = JaxFSA()
        jsync.bind_topology(topo)
        jsync.bind_membership(mask)

        def f(v, gg):
            local = {"w": gg[0, 0]}
            out = jprobes.collect_step_probes(
                local, None, jsync, {"dc_comp": (), "worker_comp": ()},
                None, local)
            return (jprobes._replicate(v[0, 0], jsync),
                    out["party_grad_nonfinite"],
                    out["grad_nonfinite_parties"])

        mapped = jax.jit(shard_map_compat(
            f, mesh, in_specs=(P("dc", "worker"), P("dc", "worker")),
            out_specs=(P(), P(), P())))
        sh = topo.batch_sharding(mesh)
        jr, jflag, jn = mapped(jax.device_put(vals, sh),
                               jax.device_put(g, sh))
        tsync = FSA()
        tsync.bind_topology(HiPSTopology(2, 2))
        tsync.bind_membership(mask)
        pr = tprobes._replicate(torch.from_numpy(vals), tsync)
        out = tprobes.collect_step_probes(
            {"w": torch.from_numpy(g)}, None, tsync, {"dc_comp": ()},
            None, {"w": torch.from_numpy(g)}, wire={})
        np.testing.assert_allclose(pr.item(), float(jr), rtol=1e-6)
        assert out["party_grad_nonfinite"].tolist() == \
            np.asarray(jflag).tolist() == [0.0, 1.0]
        assert out["grad_nonfinite_parties"].item() == float(jn) == 1.0


def _trainers(mesh, jtopo, telemetry=True):
    cfg = dict(num_parties=2, workers_per_party=2, precision="fp32",
               compression=BSC, fused_optim=True, telemetry=telemetry)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32), jtopo,
                    optim_pallas.fused_optimizer(
                        "sgd", learning_rate=0.1, momentum=0.9),
                    config=JaxConfig(**cfg), mesh=mesh, donate=False)
    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 2), port_optim.fused_optimizer(
                     "sgd", learning_rate=0.1, momentum=0.9),
                 config=GeoConfig(**cfg), device="cpu")
    return jt, pt


EXACT = ("party_grad_nonfinite", "grad_nonfinite_parties",
         "grad_nonfinite_count", "grad_all_finite", "dc_wire_bytes",
         "dc_dense_bytes", "dc_compression_ratio", "worker_wire_bytes")


def test_step_probes_match_jax_trainer():
    """A full step, then party 1 dead for one step (reset policy), from
    the same converted weights and batches: the probe dicts agree —
    counts, flags and wire accounting exactly, norms and fractions
    within rtol 1e-5."""
    jtopo = JaxTopology(num_parties=2, workers_per_party=2)
    jt, pt = _trainers(jtopo.build_mesh(), jtopo)
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (64, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 64).astype(np.int32)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    params, stats = from_flax(p0, s0)
    pst = pt.init_state(params=params, model_state=stats)
    jb = list(jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0))
    pb = list(pt.make_loader(x, y, 8, seed=0).epoch(0))
    for i in range(2):
        if i == 1:
            jst = jt.apply_membership(jst, (True, False))
            pst = pt.apply_membership(pst, (True, False))
        jst, jm = jt.train_step(jst, *jb[i])
        pst, pm = pt.train_step(pst, *pb[i])
        jp = jax.tree.map(lambda a: np.asarray(a).tolist(),
                          jax.device_get(jm["telemetry"]))
        pp = tprobes.host_probes(pm["telemetry"])
        assert sorted(pp) == sorted(jp), (sorted(pp), sorted(jp))
        for k in sorted(pp):
            if k in EXACT:
                assert pp[k] == jp[k], (i, k, pp[k], jp[k])
            else:
                np.testing.assert_allclose(pp[k], jp[k], rtol=1e-5,
                                           err_msg=f"step {i} {k}")
        assert pp["grad_all_finite"] == 1.0
        assert 0.0 < pp["bsc_emitted_fraction"] <= 1.0


def _op_sequence(trainer, state, x, y):
    """The step's ATen ops with their record_function scopes, in order
    (``analysis/record.py``)."""
    return record_program(trainer.train_step, state, x, y).ops()


@pytest.mark.parametrize("fused", [True, False])
def test_disabled_telemetry_dispatches_the_same_ops(monkeypatch, fused):
    """The port's form of the JAX package's byte-identical-jaxpr pin:
    with telemetry off, the step dispatches exactly the ATen op sequence
    of a build whose probe collector raises (and so can never run)."""
    monkeypatch.delenv("GEOMX_TELEMETRY", raising=False)

    def build():
        cfg = GeoConfig(num_parties=2, workers_per_party=2,
                        precision="fp32", compression=BSC,
                        fused_optim=fused)
        tx = port_optim.fused_optimizer("sgd", learning_rate=0.1,
                                        momentum=0.9) if fused else \
            __import__("geomx_tpu_torch.optim", fromlist=["sgd"]).sgd(0.1)
        return Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                       HiPSTopology(2, 2), tx, config=cfg, device="cpu")

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (2, 2, 4, 16, 16, 3))
                         .astype(np.uint8))
    y = torch.from_numpy(rng.randint(0, 10, (2, 2, 4)).astype(np.int64))
    tr = build()
    st = tr.init_state(seed=0)
    ops_off = _op_sequence(tr, st, x, y)

    def _poison(*a, **k):
        raise AssertionError("probe collector ran on the disabled path")

    monkeypatch.setattr(tprobes, "collect_step_probes", _poison)
    monkeypatch.setattr(tprobes, "inline_collection", _poison)
    tr2 = build()
    ops_base = _op_sequence(tr2, tr2.init_state(seed=0), x, y)
    assert ops_off == ops_base
    # and the probes, when on, do add ops (the comparison can see them)
    monkeypatch.undo()
    monkeypatch.setenv("GEOMX_TELEMETRY", "1")
    tr3 = build()
    ops_on = _op_sequence(tr3, tr3.init_state(seed=0), x, y)
    assert len(ops_on) > len(ops_off)
    assert ops_on[:len(ops_off) // 2] == ops_off[:len(ops_off) // 2]


def _port_fit_trainer(tmp_path, **extra):
    cfg = GeoConfig(num_parties=2, workers_per_party=1, precision="fp32",
                    compression=BSC, telemetry=True,
                    telemetry_events=str(tmp_path / "events.jsonl"),
                    **extra)
    from geomx_tpu_torch.optim import sgd
    return Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                   HiPSTopology(2, 1), sgd(0.05), config=cfg, device="cpu")


def test_fit_publishes_probes_at_log_boundaries(tmp_path, registries):
    tr = _port_fit_trainer(tmp_path)
    rng = np.random.RandomState(1)
    x = (rng.rand(32, 16, 16, 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, size=(32,)).astype(np.int64)
    state = tr.init_state(seed=0)
    loader = tr.make_loader(x, y, batch_size=8)
    state, _recs = tr.fit(state, loader, epochs=2, log_every=1,
                          log_fn=lambda s: None)
    texport.set_default_event_log(None)
    reg = registries["port"]
    assert reg.get("geomx_train_steps_total")._solo().value == 4
    assert reg.get("geomx_dc_wire_bytes_total")._solo().value > 0
    assert reg.get("geomx_step_probe").labels(
        probe="grad_norm_global").value > 0
    assert reg.get("geomx_bucket_count")._solo().value == 1
    mem = dict(reg.get("geomx_step_memory_bytes").children())
    assert mem[("params",)].value > 0
    ev = [e for e in texport.EventLog(str(tmp_path / "events.jsonl"))
          .read() if e["kind"] == "step_probes"]
    assert [e["iteration"] for e in ev] == [1, 2, 3, 4]
    assert all(e["party_grad_nonfinite"] == [0.0, 0.0] for e in ev)


def test_flight_recorder_names_the_poisoned_party(tmp_path, registries):
    """NaN in party 1's input batch at step 3: the nonfinite rule fires
    at step 3 and its bundle names party 1; the capsule written at fit
    end reads back with the published step records."""
    tr = _port_fit_trainer(tmp_path, flight=True, flight_steps=8,
                           flight_dir=str(tmp_path / "flight"),
                           capsule=True,
                           capsule_dir=str(tmp_path / "cap"))
    tr.model.float()
    state = tr.init_state(seed=0)
    rng = np.random.RandomState(2)
    batches = []
    for s in range(4):
        xb = torch.from_numpy(rng.rand(2, 1, 4, 16, 16, 3)
                              .astype(np.float32) * 255)
        if s == 2:
            xb[1, 0, 0, 0, 0, 0] = float("nan")
        batches.append((xb, torch.from_numpy(
            rng.randint(0, 10, (2, 1, 4)).astype(np.int64))))

    class _Loader:
        def epoch(self, epoch, prefetch=0):
            return iter(batches)

    state, _ = tr.fit(state, _Loader(), epochs=1, log_every=1,
                      log_fn=lambda s: None)
    tr.close_capsule()
    texport.set_default_event_log(None)
    tflight.uninstall_incident_recorder(tr._flight)
    dump = [d for d in tr._flight.dumps if "step3_nonfinite" in d]
    assert dump, tr._flight.dumps
    bundle = json.load(open(dump[0]))
    assert bundle["poisoned_parties"] == [1]
    cap = ttel.Capsule.load(str(tmp_path / "cap" / "run_capsule.json"))
    assert [s["step"] for s in cap.steps] == [1, 2, 3, 4]
    assert cap.steps[0]["probes"]["grad_all_finite"] == 1.0


# ---- roofline -----------------------------------------------------------------

def test_roofline_record_matches_jax():
    kw = dict(flops=3.2e12, step_time_s=0.25, peak_flops_per_s=989.4e12,
              hbm_bytes=None, hbm_bytes_per_s=3.35e12, wire_bytes=21808.0,
              wire_bytes_per_s=1.25e6)
    assert troof.roofline_record(**kw) == jroof.roofline_record(**kw)
    kw["hbm_bytes"] = 4.0e10
    rec = troof.roofline_record(**kw)
    assert rec == jroof.roofline_record(**kw)
    regs = (ttel.MetricRegistry(), jtel.MetricRegistry())
    troof.publish_roofline(rec, registry=regs[0])
    jroof.publish_roofline(rec, registry=regs[1])
    assert texport.render_prometheus(regs[0]) == \
        jexport.render_prometheus(regs[1])
    assert troof.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert troof.peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert troof.peak_flops("cpu") is None


def test_trainer_roofline_counts_step_flops(tmp_path):
    """On the CPU the peak is calibrated; the FLOPs come from the
    counter over one step and the HBM bytes are unknown (None)."""
    tr = _port_fit_trainer(tmp_path)
    texport.set_default_event_log(None)
    st = tr.init_state(seed=0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (2, 1, 4, 16, 16, 3))
                         .astype(np.uint8))
    y = torch.from_numpy(rng.randint(0, 10, (2, 1, 4)).astype(np.int64))
    rec = troof.trainer_roofline(tr, st, x, y, step_time_s=0.5)
    assert rec["flops_per_step"] > 0 and rec["peak_calibrated"]
    assert rec["hbm_bytes_per_step"] is None
    assert rec["bound"] == "compute_bound" and 0 < rec["mfu"]
    assert rec["wire_bytes_per_step"] == \
        tr.sync.wire_accounting(st.params)["dc_wire_bytes"]
