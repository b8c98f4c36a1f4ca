"""Port parity: FleetScope (geomx_tpu_torch/telemetry/fleetscope.py)
against the JAX package's (geomx_tpu/telemetry/fleetscope.py).

The same canned node bodies (injected ``targets_fn``/``fetch_fn``, an
explicit ``now``) give fleet documents equal under ``json.dumps(...,
sort_keys=True)`` in both packages: a healthy fleet, a torn exposition,
a ``/healthz`` timeout and a node death mid-poll (the victim marked with
a named reason, every other node's fold identical to the no-failure
fold), one failed poll inside the stale window.  The burn-rate monitor,
the propagation tracker, ``roster_targets``, ``parse_burn_windows`` and
``fleetscope_from_config`` give the JAX package's values; the rollups
reach the port's ``ControlSensors``; the port's scheduler serves
``GET /fleet`` from its exporter.  The serving-plane cases of
``tests/test_fleetscope.py`` (request ledger, replicas, gateways) are in
``tests/test_torch_serve_gateway.py``.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

import bench
import chip_smoke
import geomx_tpu.telemetry.fleetscope as jfs
import geomx_tpu.telemetry.registry as jreg
import geomx_tpu_torch.telemetry.fleetscope as tfs
import geomx_tpu_torch.telemetry.registry as treg
from geomx_tpu.control.sensors import ControlSensors as JaxSensors
from geomx_tpu_torch.control.sensors import ControlSensors
from geomx_tpu_torch.service.scheduler import GeoScheduler, SchedulerClient

PKGS = {"jax": (jfs, jreg), "port": (tfs, treg)}

GOOD_METRICS = "\n".join([
    '# TYPE geomx_serve_requests_total counter',
    'geomx_serve_requests_total{status="ok"} 100',
    'geomx_serve_requests_total{status="shed"} 5',
    '# TYPE geomx_wire_honesty_ratio gauge',
    'geomx_wire_honesty_ratio 1.01',
]) + "\n"
# a sample with no preceding # TYPE line: the strict parser rejects it
TORN_METRICS = "geomx_orphan_series 1\n"
GOOD_HEALTHZ = json.dumps({
    "status": "ok",
    "serving": {"v1": {"replica": {"staleness_s": 0.25}}}})
GOOD_LEDGER = json.dumps({
    "summary": {"open": 0},
    "requests": {"summary": {"qps": 50.0, "total_p50_s": 0.01,
                             "total_p99_s": 0.02}},
    "records": [{"round": 4, "hops": [{"hop": "merge", "t": 99.5}]}]})
PORTS = (7001, 7002, 7003)
VICTIM = 7002

SCENARIOS = {
    "healthy": dict(),
    "torn_metrics": dict(
        broken2=lambda p, path: TORN_METRICS
        if (p, path) == (VICTIM, "/metrics") else None,
        health="stale", reason="metrics: ValueError"),
    "healthz_timeout": dict(
        broken2=lambda p, path: TimeoutError("injected")
        if (p, path) == (VICTIM, "/healthz") else None,
        health="stale", reason="healthz: TimeoutError"),
    "death_mid_poll": dict(dead2=(VICTIM,), health="dead",
                           reason="heartbeat_timeout"),
}


@pytest.fixture(autouse=True)
def _fresh_globals():
    for fs, reg in PKGS.values():
        reg.reset_registry()
        fs.reset_propagation_tracker()
    yield
    for fs, reg in PKGS.values():
        reg.reset_registry()
        fs.reset_propagation_tracker()


def _targets(dead=()):
    return [{"name": f"serve:n{p}", "kind": "serve", "id": p,
             "host": "127.0.0.1", "port": p, "http_port": p,
             "dead": p in dead} for p in PORTS]


def _make_fetch(state):
    def fetch(url, timeout_s):
        hostport, _, tail = url.split("://", 1)[1].partition("/")
        port = int(hostport.rsplit(":", 1)[1])
        path = "/" + tail.partition("?")[0]
        if state.get("broken") is not None:
            hit = state["broken"](port, path)
            if isinstance(hit, Exception):
                raise hit
            if hit is not None:
                return hit
        return {"/metrics": GOOD_METRICS, "/healthz": GOOD_HEALTHZ,
                "/ledger": GOOD_LEDGER}[path]
    return fetch


def _scope(fs, state):
    return fs.FleetScope(targets_fn=lambda: state["targets"],
                         fetch_fn=_make_fetch(state), interval_s=1.0,
                         stale_after_s=1.0, burn_windows="60:14,300:6",
                         tracker=fs.PropagationTracker())


def _two_polls(fs, sc):
    """A healthy poll at t=100, then one at t=110 under the scenario."""
    state = {"targets": _targets(), "broken": None}
    scope = _scope(fs, state)
    scope.poll_once(now=100.0)
    state["targets"] = _targets(dead=sc.get("dead2", ()))
    state["broken"] = sc.get("broken2")
    return scope, scope.poll_once(now=110.0)


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_document_matches_jax(name):
    sc = SCENARIOS[name]
    docs = {pkg: _two_polls(fs, sc)[1] for pkg, (fs, _) in PKGS.items()}
    assert _canon(docs["port"]) == _canon(docs["jax"])
    doc = docs["port"]
    assert doc["kind"] == "geomx_fleet_document"
    assert doc["fleet_version"] == 2
    if name == "healthy":
        assert all(e["health"] == "ok" for e in doc["nodes"].values())
        assert doc["rollups"]["qps"] == pytest.approx(150.0)
        assert doc["rollups"]["shed_rate"] == pytest.approx(15.0 / 315.0)
        return
    victim = doc["nodes"][f"serve:n{VICTIM}"]
    assert (victim["health"], victim["reason"]) == (sc["health"],
                                                    sc["reason"])
    assert victim["healthz"]["status"] == "ok"   # marked, never fatal
    _, control = _two_polls(tfs, {})
    for port in PORTS:
        if port != VICTIM:
            key = f"serve:n{port}"
            assert _canon(doc["nodes"][key]) == \
                _canon(control["nodes"][key]), port
    trans = [t for t in doc["transitions"]
             if t["node"] == f"serve:n{VICTIM}"]
    assert trans[-1]["to"] == sc["health"]
    assert trans[-1]["reason"] == sc["reason"]


def test_single_failed_poll_within_stale_window_stays_ok():
    out = {}
    for pkg, (fs, _) in PKGS.items():
        state = {"targets": _targets(), "broken": None}
        scope = _scope(fs, state)
        scope.poll_once(now=100.0)
        state["broken"] = lambda p, path: TimeoutError("blip") \
            if p == VICTIM else None
        out[pkg] = [scope.poll_once(now=100.5), scope.poll_once(now=110.0)]
    assert [_canon(d) for d in out["port"]] == \
        [_canon(d) for d in out["jax"]]
    first, later = out["port"]
    assert first["nodes"][f"serve:n{VICTIM}"]["health"] == "ok"
    assert later["nodes"][f"serve:n{VICTIM}"]["health"] == "stale"


def test_rollups_feed_the_control_sensors_like_jax():
    for fs, _ in PKGS.values():
        _two_polls(fs, {})
    jobs = JaxSensors(registry=jreg.get_registry()).observe(0)
    obs = ControlSensors(registry=treg.get_registry()).observe(0)
    for field in ("fleet_qps", "fleet_shed_rate", "fleet_staleness_max_s",
                  "fleet_burn_rate", "fleet_propagation_p99_s",
                  "fleet_nodes_dead"):
        assert getattr(obs, field) == getattr(jobs, field), field
    assert obs.fleet_qps == pytest.approx(150.0)
    assert obs.fleet_nodes_dead == 0


def test_document_route_serves_the_document():
    scope, doc = _two_polls(tfs, {})
    body, ctype = scope.document_route()
    assert ctype == "application/json"
    assert json.loads(body)["fleet_version"] == doc["fleet_version"]
    empty, _ = tfs.FleetScope(targets_fn=list,
                              interval_s=1.0).document_route()
    jempty, _ = jfs.FleetScope(targets_fn=list,
                               interval_s=1.0).document_route()
    assert empty == jempty


ROSTER = {
    "serve": [(900, "127.0.0.1", 8100, "gateway"),
              (902, "127.0.0.1", 0, "registry")],
    "worker": [(3, "10.0.0.2", 0, "p0;http=9001"),
               (5, "10.0.0.3", 0, "")],
    "server": [(100, "127.0.0.1", 9200, "0")],
}


@pytest.mark.parametrize("dead", [(), (902,), (902, 3)])
def test_roster_targets_match_jax(dead):
    port = tfs.roster_targets(ROSTER, dead_ids=dead)
    assert port == jfs.roster_targets(ROSTER, dead_ids=dead)
    nodes = {n["name"]: n for n in port}
    assert nodes["serve:gateway"]["http_port"] == 8100
    assert nodes["serve:registry"]["http_port"] is None
    assert nodes["worker:p0"]["http_port"] == 9001
    assert nodes["worker:5"]["http_port"] is None
    assert nodes["serve:registry"]["dead"] == (902 in dead)


def test_heartbeat_only_node_health_comes_from_dead_list():
    out = {}
    for pkg, (fs, _) in PKGS.items():
        targets = [{"name": "serve:registry", "kind": "serve", "id": 902,
                    "host": "127.0.0.1", "port": 0, "http_port": None,
                    "dead": False}]
        scope = fs.FleetScope(targets_fn=lambda: list(targets),
                              fetch_fn=_make_fetch({}), interval_s=1.0,
                              tracker=fs.PropagationTracker())
        first = scope.poll_once(now=100.0)
        targets[0]["dead"] = True
        out[pkg] = (first, scope.poll_once(now=110.0))
    assert [_canon(d) for d in out["port"]] == \
        [_canon(d) for d in out["jax"]]
    first, later = out["port"]
    assert first["nodes"]["serve:registry"]["health"] == "ok"
    assert later["nodes"]["serve:registry"]["health"] == "dead"
    assert later["nodes"]["serve:registry"]["reason"] == "heartbeat_timeout"


@pytest.mark.parametrize("spec", ["60:14,300:6", "60", "300:6, 60:14", "",
                                  "0:5", "60:-1", " , ,"])
def test_parse_burn_windows_like_jax(spec):
    try:
        want = jfs.parse_burn_windows(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tfs.parse_burn_windows(spec)
        return
    assert tfs.parse_burn_windows(spec) == want


def _burn_series():
    """Healthy, a bad burst, recovery, a second burst."""
    out = [(float(t), 9.0, 1.0) for t in range(0, 30)]
    out += [(float(t), 0.0, 10.0) for t in range(30, 45)]
    out += [(float(t), 10.0, 0.0) for t in range(45, 90)]
    out += [(float(t), 0.0, 10.0) for t in range(90, 110)]
    return out


def _run_burn(fs, series, windows="10:2,30:1", slo=0.9):
    mon = fs.BurnRateMonitor(windows=windows, slo_target=slo)
    breaches = []
    for t, good, bad in series:
        mon.record(t, good, bad)
        b = mon.evaluate(t)
        if b is not None:
            breaches.append(b)
    return mon, breaches


def test_burn_breach_onset_rearm_and_determinism():
    series = _burn_series()
    mon, breaches = _run_burn(tfs, series)
    _, jbreaches = _run_burn(jfs, series)
    assert _canon(breaches) == _canon(jbreaches)
    assert len(breaches) == 2 and breaches == mon.breaches
    assert 30.0 <= breaches[0]["t"] < 45.0 <= 90.0 <= breaches[1]["t"]
    ((_, child),) = treg.get_registry().get(
        "geomx_fleet_burn_breaches_total").children()
    assert child.value == 2.0
    assert _canon(_run_burn(tfs, series)[1]) == _canon(breaches)


@pytest.mark.parametrize("case", ["healthy", "blip"])
def test_burn_never_breaches_like_jax(case):
    if case == "healthy":
        series, windows = [(float(t), 10.0, 0.0) for t in range(20)], "10:2"
    else:
        # the short window spikes, the long one stays under: no page
        series = [(float(t), 10.0, 0.0) for t in range(55)] + \
            [(float(t), 0.0, 10.0) for t in range(55, 60)]
        windows = "5:2,60:5"
    for fs, _ in PKGS.values():
        mon, breaches = _run_burn(fs, series, windows=windows)
        assert breaches == []
    assert mon.max_burn(19.0) == \
        _run_burn(tfs, series, windows=windows)[0].max_burn(19.0)


def test_seeded_burn_series_is_the_benchmarks():
    """chip_smoke.py's copy of bench.py's seeded burn run over the port's
    monitor gives bench.py's bytes (over the JAX package's monitor)."""
    for seed in (1234, 7):
        assert chip_smoke.fleetscope_burn_series(seed) == \
            bench._fleetscope_burn_series(seed)
    assert chip_smoke.fleetscope_burn_series(1234)[1] >= 1


def _propagation(fs):
    tr = fs.PropagationTracker()
    tr.note(7, "publish", t=10.0)
    tr.note(7, "apply", t=10.5)
    tr.note(7, "served", t=11.0, transport="http")
    first = tr.rounds()
    tr.note(7, "merge", t=9.0)
    tr.note(7, "served", t=10.8, transport="native")
    return first, tr.rounds(), tr.summary()


def test_propagation_join_and_min_instant():
    port, jax_ = _propagation(tfs), _propagation(jfs)
    assert _canon(port) == _canon(jax_)
    (first,), (rec,), summary = port
    assert first["propagation_s"] == pytest.approx(1.0)
    assert rec["propagation_s"] == pytest.approx(1.8)
    assert rec["served_by"] == {"http": 11.0, "native": 10.8}
    assert summary["by_transport"] == {"http": 1, "native": 1}


def test_propagation_bounds_and_errors():
    for fs, _ in PKGS.values():
        tr = fs.PropagationTracker(capacity=2)
        for rid in (1, 2, 3):
            tr.note(rid, "publish", t=float(rid))
        tr.note(0, "publish", t=1.0)
        assert [r["round"] for r in tr.rounds()] == [2, 3]
        with pytest.raises(ValueError):
            tr.note(5, "warp", t=1.0)
        with pytest.raises(ValueError):
            fs.note_propagation(5, "warp")


def test_propagation_ingest_round_records():
    records = [
        {"round": 6, "hops": [{"hop": "push", "t": 1.0},
                              {"hop": "journal", "t": 49.0},
                              {"hop": "merge", "t": 50.0}]},
        {"round": 0, "hops": [{"hop": "merge", "t": 1.0}]},
        {"no_round": True},
    ]
    out = {}
    for pkg, (fs, _) in PKGS.items():
        tr = fs.PropagationTracker()
        out[pkg] = (tr.ingest_round_records(records), tr.rounds())
    assert out["port"] == out["jax"]
    n, (rec,) = out["port"]
    assert n == 1 and rec["merge"] == 49.0


def test_propagation_publishes_histogram_on_completion():
    texts = {}
    for pkg, (fs, reg) in PKGS.items():
        tr = fs.get_propagation_tracker()
        tr.note(3, "merge", t=1.0)
        tr.note(3, "served", t=1.5, transport="http")
        ((_, child),) = reg.get_registry().get(
            "geomx_fleet_propagation_seconds").children()
        texts[pkg] = child.snapshot()
    assert texts["port"] == texts["jax"]
    assert texts["port"][2] == 1 and texts["port"][1] == pytest.approx(0.5)


def test_fleetscope_from_config_gating(monkeypatch):
    for var in ("GEOMX_FLEETSCOPE", "GEOMX_FLEETSCOPE_INTERVAL_S",
                "GEOMX_FLEETSCOPE_BURN_WINDOWS"):
        monkeypatch.delenv(var, raising=False)
    sentinel = object()
    assert tfs.fleetscope_from_config(sentinel) is None
    monkeypatch.setenv("GEOMX_FLEETSCOPE", "1")
    monkeypatch.setenv("GEOMX_FLEETSCOPE_INTERVAL_S", "0.5")
    monkeypatch.setenv("GEOMX_FLEETSCOPE_BURN_WINDOWS", "30:2")
    fs = tfs.fleetscope_from_config(sentinel)
    jf = jfs.fleetscope_from_config(sentinel)
    assert isinstance(fs, tfs.FleetScope) and fs.scheduler is sentinel
    assert (fs.interval_s, fs.burn.windows) == (jf.interval_s,
                                                jf.burn.windows)
    assert fs.interval_s == pytest.approx(0.5)
    assert fs.burn.windows == ((30.0, 2.0),)


def test_scheduler_serves_fleet(monkeypatch):
    """GEOMX_FLEETSCOPE=1: the port's scheduler serves GET /fleet from
    its exporter and runs the poller with it; the document names every
    roster node (heartbeat-covered, no HTTP surface) and the scheduler
    itself (polled over its own endpoint), its version rising."""
    monkeypatch.setenv("GEOMX_FLEETSCOPE", "1")
    monkeypatch.setenv("GEOMX_FLEETSCOPE_INTERVAL_S", "0.05")
    sched = GeoScheduler(port=0, metrics_port=0).start()
    try:
        assert sched.fleetscope is not None
        client = SchedulerClient(("127.0.0.1", sched.port))
        client.register("server", "127.0.0.1", 9200, tag="0")
        client.register("worker", "127.0.0.1", 0, tag="0.0")
        base = f"http://127.0.0.1:{sched.metrics_port}"
        versions, doc = [], None
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            doc = json.loads(urllib.request.urlopen(base + "/fleet",
                                                    timeout=5).read())
            versions.append(doc["fleet_version"])
            if len(doc.get("nodes", {})) == 3 and versions[-1] > \
                    versions[0] and doc["nodes"]["scheduler"]["health"] \
                    == "ok":
                break
            time.sleep(0.1)
        assert versions[-1] > versions[0], versions
        kinds = sorted(e["kind"] for e in doc["nodes"].values())
        assert kinds == ["scheduler", "server", "worker"], doc["nodes"]
        assert doc["nodes"]["scheduler"]["health"] == "ok", doc["nodes"]
    finally:
        sched.stop()
    assert sched.fleetscope._thread is None
    monkeypatch.setenv("GEOMX_FLEETSCOPE", "0")
    off = GeoScheduler(metrics_port=0)
    try:
        assert off.fleetscope is None
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{off.metrics_port}/fleet", timeout=5)
        assert e.value.code == 404
    finally:
        off.stop()
