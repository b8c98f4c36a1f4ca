"""Port parity: run capsules and the step-time cost model
(geomx_tpu_torch/telemetry/capsule.py, costmodel.py) against the JAX
package's (geomx_tpu/telemetry/).

The same observation sequences, with explicit timestamps, go through
both packages' recorders: the archives read back bit-identically, the
link journal replays bit-identically, and a cost model fitted from the
same capsule document predicts the same step times (rel 1e-9) in both.
``candidate_wire_bytes`` agrees exactly with the JAX package's for
``bsc,0.01``, ``2bit,0.5`` and ``fp16`` (the port's compressors over
``meta`` tensors, the JAX package's over ``ShapeDtypeStruct``s).  The
port has no control plane yet: the decision-log section is ``[]`` and
the sensor replay refuses, naming "Control".
"""

import json

import pytest

import geomx_tpu.telemetry as jtel
import geomx_tpu.telemetry.capsule as jcap
import geomx_tpu.telemetry.costmodel as jcost
import geomx_tpu.telemetry.links as jlinks
import geomx_tpu_torch.telemetry as ttel
import geomx_tpu_torch.telemetry.capsule as tcap
import geomx_tpu_torch.telemetry.costmodel as tcost
import geomx_tpu_torch.telemetry.links as tlinks

PKGS = {"jax": (jtel, jcap, jcost, jlinks),
        "port": (ttel, tcap, tcost, tlinks)}


@pytest.fixture()
def registries():
    """Fresh process registries in both packages (restored after)."""
    regs = {"jax": jtel.reset_registry(), "port": ttel.reset_registry()}
    yield regs
    jtel.reset_registry()
    ttel.reset_registry()


def _feed_obs(obs, fail_step=6):
    for i in range(10):
        t = float(i)
        obs.observe("party0", nbytes=1e6, seconds=0.02 + 0.001 * i, t=t)
        ok = i != fail_step
        obs.observe("party1", nbytes=1e6,
                    seconds=0.3 if i >= 5 else 0.04, ok=ok, t=t)


def _record_run(pkg, path, registry):
    """One scripted run through a package's capsule: the observatory
    tap, per-step records from the registry's gauge families, registry
    samples at explicit instants."""
    tel, cap_mod, _cost, links = PKGS[pkg]
    obs = links.LinkObservatory(alpha=0.4, stale_after_s=5.0)
    cap = cap_mod.RunCapsule(str(path))
    cap.attach_observatory(obs)
    fam = registry.gauge("geomx_step_probe", labels=("probe",))
    pfam = registry.gauge("geomx_phase_fraction", labels=("phase",))
    for i in range(8):
        t = float(i)
        fam.labels(probe="grad_norm_global").set(1.0 + 0.25 * i)
        fam.labels(probe="dc_wire_bytes").set(21808.0)
        pfam.labels(phase="exposed_comms").set(0.125 * i)
        obs.observe("party0", nbytes=1e6, seconds=0.01 + 1e6 * 1e-8, t=t)
        obs.observe("party0", "probe", nbytes=4096.0,
                    seconds=0.01 + 4096.0 * 1e-8, t=t)
        obs.observe("party1", nbytes=1e6,
                    seconds=0.5 if i >= 4 else 0.05, t=t)
        cap.record_step(i, t=t, timing={"total_s": 0.07 + 0.001 * i,
                                        "compute_s": 0.05})
        cap.sampler.sample(now=t)
    return cap.write(now=7.0), obs


def _strip(doc):
    """A capsule document without its wall-clock fields (the manifest's
    creation/write instants, build, env and the ledger/event sections
    that depend on the process)."""
    doc = json.loads(json.dumps(doc))
    doc.pop("ledger", None)
    doc.pop("events", None)
    man = doc["manifest"]
    for k in ("created_unix", "anchor_unix", "written_unix", "build",
              "env"):
        man.pop(k, None)
    return doc


def test_capsule_documents_match_jax(tmp_path, registries):
    """The same run recorded by both packages gives the same archive,
    wall-clock fields aside; the port's archive reads back through
    ``Capsule`` bit-identically."""
    docs = {}
    for pkg in PKGS:
        path, _obs = _record_run(pkg, tmp_path / f"{pkg}.json",
                                 registries[pkg])
        with open(path) as f:
            docs[pkg] = json.load(f)
    assert json.dumps(_strip(docs["port"]), sort_keys=True) == \
        json.dumps(_strip(docs["jax"]), sort_keys=True)
    loaded = tcap.Capsule.load(str(tmp_path / "port.json"))
    assert json.dumps(loaded.doc, sort_keys=True) == \
        json.dumps(docs["port"], sort_keys=True)
    assert loaded.decisions == []       # no control plane yet


@pytest.mark.parametrize("now", [4.0, 9.0])
def test_capsule_link_snapshot_bit_identical(tmp_path, registries, now):
    """The link journal replays bit-identically at the end and at a
    mid-run instant (no future leakage), and equals the JAX package's
    live snapshot of the same observations."""
    obs = tlinks.LinkObservatory(alpha=0.4, stale_after_s=5.0)
    cap = tcap.RunCapsule(str(tmp_path / "c.json"))
    cap.attach_observatory(obs)
    _feed_obs(obs)
    loaded = tcap.Capsule.load(cap.write(now=9.0))
    live = tlinks.LinkObservatory(alpha=0.4, stale_after_s=5.0)
    jlive = jlinks.LinkObservatory(alpha=0.4, stale_after_s=5.0)
    for o in (live, jlive):
        for i in range(10):
            t = float(i)
            if t > now:
                break
            o.observe("party0", nbytes=1e6, seconds=0.02 + 0.001 * i, t=t)
            o.observe("party1", nbytes=1e6,
                      seconds=0.3 if i >= 5 else 0.04, ok=i != 6, t=t)
    want = json.dumps(live.snapshot(now=now), sort_keys=True)
    assert json.dumps(loaded.link_snapshot(now=now), sort_keys=True) \
        == want
    assert json.dumps(jlive.snapshot(now=now), sort_keys=True) == want


def test_capsule_manifest_and_sections(tmp_path, registries, monkeypatch):
    monkeypatch.setenv("GEOMX_TEST_KNOB", "42")
    from geomx_tpu_torch import GeoConfig
    cfg = GeoConfig(telemetry=True, chaos_schedule="seed=3")
    cap = tcap.RunCapsule(str(tmp_path / "c.json"), config=cfg,
                          extra_manifest={"note": "unit"})
    registries["port"].gauge("geomx_step_probe", labels=("probe",)) \
        .labels(probe="grad_norm_global").set(1.5)
    cap.record_step(0, t=0.5, timing={"total_s": 0.1})
    cap.sampler.sample(now=0.5)
    loaded = tcap.Capsule.load(cap.write(now=0.5))
    m = loaded.manifest
    assert m["kind"] == "geomx_run_capsule" and m["version"] == 1
    assert m["config"]["telemetry"] is True
    assert m["chaos_schedule"] == "seed=3"
    assert m["env"]["GEOMX_TEST_KNOB"] == "42"
    assert m["extra"]["note"] == "unit"
    assert loaded.steps[0]["probes"]["grad_norm_global"] == 1.5
    assert loaded.registry_samples[0]["t"] == 0.5
    assert loaded.doc["decisions"] == []
    with pytest.raises(NotImplementedError, match="'Control'"):
        loaded.sensors()


def test_capsule_unknown_version_rejected(tmp_path):
    cap = tcap.RunCapsule(str(tmp_path / "c.json"))
    doc = json.load(open(cap.write()))
    doc["manifest"]["version"] = 99
    with pytest.raises(ValueError, match="version"):
        tcap.Capsule(doc)
    with pytest.raises(ValueError, match="not a run capsule"):
        tcap.Capsule({"manifest": {"kind": "something_else"}})
    # either package reads the other's archive
    jcap.Capsule(json.load(open(cap.write())))


def test_capsule_from_config_gating(tmp_path, monkeypatch):
    assert tcap.capsule_from_config(None) is None
    monkeypatch.setenv("GEOMX_CAPSULE", "1")
    monkeypatch.setenv("GEOMX_CAPSULE_DIR", str(tmp_path / "caps"))
    monkeypatch.setenv("GEOMX_CAPSULE_SAMPLE_S", "2.5")
    for mod in (tcap, jcap):
        cap = mod.capsule_from_config(None)
        assert cap.path == str(tmp_path / "caps" / "run_capsule.json")
        assert cap.sampler.interval_s == 2.5


def test_sample_registry_matches_jax(registries):
    """The same registry contents sample to the same document, and the
    sampler clamps a non-positive cadence to the default in both."""
    for pkg, reg in registries.items():
        reg.counter("geomx_c_total", "c", ("k",)).labels(k="a").inc(3)
        reg.gauge("geomx_g", "g").set(2.5)
        h = reg.histogram("geomx_h_seconds", "h", ("phase",),
                          buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.labels(phase="x").observe(v)
    got = {pkg: PKGS[pkg][1].sample_registry(max_children_per_family=1)
           for pkg in PKGS}
    assert json.dumps(got["port"], sort_keys=True) == \
        json.dumps(got["jax"], sort_keys=True)
    assert tcap.RegistrySampler(interval_s=0).interval_s == \
        jcap.RegistrySampler(interval_s=0).interval_s == 10.0


def test_cost_model_from_the_same_capsule_matches_jax(tmp_path,
                                                      registries):
    """One capsule document, fitted in both packages: the same links,
    compute and predictions within 1e-9 relative."""
    path, _ = _record_run("port", tmp_path / "c.json", registries["port"])
    with open(path) as f:
        doc = json.load(f)
    models = {pkg: PKGS[pkg][2].StepTimeCostModel.fit(
        PKGS[pkg][1].Capsule(json.loads(json.dumps(doc))))
        for pkg in PKGS}
    assert sorted(models["port"].links) == sorted(models["jax"].links)
    assert models["port"].compute_s == \
        pytest.approx(models["jax"].compute_s, rel=1e-9)
    for cand in ({"wire_bytes": 21808.0, "depth": 0},
                 {"wire_bytes": 1090048.0, "depth": 1},
                 {"wire_bytes": 68608.0, "depth": 0}):
        p = models["port"].predict(cand)
        j = models["jax"].predict(cand)
        assert p["mean_step_s"] == pytest.approx(j["mean_step_s"],
                                                 rel=1e-9)
    assert json.dumps(models["port"].to_json(), sort_keys=True) == \
        json.dumps(models["jax"].to_json(), sort_keys=True)


SHAPES = {"conv": {"shape": [3, 3, 16, 32], "dtype": "float32"},
          "dense": {"shape": [2048, 10], "dtype": "float32"},
          "bias": {"shape": [10], "dtype": "float32"}}


@pytest.mark.parametrize("spec", ["bsc,0.01", "2bit,0.5", "fp16", "none"])
@pytest.mark.parametrize("bucket_bytes", [0, 4 * 1024 * 1024])
def test_candidate_wire_bytes_matches_jax(spec, bucket_bytes):
    got = tcost.candidate_wire_bytes(SHAPES, spec, bucket_bytes)
    if spec.startswith("2bit"):
        # the port's 2-bit compressor always runs the kernel wire format
        # (128 words a 2,048-element row), which the JAX package runs
        # with its Pallas kernels (use_pallas, the default on a TPU)
        import jax

        from geomx_tpu.compression.bucketing import BucketedCompressor
        from geomx_tpu.compression.twobit import TwoBitCompressor
        comp = TwoBitCompressor(threshold=0.5, use_pallas=True)
        if bucket_bytes:
            comp = BucketedCompressor(comp, bucket_bytes=bucket_bytes)
        want = float(comp.wire_bytes(
            {k: jax.ShapeDtypeStruct(tuple(v["shape"]), v["dtype"])
             for k, v in SHAPES.items()}))
    else:
        want = jcost.candidate_wire_bytes(SHAPES, spec, bucket_bytes)
    assert got == want


def test_fit_affine_and_paired_links_match_jax():
    a, ib = 0.02, 1e-8
    samples = [{"t": float(i), "nbytes": b, "seconds": a + b * ib,
                "ok": True}
               for i, b in enumerate([1e5, 5e5, 1e6, 2e6, 4e6])]
    assert tcost.fit_affine_link(samples) == jcost.fit_affine_link(samples)
    payload = [{"t": float(i), "nbytes": 1e6, "seconds": 0.01 + 5e-3,
                "ok": True} for i in range(4)]
    probe = [{"t": float(i), "nbytes": 4096.0,
              "seconds": 0.01 + 4096.0 * 5e-9, "ok": True}
             for i in range(4)]
    assert tcost.fit_paired_link(payload, probe) == \
        jcost.fit_paired_link(payload, probe)


def test_flight_bundle_has_bounded_registry_section(tmp_path, registries):
    from geomx_tpu_torch.telemetry.flight import FlightRecorder
    fam = registries["port"].counter("geomx_many_total", "m", ("i",))
    for i in range(10):
        fam.labels(i=str(i)).inc()
    fr = FlightRecorder(capacity=4, dump_dir=str(tmp_path))
    fired = fr.record(1, {"grad_norm_global": float("nan")})
    assert fired and fr.dumps
    bundle = json.load(open(fr.dumps[0]))
    sec = bundle["registry"]["geomx_many_total"]
    assert len(sec["children"]) == 4 and sec["dropped_children"] == 6


def test_eventlog_rotation_counts_dropped_records(tmp_path, registries,
                                                  monkeypatch):
    """Both packages' logs rotate at the same byte bound and count the
    records a rotation discards the same way (the clock pinned, so the
    records have the same bytes)."""
    import time
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    counts = {}
    for pkg in PKGS:
        log = PKGS[pkg][0].EventLog(str(tmp_path / pkg / "e.jsonl"),
                                    max_bytes=400)
        for i in range(40):
            log.emit("tick", i=i)
        counts[pkg] = (log.rotations, log.dropped_records,
                       [e["kind"] for e in log.read()][:1],
                       len(log.read()))
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] > 1 and counts["port"][1] > 0
