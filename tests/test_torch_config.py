"""Port parity: the reference's launch knobs.

``GeoConfig.from_env`` reads the sync algorithms' knobs
(``GEOMX_SYNC_MODE``, the HFA periods, MixedSync's pull interval and
DCASGD, ``GEOMX_PIPELINE_DEPTH``, the DGT wrap) and the sharded updates'
(``GEOMX_ZERO``, ``GEOMX_MULTI_GPS`` with ``GEOMX_BIGARRAY_BOUND`` or
``MXNET_KVSTORE_BIGARRAY_BOUND``) under the JAX package's names and
casts; ``get_sync_algorithm`` builds the same algorithm structure from
them and the Trainer binds the same sharded-update plan, raising the
JAX package's errors where it raises.  The eight telemetry knobs parse
to the JAX package's values and arm the same recorders; ``GEOMX_CONTROL``
arms the control plane in both packages and the ``GEOMX_CONTROL_*`` and
``GEOMX_FLEETSCOPE*`` knobs parse to the JAX package's values (no knob
is refused any more); a pipeline depth with one party only warns,
as the reference's ``get_sync_algorithm`` does; the defaults, set or
not, still build FSA.
"""

import os
import warnings

import optax
import pytest
from test_torch_train import FILTERS, STAGES

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.control.actuators import control_enabled
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.sync import (FSA, HFA, DGTCompressor, MixedSync,
                                  PipelinedSync, get_sync_algorithm)
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.train.zero import ZeroPlan

KNOBS = ("GEOMX_PIPELINE_DEPTH", "GEOMX_ENABLE_DGT", "ENABLE_DGT",
         "GEOMX_ZERO", "GEOMX_MULTI_GPS", "GEOMX_CONTROL",
         "GEOMX_NUM_PARTIES")
# every variable a test here sets
ENV = KNOBS + ("GEOMX_SYNC_MODE", "GEOMX_DCASGD", "GEOMX_DCASGD_LAMBDA",
               "GEOMX_HFA_K1", "DMLC_K1", "GEOMX_HFA_K2",
               "GEOMX_MIXED_PULL_INTERVAL", "GEOMX_PIPELINE_DCASGD",
               "GEOMX_DGT_BLOCK_SIZE", "DGT_BLOCK_SIZE", "DMLC_K",
               "DMLC_UDP_CHANNEL_NUM", "GEOMX_COMPRESSION",
               "GEOMX_WORKERS_PER_PARTY", "GEOMX_BIGARRAY_BOUND",
               "MXNET_KVSTORE_BIGARRAY_BOUND", "GEOMX_AUDIT")
# the JAX trainer's telemetry knobs: variable, a value that turns the
# knob on, the field, its default spelled in the environment
TELEMETRY = [
    ("GEOMX_TELEMETRY", "1", "telemetry", "0"),
    ("GEOMX_TELEMETRY_EVENTS", "events.jsonl", "telemetry_events", ""),
    ("GEOMX_FLIGHT", "1", "flight", "0.0"),
    ("GEOMX_FLIGHT_STEPS", "64", "flight_steps", "0"),
    ("GEOMX_FLIGHT_DIR", "flight", "flight_dir", ""),
    ("GEOMX_CAPSULE", "1", "capsule", "0"),
    ("GEOMX_CAPSULE_DIR", "capsules", "capsule_dir", ""),
    ("GEOMX_CAPSULE_SAMPLE_S", "2.5", "capsule_sample_s", "0.0"),
]
ENV += tuple(var for var, *_ in TELEMETRY)
# variable, a value that changes the JAX step, the port's field, the
# ROADMAP.md Queue 1 item that ported it
REFUSED = [
    ("GEOMX_CONTROL", "1", "control", "Control"),
    ("GEOMX_CONTROL", "1.0", "control", "Control"),
]
# the control plane's and FleetScope's knobs: variable, a value, the
# field, a value its cast rejects (None: a string knob)
CONTROL_KNOBS = [
    ("GEOMX_CONTROL_INTERVAL", "4", "control_interval", "2.5"),
    ("GEOMX_CONTROL_RATIO_BOUNDS", "0.001,0.01", "control_ratio_bounds",
     None),
    ("GEOMX_CONTROL_COOLDOWN", "3", "control_cooldown", "x"),
    ("GEOMX_FLEETSCOPE", "1", "fleetscope", "yes"),
    ("GEOMX_FLEETSCOPE_INTERVAL_S", "0.5", "fleetscope_interval_s", "fast"),
    ("GEOMX_FLEETSCOPE_BURN_WINDOWS", "30:2", "fleetscope_burn_windows",
     None),
]
ENV += tuple(var for var, *_ in CONTROL_KNOBS)
SERVE_KNOBS = [
    ("GEOMX_SERVE_PORT", "9090", "serve_port", "x"),
    ("GEOMX_SERVE_MAX_BATCH", "32.0", "serve_max_batch", "many"),
    ("GEOMX_SERVE_QUEUE_MS", "7.5", "serve_queue_ms", "soon"),
    ("GEOMX_SERVE_STALENESS_S", "30", "serve_staleness_s", "x"),
    ("GEOMX_SERVE_TIMEOUT_S", "12.5", "serve_timeout_s", "x"),
    ("GEOMX_SERVE_WARMUP", "0", "serve_warmup", "yes"),
    ("GEOMX_SERVE_NATIVE_WIRE", "0", "serve_native_wire", "no way"),
]
ENV += tuple(var for var, *_ in SERVE_KNOBS)
# the fields that configure nothing in the step (the host plane reads its
# own variables): variable, a value, the field — every alias of each
HOST_ONLY_KNOBS = [
    ("GEOMX_BSC_THRESHOLD", "0.05", "bsc_threshold"),
    ("GEOMX_SIZE_LOWER_BOUND", "1000", "size_lower_bound"),
    ("MXNET_KVSTORE_SIZE_LOWER_BOUND", "1000", "size_lower_bound"),
    ("GEOMX_ENABLE_P3", "1", "enable_p3"),
    ("ENABLE_P3", "1.0", "enable_p3"),
    ("GEOMX_P3_SLICE_ELEMS", "4096", "p3_slice_elems"),
    ("GEOMX_ENABLE_INTER_TS", "1", "enable_inter_ts"),
    ("ENABLE_INTER_TS", "1", "enable_inter_ts"),
    ("GEOMX_ENABLE_INTRA_TS", "1", "enable_intra_ts"),
    ("ENABLE_INTRA_TS", "1", "enable_intra_ts"),
    ("GEOMX_MAX_GREED_RATE", "0.5", "max_greed_rate"),
    ("MAX_GREED_RATE_TS", "0.75", "max_greed_rate"),
    ("GEOMX_HEARTBEAT_INTERVAL", "2.5", "heartbeat_interval_s"),
    ("PS_HEARTBEAT_INTERVAL", "3", "heartbeat_interval_s"),
]
ENV += tuple(var for var, *_ in HOST_ONLY_KNOBS)
DEFAULTS = [(var, value) for var in KNOBS[:-1] for value in ("0", "")] + [
    ("GEOMX_PIPELINE_DEPTH", "0.0"), ("GEOMX_ZERO", "0.0"),
    ("GEOMX_MULTI_GPS", "0.0"), ("GEOMX_CONTROL", "0.0")]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("var,value,field,item", REFUSED)
def test_knob_that_changes_the_step_raises(monkeypatch, var, value, field,
                                           item):
    """The knob that changes the JAX step is ported (ROADMAP.md Queue 1,
    ``item``): the port reads the same value and arms the same plane —
    the Trainer's control operands and ``apply_control`` — with the
    defaults still building FSA."""
    from geomx_tpu_torch.config import UNPORTED
    from geomx_tpu_torch.control import control_enabled as port_enabled
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    monkeypatch.setenv(var, value)
    ref = JaxConfig.from_env()
    # the reference reads the same value and runs another step for it
    assert control_enabled(None) and ref.control
    cfg = GeoConfig.from_env()
    assert getattr(cfg, field) == getattr(ref, field) is True
    assert port_enabled(cfg) and port_enabled(None)
    assert field not in UNPORTED
    assert isinstance(get_sync_algorithm(cfg), FSA)
    tr = Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 1), sgd(0.1),
                 config=GeoConfig.from_env(compression="bsc,0.01"),
                 device="cpu")
    state = tr.init_state(seed=0)
    assert tr._control and "control" in state.sync_state
    # an override to the default turns it off again, as in the reference
    monkeypatch.delenv(var)
    cfg = GeoConfig.from_env(**{field: False})
    assert not port_enabled(cfg) and not control_enabled(None)


@pytest.mark.parametrize("var,value,field,bad", CONTROL_KNOBS)
def test_control_and_fleetscope_knobs_parse_like_jax(monkeypatch, var,
                                                     value, field, bad):
    default = getattr(GeoConfig(), field)
    assert default == getattr(JaxConfig(), field)
    assert getattr(GeoConfig.from_env(), field) == default
    monkeypatch.setenv(var, value)
    got, want = getattr(GeoConfig.from_env(), field), \
        getattr(JaxConfig.from_env(), field)
    assert got == want and type(got) is type(want) and got != default
    if bad is not None:
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError, match=var):
            JaxConfig.from_env()
        with pytest.raises(ValueError, match=var):
            GeoConfig.from_env()


def _recorder(pkg, field, cfg):
    """What the knob ``field`` arms in package ``pkg`` ("jax" or "port"),
    as a comparable value: the probe gate, the trainer's event log, the
    flight recorder's ring and dump directory, the capsule's archive
    path and sampler cadence."""
    import importlib
    root = "geomx_tpu" if pkg == "jax" else "geomx_tpu_torch"
    tel = importlib.import_module(root + ".telemetry")
    if field == "telemetry":
        return tel.probes.telemetry_enabled(cfg)
    if field == "telemetry_events":
        log = tel.export.EventLog(cfg.telemetry_events)
        return os.path.abspath(log.path)
    if field.startswith("flight"):
        rec = tel.flight.flight_recorder_from_config(cfg)
        return rec is not None and (rec.capacity, rec.dump_dir)
    cap = tel.capsule.capsule_from_config(cfg)
    if cap is not None:
        cap.sampler.stop()
    return cap is not None and (cap.path, cap.sampler.interval_s)


@pytest.mark.parametrize("var,value,field,default", TELEMETRY)
def test_telemetry_knob_raises_naming_the_item(monkeypatch, tmp_path, var,
                                               value, field, default):
    """The knob this test once saw refused is ported: it parses to the
    JAX package's value under the JAX cast and arms the same recorder
    (with the switch a parameter knob needs)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(var, value)
    switch = {"flight_steps": "GEOMX_FLIGHT", "flight_dir": "GEOMX_FLIGHT",
              "capsule_dir": "GEOMX_CAPSULE",
              "capsule_sample_s": "GEOMX_CAPSULE"}.get(field)
    if switch:
        monkeypatch.setenv(switch, "1")
    ref = JaxConfig.from_env()
    cfg = GeoConfig.from_env()
    assert getattr(ref, field)     # the JAX trainer acts on it
    assert getattr(cfg, field) == getattr(ref, field)
    assert type(getattr(cfg, field)) is type(getattr(ref, field))
    armed = _recorder("port", field, cfg)
    assert armed and armed == _recorder("jax", field, ref)
    assert isinstance(get_sync_algorithm(cfg), FSA)


@pytest.mark.parametrize("var,value,field,default", TELEMETRY)
def test_telemetry_knob_at_default_passes(monkeypatch, var, value, field,
                                          default):
    monkeypatch.setenv(var, default)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = GeoConfig.from_env()
    assert getattr(cfg, field) == getattr(JaxConfig.from_env(), field)
    assert not getattr(cfg, field)
    assert isinstance(get_sync_algorithm(cfg), FSA)


def test_audit_is_not_refused(monkeypatch):
    """GEOMX_AUDIT arms the collective audit the Trainer runs at
    membership and depth swaps (tests/test_torch_analysis.py): the knob
    alone builds the same FSA."""
    monkeypatch.setenv("GEOMX_AUDIT", "1")
    assert JaxConfig.from_env().audit
    assert isinstance(get_sync_algorithm(GeoConfig.from_env()), FSA)


def test_pipeline_depth_with_one_party_only_warns(monkeypatch):
    monkeypatch.setenv("GEOMX_PIPELINE_DEPTH", "1")
    cfg = GeoConfig.from_env()
    assert cfg.pipeline_depth == JaxConfig.from_env().pipeline_depth == 1
    with pytest.warns(UserWarning, match="num_parties == 1"):
        algo = get_sync_algorithm(cfg)
    assert isinstance(algo, FSA)
    algo = get_sync_algorithm(GeoConfig.from_env(num_parties=2))
    assert isinstance(algo, PipelinedSync) and isinstance(algo.inner, FSA)


def structure(algo):
    """The algorithm's classes and their knobs, wrappers first, in the
    names both packages share."""
    out = [type(algo).__name__]
    for attr in ("inner", "k1", "k2", "pull_interval", "dcasgd_lambda",
                 "depth"):
        v = getattr(algo, attr, None)
        if v is not None:
            out.append((attr, structure(v) if attr == "inner" else v))
    dc = getattr(algo, "dc_compressor", None)
    while dc is not None:
        out.append(type(dc).__name__)
        out += [(a, getattr(dc, a)) for a in ("block_elems", "k", "alpha",
                                              "flush_every", "ratio")
                if hasattr(dc, a)]
        dc = getattr(dc, "inner", None)
    return out


# environment -> the port class it builds (every case: two parties)
KNOB_CASES = [
    ({"GEOMX_PIPELINE_DEPTH": "1"}, PipelinedSync),
    ({"GEOMX_PIPELINE_DEPTH": "1.0", "GEOMX_PIPELINE_DCASGD": "0.04"},
     PipelinedSync),
    ({"GEOMX_PIPELINE_DEPTH": "2.0"}, ValueError),
    ({"GEOMX_PIPELINE_DEPTH": "1", "GEOMX_SYNC_MODE": "hfa"}, ValueError),
    ({"GEOMX_PIPELINE_DEPTH": "1", "GEOMX_SYNC_MODE": "mixed",
      "GEOMX_DCASGD": "1"}, PipelinedSync),
    ({"GEOMX_ENABLE_DGT": "1"}, FSA),
    ({"ENABLE_DGT": "2", "GEOMX_COMPRESSION": "bsc,0.01",
      "DGT_BLOCK_SIZE": "4096", "DMLC_K": "0.8",
      "DMLC_UDP_CHANNEL_NUM": "3"}, FSA),
    ({"GEOMX_ENABLE_DGT": "1", "GEOMX_DGT_BLOCK_SIZE": "2",
      "GEOMX_SYNC_MODE": "hfa"}, HFA),
    ({"GEOMX_SYNC_MODE": "mixed"}, MixedSync),
    ({"GEOMX_SYNC_MODE": "dist_async", "GEOMX_DCASGD": "1",
      "GEOMX_DCASGD_LAMBDA": "0.1", "GEOMX_MIXED_PULL_INTERVAL": "3"},
     MixedSync),
    ({"GEOMX_SYNC_MODE": "async", "GEOMX_DCASGD": "0"}, MixedSync),
    ({"GEOMX_SYNC_MODE": "hfa", "GEOMX_HFA_K1": "4", "GEOMX_HFA_K2": "2"},
     HFA),
    ({"GEOMX_SYNC_MODE": "hfa", "DMLC_K1": "5"}, HFA),
    ({"GEOMX_SYNC_MODE": "hfa", "GEOMX_HFA_K1": "3", "DMLC_K1": "5"}, HFA),
    # the sharded updates: the Trainer binds the plan ("trainer" cases
    # build both packages' Trainers on four workers a party)
    ({"GEOMX_ZERO": "1"}, "trainer"),
    ({"GEOMX_ZERO": "1.0", "GEOMX_PIPELINE_DEPTH": "1",
      "GEOMX_SYNC_MODE": "mixed"}, "trainer"),
    ({"GEOMX_MULTI_GPS": "1", "GEOMX_BIGARRAY_BOUND": "1000"}, "trainer"),
    ({"GEOMX_MULTI_GPS": "1", "MXNET_KVSTORE_BIGARRAY_BOUND": "2048"},
     "trainer"),
    ({"GEOMX_MULTI_GPS": "1", "GEOMX_BIGARRAY_BOUND": "4096",
      "MXNET_KVSTORE_BIGARRAY_BOUND": "5"}, "trainer"),
    ({"GEOMX_ZERO": "1", "GEOMX_MULTI_GPS": "1"}, "trainer"),
]


@pytest.mark.parametrize("env,want", KNOB_CASES)
def test_knob_builds_the_reference_algorithm(monkeypatch, env, want):
    """Each environment configures both packages alike: the same fields,
    the same algorithm structure, or the same error."""
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    ref, cfg = JaxConfig.from_env(), GeoConfig.from_env()
    for field in ("sync_mode", "hfa_k1", "hfa_k2", "mixed_pull_interval",
                  "dcasgd", "dcasgd_lambda", "pipeline_depth",
                  "pipeline_dcasgd", "enable_dgt", "dgt_block_size", "dgt_k",
                  "dgt_k_min", "dgt_contri_alpha", "adaptive_k",
                  "udp_channel_num", "zero", "multi_gps", "bigarray_bound"):
        assert getattr(cfg, field) == getattr(ref, field), field
    if want == "trainer":
        return check_trainers(ref, cfg)
    if want is ValueError:
        with pytest.raises(ValueError) as jexc:
            jax_sync(ref)
        with pytest.raises(ValueError) as pexc:
            get_sync_algorithm(cfg)
        assert str(pexc.value) == str(jexc.value)
        return
    algo = get_sync_algorithm(cfg)
    assert isinstance(algo, want)
    assert structure(algo) == structure(jax_sync(ref))
    if cfg.enable_dgt:
        dc = algo.dc_compressor
        assert isinstance(dc, DGTCompressor)
        assert dc.block_elems == max(1, cfg.dgt_block_size // 4)
        assert (dc.k, dc.flush_every) == (cfg.dgt_k, cfg.udp_channel_num)


@pytest.mark.parametrize("var,value", [(None, None)] + DEFAULTS)
def test_defaults_build_fsa(monkeypatch, var, value):
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    if var is not None:
        monkeypatch.setenv(var, value)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = GeoConfig.from_env()
    ref = JaxConfig.from_env()
    for field in ("pipeline_depth", "enable_dgt", "zero", "multi_gps",
                  "control"):
        assert getattr(cfg, field) == getattr(ref, field), field
        assert not getattr(cfg, field)
    assert isinstance(get_sync_algorithm(cfg), FSA)


def test_bad_value_raises_like_the_reference(monkeypatch):
    monkeypatch.setenv("GEOMX_ZERO", "yes")
    with pytest.raises(ValueError, match="GEOMX_ZERO"):
        JaxConfig.from_env()
    with pytest.raises(ValueError, match="GEOMX_ZERO"):
        GeoConfig.from_env()


def check_trainers(ref, cfg):
    """Both packages' Trainers from the same config on [2, 4]: the same
    ZeRO plan (W, the bucket padding) or MultiGPS bound, or the same
    ValueError."""
    ref = JaxConfig(**{**vars(ref), "workers_per_party": 4})
    cfg = GeoConfig(**{**vars(cfg), "workers_per_party": 4})

    def build_jax():
        return JaxTrainer(FlaxResNet(stage_sizes=STAGES,
                                     stage_filters=FILTERS),
                          JaxTopology(2, 4), optax.sgd(0.1), config=ref)

    def build_port():
        return Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.1),
                       config=cfg, device="cpu")

    if cfg.zero and cfg.multi_gps:
        with pytest.raises(ValueError) as jexc:
            build_jax()
        with pytest.raises(ValueError) as pexc:
            build_port()
        assert str(pexc.value) == str(jexc.value)
        assert "GEOMX_ZERO does not compose with GEOMX_MULTI_GPS" in \
            str(pexc.value)
        return
    jt, pt = build_jax(), build_port()
    assert structure(pt.sync) == structure(jt.sync)
    if cfg.zero:
        assert isinstance(pt._zero_plan, ZeroPlan)
        assert pt._zero_plan.W == jt._zero_plan.W == 4
        assert pt._zero_plan.bucketed.pad_to == \
            jt._zero_plan.bucketed.pad_to == 512
        assert pt._mgps is None
    else:
        assert pt._zero_plan is None
        assert pt._mgps.bound == jt._mgps.bound == cfg.bigarray_bound
        assert pt._mgps.W == jt._mgps.W == 4


@pytest.mark.parametrize("var,value,field,bad", SERVE_KNOBS)
def test_serve_knob_read_alone_like_jax(monkeypatch, var, value, field,
                                        bad):
    """Each GEOMX_SERVE_* knob alone: the JAX default when unset, the
    JAX package's value and type when set, every other serve field left
    at its default, and a bad value refused naming the knob."""
    fields = [f for _v, _x, f, _b in SERVE_KNOBS]
    default = getattr(GeoConfig(), field)
    assert default == getattr(JaxConfig(), field)
    assert getattr(GeoConfig.from_env(), field) == default
    monkeypatch.setenv(var, value)
    cfg, ref = GeoConfig.from_env(), JaxConfig.from_env()
    got, want = getattr(cfg, field), getattr(ref, field)
    assert got == want and type(got) is type(want) and got != default
    for other in fields:
        if other != field:
            assert getattr(cfg, other) == getattr(GeoConfig(), other)
    monkeypatch.setenv(var, bad)
    with pytest.raises(ValueError, match=var):
        JaxConfig.from_env()
    with pytest.raises(ValueError, match=var):
        GeoConfig.from_env()


def test_config_fields_and_defaults_match_jax():
    """Both GeoConfigs carry the same fields with the same defaults."""
    import dataclasses

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(GeoConfig) == fields(JaxConfig)
    assert vars(GeoConfig.from_env()) == vars(JaxConfig.from_env())


@pytest.mark.parametrize("var,value,field", HOST_ONLY_KNOBS,
                         ids=[v for v, *_ in HOST_ONLY_KNOBS])
def test_host_only_knob_alias_parses_like_jax(monkeypatch, var, value,
                                              field):
    """Each alias of the fields that configure nothing in the step: the
    JAX package's value and type, away from the default, with every
    other field as unset and the default algorithm still built."""
    monkeypatch.setenv(var, value)
    cfg, ref = GeoConfig.from_env(), JaxConfig.from_env()
    got, want = getattr(cfg, field), getattr(ref, field)
    assert got == want and type(got) is type(want)
    assert got != getattr(GeoConfig(), field)
    assert vars(cfg) == vars(ref)
    assert isinstance(get_sync_algorithm(cfg), FSA)
