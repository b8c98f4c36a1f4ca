"""Port parity: the reference's launch knobs.

``GeoConfig.from_env`` reads the sync algorithms' knobs
(``GEOMX_SYNC_MODE``, the HFA periods, MixedSync's pull interval and
DCASGD, ``GEOMX_PIPELINE_DEPTH``, the DGT wrap) and the sharded updates'
(``GEOMX_ZERO``, ``GEOMX_MULTI_GPS`` with ``GEOMX_BIGARRAY_BOUND`` or
``MXNET_KVSTORE_BIGARRAY_BOUND``) under the JAX package's names and
casts; ``get_sync_algorithm`` builds the same algorithm structure from
them and the Trainer binds the same sharded-update plan, raising the
JAX package's errors where it raises.  The eight telemetry knobs parse
to the JAX package's values and arm the same recorders.  The knob the
port does not run yet (``GEOMX_CONTROL``) is refused with
``NotImplementedError`` naming the ROADMAP.md Queue 1 item; a pipeline depth with one party only warns,
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
# variable, a value that changes the JAX step, the port's field, the item
REFUSED = [
    ("GEOMX_CONTROL", "1", "control", "Control"),
    ("GEOMX_CONTROL", "1.0", "control", "Control"),
]
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
    monkeypatch.setenv("GEOMX_NUM_PARTIES", "2")
    monkeypatch.setenv(var, value)
    ref = JaxConfig.from_env()
    # the reference reads the same value and runs another step for it
    jax_on = control_enabled(None) if field == "control" \
        else getattr(ref, field)
    assert jax_on
    with pytest.raises(NotImplementedError, match=f"'{item}'"):
        GeoConfig.from_env()
    # an override to the default is applied before the check
    cfg = GeoConfig.from_env(**{field: False if field in
                                ("zero", "multi_gps", "control") else 0})
    assert isinstance(get_sync_algorithm(cfg), FSA)


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
    """GEOMX_AUDIT acts only at membership or control swaps, which the
    port refuses on their own: the knob alone passes."""
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
