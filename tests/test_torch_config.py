"""Port parity: the reference's launch knobs that the port does not run yet.

``GeoConfig.from_env`` reads ``GEOMX_PIPELINE_DEPTH``, ``GEOMX_ENABLE_DGT``
/ ``ENABLE_DGT``, ``GEOMX_ZERO``, ``GEOMX_MULTI_GPS`` and ``GEOMX_CONTROL``
under the JAX package's names and casts, and refuses a value that changes
the JAX step with ``NotImplementedError`` naming the ROADMAP.md Queue 1
item; a pipeline depth with one party only warns, as the reference's
``get_sync_algorithm`` does; the defaults, set or not, still build FSA.
"""

import warnings

import pytest

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.control.actuators import control_enabled
from geomx_tpu_torch import GeoConfig
from geomx_tpu_torch.sync import FSA, get_sync_algorithm

KNOBS = ("GEOMX_PIPELINE_DEPTH", "GEOMX_ENABLE_DGT", "ENABLE_DGT",
         "GEOMX_ZERO", "GEOMX_MULTI_GPS", "GEOMX_CONTROL",
         "GEOMX_NUM_PARTIES")
# variable, a value that changes the JAX step, the port's field, the item
REFUSED = [
    ("GEOMX_PIPELINE_DEPTH", "1", "pipeline_depth", "Other sync algorithms"),
    ("GEOMX_PIPELINE_DEPTH", "2.0", "pipeline_depth",
     "Other sync algorithms"),
    ("GEOMX_ENABLE_DGT", "1", "enable_dgt", "Other sync algorithms"),
    ("ENABLE_DGT", "1", "enable_dgt", "Other sync algorithms"),
    ("GEOMX_ZERO", "1", "zero", "Sharded updates"),
    ("GEOMX_MULTI_GPS", "1", "multi_gps", "Sharded updates"),
    ("GEOMX_CONTROL", "1", "control", "Control"),
    ("GEOMX_CONTROL", "1.0", "control", "Control"),
]
DEFAULTS = [(var, value) for var in KNOBS[:-1] for value in ("0", "")] + [
    ("GEOMX_PIPELINE_DEPTH", "0.0"), ("GEOMX_ZERO", "0.0"),
    ("GEOMX_MULTI_GPS", "0.0"), ("GEOMX_CONTROL", "0.0")]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in KNOBS:
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


def test_pipeline_depth_with_one_party_only_warns(monkeypatch):
    monkeypatch.setenv("GEOMX_PIPELINE_DEPTH", "1")
    with pytest.warns(UserWarning, match="num_parties == 1"):
        cfg = GeoConfig.from_env()
    assert cfg.pipeline_depth == JaxConfig.from_env().pipeline_depth == 1
    assert isinstance(get_sync_algorithm(cfg), FSA)
    with pytest.raises(NotImplementedError, match="'Other sync algorithms'"):
        GeoConfig.from_env(num_parties=2)


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
