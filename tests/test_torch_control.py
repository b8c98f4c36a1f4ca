"""Port parity: the control plane (geomx_tpu_torch/control/, the BSC
effective-k operand, ``Trainer.apply_control``) against the JAX
package's (geomx_tpu/control/), on the same inputs made with numpy from
a seed.

- policies: the decision JSON byte-identical over the same observation
  streams (the bounded ratio step, the EF floor, hysteresis on a noisy
  trace, cooldown, the sensor-poor fallback, the depth Schmitt trigger,
  the relay margin and release, ``SloPolicy``'s shed and route), the
  same constructor errors, ``GraftPilot.tick`` determinism and interval,
  ``from_config``;
- sensors: the same observation over the same registry, links and
  liveness;
- the operand: ``boundary_position`` under an integer tensor ``k``
  equal to the jitted JAX function's index for every ``eff_k`` in
  ``1..k`` (ResNet-20's bucket at ratio 0.01 and MLP buckets at 0.25),
  ``sampled_boundary_guv`` bit-equal; BSC ``compress`` under scales 1,
  0.5, 0.25, 0.125 bit-equal (values, indices, residuals) to the JAX
  sampled scan, the Pallas kernel in interpret mode and exact top-k
  (``u`` zero or signed powers of two: XLA contracts ``0.9 * u + g``
  into an FMA, exact only there);
- the Trainer: a ratio retune against the JAX Trainer (emitted share
  within 0.02 of the scale, ``control_ratio_scale`` in the probes, the
  step and ``_control_cache`` unchanged), the depth switch 0 -> 1 -> 0
  -> 1 (EF carried bit for bit, params within atol 2e-3, losses rtol
  1e-4, the cached step reused), the disabled path's ATen op sequence
  equal to a build whose ``control_operands`` raises, the rejections of
  ``apply_control``;
- the surfaces: ``DecisionLog`` bounds, the actuator's log, flight ring,
  registry text and event records equal to the JAX package's, the
  scheduler's ``GET /control``;
- replay: ``chip_smoke.py``'s port of ``bench.py --compare-control``,
  cut to 12 steps on the CPU, gives byte-identical decision logs twice,
  and its capsule replays to the live log (the JAX package's
  ``Capsule.sensors`` reading the same archive gives the same
  observations); its data and WAN model equal bench.py's.
"""

import dataclasses
import importlib
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import chip_smoke
import geomx_tpu.control.actuators as jact
import geomx_tpu_torch.control.actuators as tact
from geomx_tpu.compression import BiSparseCompressor as JaxBSC
from geomx_tpu.compression.bisparse import MOMENTUM
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models import MLP as FlaxMLP
from geomx_tpu.ops.bsc_pallas import sampled_boundary_guv as jax_guv
from geomx_tpu.ops.sampled_topk import boundary_position as jax_position
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.analysis import record_program
from geomx_tpu_torch.compression import BiSparseCompressor
from geomx_tpu_torch.models import MLP
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import bsc as bsc_ops
from geomx_tpu_torch.ops.sampled_topk import boundary_position
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.telemetry.probes import host_probes
from geomx_tpu_torch.train import Trainer

torch.set_num_threads(2)
PKGS = ("jax", "port")


def _mod(pkg: str, name: str):
    root = "geomx_tpu" if pkg == "jax" else "geomx_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _canon(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.fixture(autouse=True)
def _fresh_globals():
    for pkg in PKGS:
        _mod(pkg, "telemetry.registry").reset_registry()
        _mod(pkg, "control.actuators").reset_decision_log()
    yield
    for pkg in PKGS:
        _mod(pkg, "telemetry.registry").reset_registry()
        _mod(pkg, "control.actuators").reset_decision_log()


# ---- policies ---------------------------------------------------------------

def _link(party, bps, conf=1.0, peer="global"):
    return {f"{party}->{peer}": {
        "party": party, "peer": peer, "throughput_bps": bps,
        "rtt_s": 0.05, "loss_rate": 0.0, "samples": 3, "failures": 0,
        "bytes_total": bps, "age_s": 0.0, "confidence": conf,
        "stale": conf < 0.5}}


def _decide(pol, pkg, step, links=None, **kw):
    obs = _mod(pkg, "control.sensors").ControlObservation(
        step=step, links=links or {}, **kw)
    d = pol.decide(obs)
    return None if d is None else d.to_json()


MATCHED = dict(compute_s=0.05, dc_dense_bytes=1e6)


def _ratio_bounded(pkg, pol_mod):
    pol = pol_mod.RatioPolicy(0.25, bounds=(0.25 / 8, 0.25), cooldown=0,
                              step_limit=2.0, deadband=0.1)
    out = [_decide(pol, pkg, s, _link("party0", 1e6), **MATCHED)
           for s in range(8)]
    return out + [pol.current]


def _ratio_ef_floor(pkg, pol_mod):
    pol = pol_mod.RatioPolicy(0.25, cooldown=0, ef_unsafe=0.5)
    kw = dict(MATCHED, ef_residual_norm=10.0, grad_norm=1.0)
    out = [_decide(pol, pkg, 0, _link("party0", 1e6), **kw)]
    pol.current = 0.03125
    out.append(_decide(pol, pkg, 1, _link("party0", 1e9), **kw))
    return out


def _ratio_hysteresis(pkg, pol_mod):
    pol = pol_mod.RatioPolicy(0.25, cooldown=3, deadband=0.25)
    rng = np.random.RandomState(7)
    return [_decide(pol, pkg, s,
                    _link("party0", 2.4e6 * (1.0 + 0.15 * rng.randn())),
                    **MATCHED) for s in range(60)]


def _ratio_cooldown(pkg, pol_mod):
    pol = pol_mod.RatioPolicy(0.25, cooldown=5, deadband=0.0,
                              step_limit=1.01)
    return [_decide(pol, pkg, s, _link("party0", 1e5), **MATCHED)
            for s in range(30)]


def _ratio_fallback(pkg, pol_mod):
    pol = pol_mod.RatioPolicy(0.25, cooldown=0)
    return [_decide(pol, pkg, s, exposed_comms=e)
            for s, e in enumerate((0.4, 0.5, 0.1, 0.02, None, 0.01))]


def _depth_schmitt(pkg, pol_mod):
    pol = pol_mod.DepthPolicy(enter=0.4, exit=0.2, confirm=2, cooldown=0)
    seq = [(0.6, None), (0.6, None), (0.3, None), (0.3, None), (0.0, 0.5),
           (0.0, 0.5), (0.05, 0.05), (0.05, 0.05), (None, None)]
    out = [_decide(pol, pkg, s, exposed_comms=e, hidden_comms=h)
           for s, (e, h) in enumerate(seq)]
    pol1 = pol_mod.DepthPolicy(enter=0.4, exit=0.2, confirm=1, cooldown=0,
                               initial=1)
    out.append(_decide(pol1, pkg, 0, exposed_comms=0.05, hidden_comms=0.05))
    cool = pol_mod.DepthPolicy(enter=0.4, exit=0.2, confirm=1, cooldown=3)
    out += [_decide(cool, pkg, s, exposed_comms=e)
            for s, e in enumerate((0.9, 0.01, 0.01, 0.01, 0.01))]
    return out


def _relay_margin(pkg, pol_mod):
    pol = pol_mod.RelayPolicy(min_gain=2.0, cooldown=0, min_confidence=0.5)
    even = {**_link("party0", 4e6), **_link("party1", 3.9e6),
            **_link("party2", 4.1e6)}
    band = {**_link("party0", 7.6e6), **_link("party1", 4e6)}
    skewed = {**_link("party0", 8e6), **_link("party1", 1e6),
              **_link("party2", 4e6)}
    lowconf = {**_link("party0", 8e6, conf=0.2),
               **_link("party1", 1e6, conf=0.2)}
    out = [_decide(pol, pkg, s, links) for s, links in
           enumerate((even, band, skewed, band, even, lowconf, skewed))]
    return out + [list(pol.current), pol.release]


def _slo_shed_route(pkg, pol_mod):
    stats = [None]
    pol = pol_mod.SloPolicy(lambda: stats[0], target_p99_s=0.5, confirm=2,
                            cooldown=1, shed_step=0.25, shed_max=0.5)
    p99s = [None, 0.8, 0.9, 0.9, 0.9, 0.9, 0.4, 0.1, 0.1, 0.1, 0.1, 0.1]
    out = []
    for s, p99 in enumerate(p99s):
        stats[0] = None if p99 is None else {"p99_s": p99}
        links = _link("party1", 5e6) if s < 6 else \
            {**_link("party1", 5e6), **_link("party2", 9e6)}
        out.append(_decide(pol, pkg, s, links))
    return out + [pol.current, pol.route]


SCENARIOS = {f.__name__[1:]: f for f in (
    _ratio_bounded, _ratio_ef_floor, _ratio_hysteresis, _ratio_cooldown,
    _ratio_fallback, _depth_schmitt, _relay_margin, _slo_shed_route)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_match_jax(name):
    runs = {pkg: SCENARIOS[name](pkg, _mod(pkg, "control.policy"))
            for pkg in PKGS}
    assert _canon(runs["port"]) == _canon(runs["jax"])
    decisions = [d for d in runs["port"] if isinstance(d, dict)]
    assert decisions, "the scenario fires no decision"
    if name == "ratio_bounded":
        assert [d["value"] for d in decisions[:2]] == [0.125, 0.0625]
    if name == "ratio_hysteresis":
        assert len(decisions) <= 4
    if name == "ratio_cooldown":
        steps = [d["step"] for d in decisions]
        assert all(b - a >= 5 for a, b in zip(steps, steps[1:]))


BAD_POLICIES = [
    ("RatioPolicy", (0,), {}), ("RatioPolicy", (0.25,), {"bounds": (0.3, 0.2)}),
    ("RatioPolicy", (0.25,), {"bounds": (0.1, 0.5)}),
    ("RatioPolicy", (0.25,), {"target_alpha": 0.0}),
    ("DepthPolicy", (), {"enter": 0.3, "exit": 0.3}),
    ("DepthPolicy", (), {"initial": 2}),
    ("RelayPolicy", (), {"min_gain": 2.0, "release": 2.5}),
    ("SloPolicy", (None,), {"target_p99_s": 0.0}),
    ("SloPolicy", (None,), {"target_p99_s": 0.5, "release_p99_s": 0.6}),
    ("GraftPilot", (None,), {}),
]


@pytest.mark.parametrize("cls,args,kw", BAD_POLICIES)
def test_policy_constructor_errors_match_jax(cls, args, kw):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            getattr(_mod(pkg, "control.policy"), cls)(*args, **kw)


class _NoRegistry:
    def get(self, name):
        return None


def _fed_observatory(pkg):
    obs = _mod(pkg, "telemetry.links").LinkObservatory(stale_after_s=30.0)
    for party, bps in (("party0", 8e6), ("party1", 1e6), ("party2", 4e6)):
        for i in range(3):
            obs.observe(party, "global", nbytes=bps, seconds=1.0,
                        t=100.0 + i)
    return obs


def _tick_run(pkg):
    ctl, pol = _mod(pkg, "control.sensors"), _mod(pkg, "control.policy")
    sensors = ctl.ControlSensors(observatory=_fed_observatory(pkg),
                                 registry=_NoRegistry(),
                                 compute_s_fn=lambda s: 0.05)
    pilot = pol.GraftPilot(sensors, ratio=pol.RatioPolicy(0.25, cooldown=1),
                           depth=pol.DepthPolicy(cooldown=1),
                           relay=pol.RelayPolicy(min_gain=2.0, cooldown=1),
                           interval=2)
    out = []
    for step in range(10):
        out.extend(d.to_json() for d in pilot.tick(step, now=103.0))
    return out, pilot.decisions_made


def test_pilot_tick_is_deterministic_and_interval_gated():
    port, jax_ = _tick_run("port"), _tick_run("jax")
    assert _canon(port) == _canon(jax_) == _canon(_tick_run("port"))
    assert port[0] and all(d["step"] % 2 == 0 for d in port[0])


@pytest.mark.parametrize("bounds", ["", "0.01,0.2", "0.1"])
def test_pilot_from_config_matches_jax(bounds):
    kw = dict(num_parties=2, control_ratio_bounds=bounds, control_cooldown=3,
              control_interval=4, pipeline_depth=1)
    cfgs = {"jax": JaxConfig(**kw), "port": GeoConfig(**kw)}
    out = {}
    for pkg in PKGS:
        pol = _mod(pkg, "control.policy")
        try:
            pilot = pol.GraftPilot.from_config(cfgs[pkg], None, 0.25)
        except ValueError as e:
            out[pkg] = ("ValueError", "GEOMX_CONTROL_RATIO_BOUNDS" in str(e))
            continue
        ratio, depth, relay = pilot.policies
        out[pkg] = (pilot.interval, ratio.bounds, ratio.cooldown.steps,
                    depth.current, depth.cooldown.steps, relay.cooldown.steps)
    assert out["port"] == out["jax"]
    if bounds == "0.1":
        assert out["port"] == ("ValueError", True)


# ---- sensors ----------------------------------------------------------------

class _Liveness:
    class epoch:
        version = 4
        live_mask = (True, False, True)
        num_live = 2


def _observe(pkg):
    reg = _mod(pkg, "telemetry.registry").reset_registry()
    fam = reg.gauge("geomx_step_probe", "probe", ("probe",))
    for name, v in (("ef_residual_norm", 0.5), ("grad_norm_global", 2.0),
                    ("dc_dense_bytes", 1e6), ("dc_wire_bytes", 2e4),
                    ("bsc_emitted_fraction", 0.75),
                    ("control_ratio_scale", 0.5),
                    ("dc_nonzero_fraction", 0.01)):
        fam.labels(probe=name).set(v)
    ph = reg.gauge("geomx_phase_fraction", "phase", ("phase",))
    for name, v in (("exposed_comms", 0.3), ("hidden_comms", 0.1),
                    ("compute", 0.55), ("host_stall", 0.05)):
        ph.labels(phase=name).set(v)
    fl = reg.gauge("geomx_fleet_rollup", "fleet", ("field",))
    for name, v in (("qps", 150.0), ("shed_rate", 0.05),
                    ("replica_staleness_max_s", 0.25),
                    ("burn_rate_max", 3.0), ("propagation_p99_s", 1.5),
                    ("nodes_dead", 1.0)):
        fl.labels(field=name).set(v)
    sensors = _mod(pkg, "control.sensors").ControlSensors(
        observatory=_fed_observatory(pkg), registry=reg, liveness=_Liveness(),
        min_confidence=0.5, compute_s_fn=lambda s: 0.05)
    return [dataclasses.asdict(sensors.observe(s, now=now))
            for s, now in ((7, 103.0), (8, 400.0))]


def test_sensors_fold_like_jax():
    port = _observe("port")
    assert _canon(port) == _canon(_observe("jax"))
    obs = port[0]
    assert obs["ratio_scale"] == 0.5 and obs["emitted_fraction"] == 0.75
    assert obs["fleet_nodes_dead"] == 1 and obs["live_mask"] == \
        (True, False, True)
    assert len(obs["links"]) == 3 and port[1]["links"] == {}


# ---- the effective-k operand ------------------------------------------------

BUCKETS = [(272512, 2726), (262144, 65536), (34442, 8611)]


@pytest.mark.parametrize("n,k", BUCKETS)
def test_boundary_position_tensor_k_matches_jitted_jax(n, k):
    m = min(n, 8192)
    ks = np.arange(1, k + 1, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda kk: jax_position(m, kk, n)))(jnp.asarray(ks)))
    got = boundary_position(m, torch.from_numpy(ks), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # a Python int keeps the static path (Python's round, a plain int)
    assert boundary_position(m, int(k), n) == jax_position(m, int(k), n)


def pow2(rng, n, zero_frac=0.2):
    """Signed powers of two (and zeros): 0.9 * u is exact in fp32."""
    u = np.ldexp(1.0, -rng.randint(0, 10, n)).astype(np.float32)
    u *= rng.choice([-1.0, 1.0], n).astype(np.float32)
    u[rng.rand(n) < zero_frac] = 0.0
    return u


def _guv_inputs(n, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, n).astype(np.float32), pow2(rng, n),
            rng.normal(0, 0.2, n).astype(np.float32))


@pytest.mark.parametrize("n,k", BUCKETS[:2])
def test_sampled_boundary_guv_tensor_k_matches_jax(n, k):
    g, u, v = _guv_inputs(n)
    fn = jax.jit(lambda a, b, c, kk: jax_guv(a, b, c, kk))
    tg, tu, tv = (torch.from_numpy(x) for x in (g, u, v))
    pos = bsc_ops.probe_positions(n)
    for kk in sorted({1, 2, k // 8, k // 2, k - 1, k} |
                     set(range(1, k, max(1, k // 40)))):
        want = np.asarray(fn(g, u, v, jnp.int32(kk)))
        got = bsc_ops.sampled_boundary_guv(
            tg, tu, tv, torch.tensor(kk, dtype=torch.int32), positions=pos)
        assert got.numpy().tobytes() == want.tobytes(), kk


SCALES = [1.0, 0.5, 0.25, 0.125]


def _jax_compress(select, n, ratio, g, u, v, scale):
    if select == "fused":
        comp = JaxBSC(ratio, select="sampled", fused=True,
                      fused_interpret=True, min_sparse_size=1)
    else:
        comp = JaxBSC(ratio, select=select, fused=False, min_sparse_size=1)

    def run(a, b, c, s):
        with jact.control_operands({"bsc_ratio_scale": s}):
            return comp.compress(a, b, c)

    return [np.asarray(x) for x in
            jax.jit(run)(g, u, v, jnp.float32(scale))]


@pytest.mark.parametrize("select", ["sampled", "fused", "exact"])
@pytest.mark.parametrize("scale", SCALES)
def test_compress_under_scale_matches_jax(select, scale):
    n, ratio = 20000, 0.01
    g, u, v = _guv_inputs(n, seed=5)
    want = _jax_compress(select, n, ratio, g, u, v, scale)
    comp = BiSparseCompressor(ratio, min_sparse_size=1,
                              select="exact" if select == "exact"
                              else "sampled")
    sink = []
    with tact.control_operands(
            {"bsc_ratio_scale": torch.tensor(scale, dtype=torch.float32)}):
        from geomx_tpu_torch.telemetry import probes
        with probes.inline_collection() as sink:
            got = comp.compress(*(torch.from_numpy(x) for x in (g, u, v)))
    for name, a, b in zip(("vals", "idx", "u", "v"), got, want):
        assert a.numpy().tobytes() == b.tobytes(), name
    k = comp.k_for(n)
    emitted = int((got[1] >= 0).sum())
    (_, frac), = sink
    assert float(frac) == float(np.float32(emitted / k))
    if select == "exact":
        assert emitted == round(k * scale)
    # the mass of the unemitted slots stays in the residual
    dense = np.zeros(n, np.float32)
    keep = got[1].numpy() >= 0
    dense[got[1].numpy()[keep]] = got[0].numpy()[keep]
    corrected = v + (u * np.float32(MOMENTUM) + g)
    np.testing.assert_allclose(dense + got[3].numpy(), corrected, atol=1e-6)


def test_no_context_adds_no_op():
    """Without a control context compress runs the static path (the
    operand is never read)."""
    assert tact.current_ratio_scale() is None
    with tact.control_operands({"bsc_ratio_scale": torch.tensor(0.5)}):
        assert float(tact.current_ratio_scale()) == 0.5
        with tact.control_operands({"bsc_ratio_scale": torch.tensor(0.25)}):
            assert float(tact.current_ratio_scale()) == 0.25
        assert float(tact.current_ratio_scale()) == 0.5
    assert tact.current_ratio_scale() is None


# ---- the Trainer ------------------------------------------------------------

SPEC = "bsc,0.25,min_sparse_size=16"


def _trainers(control=True, telemetry=True, **extra):
    """The JAX package's control test trainer (an MLP on [2, 1], exact
    top-k, its CPU default) and the port's from its weights."""
    cfg = dict(num_parties=2, workers_per_party=1, telemetry=telemetry,
               control=control, **extra)
    jcfg = JaxConfig(compression=SPEC, **cfg)
    jt = JaxTrainer(FlaxMLP(num_classes=10, hidden=(32,)),
                    JaxTopology(num_parties=2, workers_per_party=1),
                    optax.sgd(0.05), sync=jax_sync(jcfg), config=jcfg,
                    donate=False)
    pt = Trainer(MLP(num_classes=10, hidden=(32,)), HiPSTopology(2, 1),
                 sgd(0.05), config=GeoConfig(
                     compression=SPEC + ",select=exact", precision="fp32",
                     **cfg), device="cpu")
    return jt, pt


def _batches(n=8):
    rng = np.random.RandomState(0)
    x = (rng.rand(n, 2, 1, 4, 8, 8, 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, size=(n, 2, 1, 4)).astype(np.int32)
    return x, y


def _start(jt, pt, x):
    jst = jt.init_state(jax.random.PRNGKey(0), x[0, 0, 0, :2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    pst = pt.init_state(params=from_flax(p0)[0], sample_input=x[0, 0, 0, :2])
    return jst, pst


def _steps(jt, pt, jst, pst, x, y, i):
    sharding = jt.topology.batch_sharding(jt.mesh)
    jst, jm = jt.train_step(jst, jax.device_put(x[i], sharding),
                            jax.device_put(y[i], sharding))
    pst, pm = pt.train_step(pst, torch.from_numpy(x[i]),
                            torch.from_numpy(y[i].astype(np.int64)))
    return jst, pst, jm, pm


def _assert_params_close(jst, pst):
    from geomx_tpu_torch.models.convert import from_nested
    jparams = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                       jst.params))
    for k, v in pst.params.items():
        np.testing.assert_allclose(v[0, 0].numpy(), jparams[k], atol=2e-3,
                                   err_msg=k)
        assert torch.equal(v, v[:1, :1].expand_as(v)), k


def test_ratio_retune_matches_jax_trainer():
    from geomx_tpu.control import Decision as JaxDecision
    from geomx_tpu_torch.control import Decision
    x, y = _batches()
    jt, pt = _trainers()
    jst, pst = _start(jt, pt, x)
    for i in range(2):
        jst, pst, jm, pm = _steps(jt, pt, jst, pst, x, y, i)
    assert host_probes(pm["telemetry"])["bsc_emitted_fraction"] == 1.0
    step_fn, operand = pt.train_step, \
        pst.sync_state["control"]["bsc_ratio_scale"]
    jst = jt.apply_control(jst, JaxDecision(step=2, kind="ratio",
                                            value=0.0625, prev=0.25,
                                            reason="test"))
    pst = pt.apply_control(pst, Decision(step=2, kind="ratio", value=0.0625,
                                         prev=0.25, reason="test"))
    # written in place: the same 0-d tensor, no new step
    assert pst.sync_state["control"]["bsc_ratio_scale"] is operand
    assert operand.dim() == 0 and float(operand) == 0.25
    jst, pst, jm, pm = _steps(jt, pt, jst, pst, x, y, 2)
    jp = jax.device_get(jm["telemetry"])
    pp = host_probes(pm["telemetry"])
    assert pp["bsc_emitted_fraction"] == pytest.approx(0.25, abs=0.02)
    assert pp["bsc_emitted_fraction"] == float(jp["bsc_emitted_fraction"])
    assert pp["control_ratio_scale"] == 0.25 == \
        float(jp["control_ratio_scale"])
    assert pt.train_step is step_fn and pt._control_cache == {}
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    _assert_params_close(jst, pst)


def test_depth_switch_matches_jax_trainer():
    """0 -> 1 -> 0 -> 1: the dc-tier EF carried bit for bit (copy (0, 0)
    into every slot, as the JAX package's swap carries it), the drain
    at 1 -> 0, the cached step reused on the second 0 -> 1; losses and
    params against the JAX Trainer."""
    from geomx_tpu.control import Decision as JaxDecision
    from geomx_tpu.sync.pipeline import PipelinedSync as JaxPipelined
    from geomx_tpu_torch.control import Decision
    from geomx_tpu_torch.sync import PipelinedSync
    x, y = _batches()
    jt, pt = _trainers()
    jst, pst = _start(jt, pt, x)
    losses = []
    plan = {3: 1, 5: 0, 7: 1}
    for i in range(8):
        if i in plan:
            value = plan[i]
            if value == 1:
                ef_p = [t.clone() for t in _leaves(pst.sync_state["dc_comp"])]
                ef_j = [np.asarray(a) for a in
                        jax.tree.leaves(jst.sync_state["dc_comp"])]
            kw = dict(step=i, kind="depth", value=value, prev=1 - value,
                      reason="test")
            jst = jt.apply_control(jst, JaxDecision(**kw))
            pst = pt.apply_control(pst, Decision(**kw))
            assert pt.control_depth() == jt.control_depth() == value
            assert isinstance(pt.sync, PipelinedSync) == bool(value)
            assert isinstance(jt.sync, JaxPipelined) == bool(value)
            if value == 1:
                after = _leaves(pst.sync_state["inner"]["dc_comp"]["inner"])
                jafter = jax.tree.leaves(
                    jst.sync_state["inner"]["dc_comp"]["inner"])
                assert len(after) == len(ef_p) == len(jafter) > 0
                for a, b, ja, jb in zip(after, ef_p, jafter, ef_j):
                    assert torch.equal(a, b[:1, :1].expand_as(b))
                    np.testing.assert_array_equal(np.asarray(ja)[0, 0],
                                                  jb[0, 0])
                    np.testing.assert_allclose(a[0, 0].numpy(), jb[0, 0],
                                               atol=2e-3)
            if i == 7:
                assert pt.train_step is pt._control_cache[(1, None)]
                assert jt.train_step is jt._control_cache[(1, None)]
        jst, pst, jm, pm = _steps(jt, pt, jst, pst, x, y, i)
        losses.append((float(pm["loss"]), float(jm["loss"])))
        assert "control" in pst.sync_state
    assert sorted(pt._control_cache) == sorted(jt._control_cache)
    np.testing.assert_allclose(*zip(*losses), rtol=1e-4)
    _assert_params_close(jst, pst)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _port_ops(control, x, y):
    pt = Trainer(MLP(num_classes=10, hidden=(32,)), HiPSTopology(2, 1),
                 sgd(0.05), config=GeoConfig(
                     num_parties=2, workers_per_party=1, compression=SPEC,
                     precision="fp32", control=control), device="cpu")
    st = pt.init_state(seed=0, sample_input=x[:2])
    return record_program(pt.train_step, st,
                          torch.from_numpy(x).reshape(2, 1, 4, 8, 8, 3),
                          torch.from_numpy(y).reshape(2, 1, 4)).ops()


def test_disabled_control_dispatches_the_same_ops(monkeypatch):
    """The port's form of the JAX package's byte-identical-jaxpr pin:
    with control off the step dispatches the ATen op sequence of a build
    whose control_operands raises (the sampled route, kernels 1-4's
    plain versions)."""
    monkeypatch.delenv("GEOMX_CONTROL", raising=False)
    rng = np.random.RandomState(0)
    x = (rng.rand(8, 8, 8, 3) * 255).astype(np.uint8)
    y = rng.randint(0, 10, size=8).astype(np.int64)
    ops_off = _port_ops(False, x, y)

    def poison(*a, **k):
        raise AssertionError("control hook ran on the disabled path")

    monkeypatch.setattr(tact, "control_operands", poison)
    assert _port_ops(False, x, y) == ops_off
    monkeypatch.undo()
    ops_on = _port_ops(True, x, y)
    assert len(ops_on) > len(ops_off)


REJECTIONS = {
    "control_off": (dict(control=False), "ratio", 0.1, ValueError,
                    "GEOMX_CONTROL"),
    "unknown_kind": (dict(), "relay", (), ValueError, "ratio | depth"),
    "ratio_without_bsc": (dict(compression="none"), "ratio", 0.1,
                          ValueError, "ratio-bearing"),
    "depth_under_zero": (dict(zero=True), "depth", 1, ValueError,
                         "GEOMX_ZERO"),
    "depth_bad_value": (dict(), "depth", 2, ValueError, "0 or 1"),
    # the audit at a depth switch does not change its rejections
    "depth_under_audit": (dict(audit=True, zero=True), "depth", 1,
                          ValueError, "GEOMX_ZERO"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_apply_control_rejections(case):
    from geomx_tpu_torch.control import Decision
    fields, kind, value, exc, match = REJECTIONS[case]
    cfg = dict(num_parties=2, workers_per_party=1, compression=SPEC,
               control=True)
    cfg.update(fields)
    pt = Trainer(MLP(num_classes=10, hidden=(32,)), HiPSTopology(2, 1),
                 sgd(0.05), config=GeoConfig(**cfg), device="cpu")
    st = pt.init_state(seed=0, sample_input=np.zeros((2, 8, 8, 3),
                                                     np.uint8))
    with pytest.raises(exc, match=match):
        pt.apply_control(st, Decision(step=0, kind=kind, value=value,
                                      prev=None, reason="r"))
    # the JAX Trainer raises the same type and message
    from geomx_tpu.control import Decision as JaxDecision
    jcfg = JaxConfig(**cfg)
    jt = JaxTrainer(FlaxMLP(num_classes=10, hidden=(32,)),
                    JaxTopology(num_parties=2, workers_per_party=1),
                    optax.sgd(0.05), sync=jax_sync(jcfg), config=jcfg,
                    donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0),
                        np.zeros((2, 8, 8, 3), np.uint8))
    with pytest.raises(exc, match=match):
        jt.apply_control(jst, JaxDecision(step=0, kind=kind, value=value,
                                          prev=None, reason="r"))


def test_depth_with_one_party_warns_like_jax():
    from geomx_tpu_torch.control import Decision
    pt = Trainer(MLP(num_classes=10, hidden=(32,)), HiPSTopology(1, 1),
                 sgd(0.05), config=GeoConfig(compression=SPEC, control=True),
                 device="cpu")
    st = pt.init_state(seed=0, sample_input=np.zeros((2, 8, 8, 3),
                                                     np.uint8))
    with pytest.warns(RuntimeWarning, match="num_parties=1"):
        assert pt.apply_control(st, Decision(step=0, kind="depth", value=1,
                                             prev=0, reason="r")) is st
    assert pt.control_depth() == 0


def test_control_knob_arms_the_trainer(monkeypatch):
    """GEOMX_CONTROL=1 alone arms it; the config pins it, so the steps a
    depth switch builds later carry the operands too."""
    monkeypatch.setenv("GEOMX_CONTROL", "1")
    pt = Trainer(MLP(num_classes=10, hidden=(32,)), HiPSTopology(2, 1),
                 sgd(0.05), config=GeoConfig.from_env(
                     num_parties=2, compression=SPEC), device="cpu")
    st = pt.init_state(seed=0, sample_input=np.zeros((2, 8, 8, 3),
                                                     np.uint8))
    assert pt.config.control and "control" in st.sync_state
    op = st.sync_state["control"]["bsc_ratio_scale"]
    assert op.dtype == torch.float32 and op.dim() == 0 and float(op) == 1.0


# ---- surfaces ---------------------------------------------------------------

def test_decision_log_bounds_like_jax():
    out = {}
    for pkg in PKGS:
        act = _mod(pkg, "control.actuators")
        log = act.DecisionLog(capacity=3)
        for i in range(5):
            log.append({"step": i, "kind": "ratio", "value": i})
        out[pkg] = (log.snapshot(), log.total)
        assert act.reset_decision_log().snapshot() == []
        assert act.get_decision_log() is act.get_decision_log()
        with pytest.raises(ValueError):
            act.DecisionLog(capacity=0)
    assert out["port"] == out["jax"]
    assert [e["step"] for e in out["port"][0]] == [2, 3, 4]


class _StubTrainer:
    _flight = None

    def __init__(self):
        self.calls = []

    def apply_control(self, state, decision):
        self.calls.append(decision.kind)
        return state


def _actuate(pkg, tmp_path):
    reg = _mod(pkg, "telemetry.registry").reset_registry()
    flight = _mod(pkg, "telemetry.flight").FlightRecorder(capacity=8,
                                                          dump_dir="")
    events = _mod(pkg, "telemetry.export").EventLog(
        str(tmp_path / f"{pkg}.jsonl"))
    act = _mod(pkg, "control.actuators")
    pol = _mod(pkg, "control.policy")
    log = act.DecisionLog()
    orders, trainer = [], _StubTrainer()
    actuator = act.ControlActuator(trainer=trainer, relay_apply=orders.append,
                                   flight=flight, log=log, event_log=events)
    for d in (pol.Decision(4, "relay", ("party1", "party0"), (), "test"),
              pol.Decision(5, "ratio", 0.1, 0.25, "lower"),
              pol.Decision(6, "depth", 1, 0, "enter")):
        assert actuator.apply("state", d) == "state"
    with pytest.raises(ValueError, match="unknown decision kind"):
        actuator.apply(None, pol.Decision(7, "bogus", 1, 0, "r"))
    bare = act.ControlActuator(log=act.DecisionLog())
    with pytest.raises(ValueError, match="trainer-bound"):
        bare.apply(None, pol.Decision(8, "ratio", 0.1, 0.2, "r"))
    text = _mod(pkg, "telemetry.export").render_prometheus(reg)
    recs = [{k: v for k, v in e.items() if k != "ts"}
            for e in events.read()]
    return (log.snapshot(), flight.decisions(), text, recs, orders,
            trainer.calls)


def test_actuator_surfaces_match_jax(tmp_path):
    port = _actuate("port", tmp_path)
    assert _canon(port) == _canon(_actuate("jax", tmp_path))
    log, ring, text, recs, orders, calls = port
    assert [e["kind"] for e in log] == ["relay", "ratio", "depth"]
    assert ring == log and orders == [["party1", "party0"]]
    assert calls == ["ratio", "depth"]
    assert 'geomx_control_decisions_total{kind="relay"} 1' in text
    assert "geomx_control_pipeline_depth 1" in text
    assert [r["kind"] for r in recs] == ["control_decision"] * 3
    assert recs[0]["decision_kind"] == "relay"


def test_scheduler_serves_control_like_jax():
    from geomx_tpu.service.scheduler import GeoScheduler as JaxScheduler
    from geomx_tpu_torch.service.scheduler import GeoScheduler
    entry = {"step": 3, "kind": "depth", "value": 1, "prev": 0,
             "reason": "wan_fraction 0.5 > enter 0.25"}
    bodies = {}
    for pkg, cls in (("jax", JaxScheduler), ("port", GeoScheduler)):
        _mod(pkg, "control.actuators").reset_decision_log().append(entry)
        sched = cls(port=0, metrics_port=0).start()
        try:
            url = f"http://127.0.0.1:{sched.metrics_port}/control"
            with urllib.request.urlopen(url, timeout=10) as r:
                bodies[pkg] = (r.status, json.loads(r.read()))
        finally:
            sched.stop()
    assert bodies["port"] == bodies["jax"]
    status, body = bodies["port"]
    assert status == 200 and body["total"] == 1
    assert body["decisions"] == [entry] and body["capacity"] == 256


# ---- replay -------------------------------------------------------------------

REPLAY_STEPS = 12


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """chip_smoke.py's controller replay cut to 12 steps on the CPU, run
    twice, the first with a run capsule."""
    wan_kw, _ = chip_smoke.control_wan(torch, "cpu")
    ratio = chip_smoke.CONTROL_REPLAY["ratio_hi"]
    bounds = (ratio / 8.0, ratio)
    cap = str(tmp_path_factory.mktemp("capsule") / "capsule.json")
    runs = [chip_smoke._control_run(
        torch, ratio, 0, wan_kw, controller=True, ratio_bounds=bounds,
        device="cpu", capsule_path=cap if i == 0 else None,
        steps=REPLAY_STEPS) for i in range(2)]
    return runs, ratio, bounds


def test_controller_replay_logs_are_byte_identical(replay):
    (a, b), _, _ = replay
    assert a["decisions"], "no decision in the replay"
    assert {d["kind"] for d in a["decisions"]} >= {"depth", "relay"}
    assert _canon(a["decisions"]) == _canon(b["decisions"])
    assert [r["t"] for r in a["timeline"]] == [r["t"] for r in b["timeline"]]


def test_capsule_replay_reproduces_the_live_log(replay):
    from geomx_tpu.telemetry.capsule import Capsule as JaxCapsule
    from geomx_tpu_torch.telemetry.capsule import Capsule
    (a, _), ratio, bounds = replay
    cap = Capsule.load(a["capsule"])
    assert cap.decisions == a["decisions"]
    replayed = cap.replay_decisions(
        lambda s: chip_smoke.control_pilot(s, ratio, bounds),
        min_confidence=0.5, compute_s_fn=lambda s: 0.05)
    assert _canon(replayed) == _canon(a["decisions"])
    # the JAX package's sensors over the same archive observe the same
    jsens = JaxCapsule(cap.doc).sensors(compute_s_fn=lambda s: 0.05)
    psens = cap.sensors(compute_s_fn=lambda s: 0.05)
    for rec in cap.steps:
        assert _canon(dataclasses.asdict(psens.observe(
            rec["step"], now=rec["t"]))) == _canon(dataclasses.asdict(
                jsens.observe(rec["step"], now=rec["t"])))


def test_replay_helpers_are_the_benchmarks(monkeypatch):
    """chip_smoke.py's data generator, WAN model and calibration equal
    bench.py's (the port's wire accounting gives the JAX package's bytes
    for the MLP at 0.25 in 1 MiB buckets)."""
    from geomx_tpu.compression.bisparse import BiSparseCompressor as JB
    from geomx_tpu.compression.bucketing import BucketedCompressor as JBk
    from geomx_tpu.service import protocol as jproto
    from geomx_tpu_torch.service import protocol as tproto
    for a, b in zip(chip_smoke.control_make_data(),
                    bench._control_make_data()):
        assert a.tobytes() == b.tobytes()
    _, hi_bytes = chip_smoke.control_wan(torch, "cpu")
    model = FlaxMLP(num_classes=10)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3), jnp.uint8),
        train=False))["params"]
    assert hi_bytes == float(JBk(JB(ratio=0.25),
                                 bucket_bytes=1 << 20).wire_bytes(shapes))
    kw = dict(num_parties=3, base_bps=3e8, p2p_bps=2.4e9,
              base_delay_s=0.01, compute_s=0.05)
    port, ref = chip_smoke.WanModel(**kw), bench._WanModel(**kw)
    try:
        for proto in (jproto, tproto):
            proto.set_link_shaping_override(1, factor=0.125, delay_ms=300)
        for routes in ((), (0, 2, 1), (2, 0, 1)):
            for depth in (0, 1):
                assert port.step_seconds(1.6e6, depth, routes) == \
                    ref.step_seconds(1.6e6, depth, routes)
    finally:
        jproto.clear_link_shaping_overrides()
        tproto.clear_link_shaping_overrides()
