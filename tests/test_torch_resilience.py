"""Port parity: resilience (geomx_tpu_torch/resilience/ and the degraded
forms of the sync algorithms and the Trainer) against the JAX package,
as tests/test_resilience.py pins the JAX side.

Tolerances:

- bit for bit: the membership epochs, the chaos event lists (both
  packages draw from Python's ``random``), the survivor mean of FSA and
  MixedSync (the dead party's shard multiplies to exact zeros, and adding
  exact zeros is exact in both packages, with the dead party first, in
  the middle and last), the residual policies, the catch-up round trips;
- the Trainer cases: losses to rtol 1e-4, params to atol 2e-3, as
  ``tests/test_torch_sync.py`` states for three fp32 steps.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_sync import port, port_leaves
from test_torch_train import FILTERS, STAGES

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.resilience import ChaosEngine as JaxEngine
from geomx_tpu.resilience import ChaosSchedule as JaxSchedule
from geomx_tpu.resilience import PartyLivenessController as JaxController
from geomx_tpu.resilience.liveness import unpack_catchup as jax_unpack
from geomx_tpu.sync import FSA as JaxFSA
from geomx_tpu.sync import MixedSync as JaxMixed
from geomx_tpu.sync import PipelinedSync as JaxPipelined
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu.utils.metrics import Measure as JaxMeasure
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as port_optim
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.resilience import (ChaosEngine, ChaosSchedule,
                                        MembershipEpoch,
                                        PartyLivenessController)
from geomx_tpu_torch.resilience.liveness import pack_catchup, unpack_catchup
from geomx_tpu_torch.service import protocol
from geomx_tpu_torch.sync import FSA, HFA, MixedSync, PipelinedSync
from geomx_tpu_torch.topology import normalize_live_mask
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.tree import from_nested
from geomx_tpu_torch.utils.heartbeat import HeartbeatMonitor
from geomx_tpu_torch.utils.metrics import Measure

torch.set_num_threads(2)

BSC = "bsc,0.01,select=sampled"
CONTROLLERS = {"port": PartyLivenessController, "jax": JaxController}


# ---- PartyLivenessController: versioned membership epochs ------------------

def _epoch_walk(cls):
    """The transitions of test_resilience.py's epoch case; returns every
    epoch seen and the subscriber's versions."""
    c = cls(num_parties=3)
    seen, out = [], [c.epoch]
    c.subscribe(seen.append)
    for op, p in (("dead", 1), ("dead", 1), ("live", 1), ("dead", 0),
                  ("dead", 2), ("live", 0)):
        out.append(c.mark_dead(p) if op == "dead" else c.mark_live(p))
    return ([(e.version, e.live_mask, e.num_live, e.renorm_weight,
              e.live_parties(), e.all_live) for e in out],
            [e.version for e in seen])


def test_controller_epochs_match_jax():
    port_walk, jax_walk = _epoch_walk(PartyLivenessController), \
        _epoch_walk(JaxController)
    assert port_walk == jax_walk
    epochs, subs = port_walk
    assert epochs[1][:2] == (1, (True, False, True))
    assert epochs[2][0] == 1  # idempotent transition: no bump
    assert subs == [1, 2, 3, 4, 5]


def test_controller_telemetry_series():
    from geomx_tpu_torch.telemetry import get_registry
    reg = get_registry()

    def value(name, **labels):
        fam = reg.get(name)
        return (fam.labels(**labels) if labels else fam._solo()).value

    c = PartyLivenessController(num_parties=3)
    before = value("geomx_membership_transitions_total") \
        if reg.get("geomx_membership_transitions_total") else 0.0
    c.mark_dead(2)
    assert value("geomx_membership_version") == 1
    assert value("geomx_live_parties") == 2
    assert value("geomx_party_live", party="2") == 0.0
    assert value("geomx_party_live", party="0") == 1.0
    assert value("geomx_membership_transitions_total") == before + 1


@pytest.mark.parametrize("pkg", sorted(CONTROLLERS))
def test_controller_min_live_floor(pkg):
    c = CONTROLLERS[pkg](num_parties=2, min_live=1)
    c.mark_dead(0)
    with pytest.raises(RuntimeError, match="min_live"):
        c.mark_dead(1)
    assert c.epoch.live_mask == (False, True)
    with pytest.raises(ValueError):
        c.mark_dead(7)
    with pytest.raises(ValueError, match="min_live must be"):
        CONTROLLERS[pkg](num_parties=2, min_live=3)


def test_controller_consumes_heartbeats():
    """Party 1's node falls silent (its last beat moved 100 s into the
    past, against a 30 s timeout: no sleep, so a loaded host cannot
    change the verdict); its next beat re-admits the party."""
    mon = HeartbeatMonitor(timeout_s=30.0)
    c = PartyLivenessController(num_parties=2, monitor=mon)
    c.bind_party(0, 100)
    c.bind_party(1, 101)
    assert c.poll().all_live
    mon._last[101] = time.monotonic() - 100.0
    ep = c.poll()
    assert ep.live_mask == (True, False) and ep.version == 1
    mon.heartbeat(101)  # the node comes back
    ep = c.poll()
    assert ep.all_live and ep.version == 2


@pytest.mark.parametrize("pkg", sorted(CONTROLLERS))
def test_controller_consumes_external_dead_list(pkg):
    c = CONTROLLERS[pkg](num_parties=2)
    c.bind_party(0, 9)
    c.bind_party(1, 11)
    assert c.poll(dead_nodes=[11]).live_mask == (True, False)
    assert c.poll(dead_nodes=[]).all_live


# ---- chaos schedules ----------------------------------------------------------

SPECS = ["seed=7;blackout@3:party=1,steps=4;drop@10:rate=30,steps=5",
         "flap@5:party=0",
         "seed=1234;blackout@3:party=1,steps=3;flap@9:party=3",
         "kill@2:node=shard1,restart_after=1;restart@9:node=scheduler",
         "throttle@1:party=2,factor=0.125,steps=3;delay@2:party=1,ms=40,"
         "steps=2;corrupt@4:party=-1,rate=20,steps=2;dropclear@8;"
         "readmit@6:party=1;throttleclear@9:party=2;delayclear@9:party=1;"
         "corruptclear@9:party=0"]


def _events(sched):
    return [(e.step, e.kind, e.party, e.rate, e.factor, e.ms, e.node)
            for e in sched.events]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_matches_jax_and_round_trips(spec):
    s, j = ChaosSchedule.from_spec(spec), JaxSchedule.from_spec(spec)
    assert _events(s) == _events(j) and s.seed == j.seed
    assert s.spec() == j.spec()
    s2 = ChaosSchedule.from_spec(s.spec())
    assert s2.events == s.events and s2.seed == s.seed
    assert s.last_step == j.last_step


@pytest.mark.parametrize("bad,match", [
    ("explode@3:party=1", "unknown chaos kind"),
    ("blackout@3:rate=30", "does not take"),
    ("drop@3:rate=130", "not in"),
    ("throttle@3:party=1,factor=2", "not in"),
    ("kill@3:node=router", "node="),
    ("blackout3", "expected"),
    ("blackout@-1:party=0", "step must be"),
])
def test_chaos_spec_rejections_match_jax(bad, match):
    with pytest.raises(ValueError, match=match) as pexc:
        ChaosSchedule.from_spec(bad)
    with pytest.raises(ValueError) as jexc:
        JaxSchedule.from_spec(bad)
    assert str(pexc.value) == str(jexc.value)


RANDOM_ARGS = [
    dict(seed=42, steps=50, num_parties=4, blackouts=2, drop_epochs=1),
    dict(seed=43, steps=50, num_parties=4, blackouts=2, drop_epochs=1),
    dict(seed=5, steps=30, num_parties=16, blackouts=3, keep_party=2,
         node_kills=4, nodes=("shard0", "shard1", "scheduler"),
         corrupt_epochs=2, throttle_epochs=2),
    dict(seed=0, steps=8, num_parties=2, blackouts=0, node_kills=6,
         nodes=("server",), kill_restart_after=(2, 5)),
]


@pytest.mark.parametrize("i", range(len(RANDOM_ARGS)))
def test_chaos_random_equals_the_jax_list(i):
    a = ChaosSchedule.random(**RANDOM_ARGS[i])
    j = JaxSchedule.random(**RANDOM_ARGS[i])
    assert _events(a) == _events(j) and a.seed == j.seed
    assert a.events == ChaosSchedule.random(**RANDOM_ARGS[i]).events
    keep = RANDOM_ARGS[i].get("keep_party", 0)
    assert all(e.party != keep for e in a.events if e.kind == "blackout")


def test_chaos_engine_drives_controller_and_drop_hook():
    ctrl = PartyLivenessController(num_parties=2)
    sched = ChaosSchedule.from_spec(
        "seed=5;blackout@2:party=1,steps=2;drop@6:rate=40,steps=2;"
        "corrupt@6:party=1,rate=30,steps=1;throttle@6:party=0,"
        "factor=0.5,steps=1")
    with ChaosEngine(sched, ctrl) as eng:
        assert eng.tick(0) == []
        assert [e.kind for e in eng.tick(2)] == ["blackout"]
        assert ctrl.epoch.live_mask == (True, False)
        # skipped steps still apply their events
        kinds = [e.kind for e in eng.tick(7)]
        assert kinds == ["readmit", "corrupt", "drop_rate", "throttle",
                         "corrupt_clear", "throttle_clear"]
        assert ctrl.epoch.all_live
        assert protocol.drop_rate() == 40
        eng.tick(8)
        assert protocol.drop_rate() == 0
        assert eng.tick(8) == []
    assert protocol.drop_rate() == 0


def test_chaos_engine_reseeds_the_drop_rng_as_jax_does():
    from geomx_tpu.service import protocol as jproto
    draws = []
    for proto, engine, sched in ((protocol, ChaosEngine, ChaosSchedule),
                                 (jproto, JaxEngine, JaxSchedule)):
        with engine(sched.from_spec("seed=77;drop@1:rate=50"),
                    drive_drop_hook=True):
            draws.append([proto._drop_rng.random() for _ in range(5)])
    assert draws[0] == draws[1]


def test_chaos_lifecycle_hook_drives_kill_and_restart():
    from geomx_tpu_torch.resilience import chaos
    calls = []
    sched = ChaosSchedule.from_spec("kill@2:node=shard1,restart_after=1")
    eng = ChaosEngine(sched, drive_drop_hook=False)
    with pytest.raises(ValueError, match="lifecycle hook"):
        eng.tick(2)
    chaos.set_node_lifecycle_hook(lambda action, node:
                                  calls.append((action, node)))
    try:
        eng = ChaosEngine(sched, drive_drop_hook=False)
        for step in range(5):
            eng.tick(step)
    finally:
        chaos.set_node_lifecycle_hook(None)
    assert calls == [("kill", "shard1"), ("restart", "shard1")]
    assert chaos.shard_node_index("shard12") == 12
    assert chaos.shard_node_index("scheduler") is None


def test_drop_rate_override_wins_over_env(monkeypatch):
    monkeypatch.setenv("GEOMX_DROP_MSG", "15")
    assert protocol.drop_rate() == 15
    protocol.set_drop_rate_override(80)
    try:
        assert protocol.drop_rate() == 80
    finally:
        protocol.set_drop_rate_override(None)
    assert protocol.drop_rate() == 15


# ---- degraded-mode numerics ----------------------------------------------------

def _jax_sync_grads(sync, topo, g, state_fn=None):
    """``sync.sync_grads`` of the JAX package over the [P, W] replicas of
    ``g`` (numpy, leaves [P, W, ...]), returns numpy [P, W, ...]."""
    mesh = topo.build_mesh()
    gl0 = jax.tree.map(lambda a: a[0, 0], g)
    state = sync.init_state(gl0)

    def f(gs):
        gl = jax.tree.map(lambda a: a[0, 0], gs)
        out, _ = sync.sync_grads(gl, gl, state, jnp.zeros((), jnp.int32))
        return jax.tree.map(lambda a: a[None, None], out)

    fn = shard_map_compat(f, mesh, in_specs=(P(DC_AXIS, WORKER_AXIS),),
                          out_specs=P(DC_AXIS, WORKER_AXIS))
    return jax.device_get(jax.jit(fn)(g))


@pytest.mark.parametrize("parties,workers", [(3, 1), (3, 2), (4, 2)])
@pytest.mark.parametrize("dead", ["first", "middle", "last"])
def test_survivor_mean_bit_exact_against_jax(parties, workers, dead):
    """The load-bearing claim: the masked dc-tier aggregate holds the
    survivors' mean on every replica (the dead party's too) bit for bit,
    as the JAX package's does: adding the dead party's exact zeros in
    the parties' sequential sum (the order of both packages' party sum
    on the CPU) is exact.  With two survivors the output is the JAX
    output's bits.  With three, XLA on the CPU rewrites the division by
    3 into a multiply by fl(1/3) (ROADMAP.md Queue 3, "XLA's reciprocal
    multiply"): the JAX output is the same survivor sum times fl(1/3),
    the port's that sum divided by 3."""
    d = {"first": 0, "middle": parties // 2, "last": parties - 1}[dead]
    mask = tuple(p != d for p in range(parties))
    rng = np.random.RandomState(parties * 10 + d)
    g = {"w": rng.randn(parties, workers, 257).astype(np.float32),
         "b": rng.randn(parties, workers, 5).astype(np.float32)}
    g["w"][d, :, :7] = -g["w"][d, :, :7]  # signs of the dead shard mixed
    jtopo = JaxTopology(parties, workers)
    jfsa = JaxFSA(bucket_bytes=0).bind_topology(jtopo)
    jfsa.bind_membership(mask)
    jout = _jax_sync_grads(jfsa, jtopo, g)

    fsa = FSA(bucket_bytes=0).bind_topology(HiPSTopology(parties, workers))
    fsa.bind_membership(mask)
    nl = parties - 1
    assert fsa.num_live == jfsa.num_live == nl
    pg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    out, _ = fsa.sync_grads(pg, pg, fsa.init_state(pg), 0)
    for k in g:
        # the survivors' sum, party by party in order, of their
        # worker means
        wm = g[k].sum(1) / np.float32(workers) if workers > 1 \
            else g[k][:, 0]
        total = np.zeros_like(wm[0])
        for p in range(parties):
            if mask[p]:
                total = total + wm[p]
        for p in range(parties):
            for w in range(workers):
                assert out[k][p, w].numpy().tobytes() == \
                    (total / np.float32(nl)).tobytes(), (k, p, w)
                jexp = total / np.float32(nl) if nl == 2 \
                    else total * (np.float32(1) / np.float32(nl))
                assert np.ascontiguousarray(jout[k][p, w]).tobytes() == \
                    jexp.tobytes(), (k, p, w)
        if nl == 2:
            assert out[k].numpy().tobytes() == \
                np.ascontiguousarray(jout[k]).tobytes(), k
        # the survivors alone, as a run of nl parties: the same bits
        alone = FSA(bucket_bytes=0).bind_topology(
            HiPSTopology(nl, workers))
        sub = {kk: torch.from_numpy(v[list(np.flatnonzero(mask))].copy())
               for kk, v in g.items()}
        sout, _ = alone.sync_grads(sub, sub, alone.init_state(sub), 0)
        assert sout[k][0, 0].numpy().tobytes() == \
            out[k][0, 0].numpy().tobytes(), k


def test_survivor_mean_on_bsc_buckets_tracks_jax(mesh2x4, topo2x4):
    """The bucketed BSC path (kernels 1-4's plain versions on the CPU)
    with party 1 dead: the dead party's bucket is all +-0, and the
    aggregate of the survivors' k pairs matches the JAX package's."""
    from test_torch_sync import on_mesh, replica_values
    from geomx_tpu.compression import get_compressor as jax_comp
    from geomx_tpu_torch.compression import get_compressor
    rng = np.random.RandomState(3)
    g = replica_values(rng)
    jfsa = JaxFSA(dc_compressor=jax_comp(BSC)).bind_topology(topo2x4)
    jfsa.bind_membership((True, False))
    gl0 = jax.tree.map(lambda a: a[0, 0], g)
    jstate = jfsa.init_state(gl0)
    jout = jax.device_get(on_mesh(mesh2x4, lambda gl: jfsa.sync_grads(
        gl, gl, jstate, jnp.zeros((), jnp.int32))[0])(g))
    fsa = FSA(dc_compressor=get_compressor(BSC)).bind_topology(
        HiPSTopology(2, 4))
    fsa.bind_membership((True, False))
    pg = port(g)
    out, st = fsa.sync_grads(pg, pg, fsa.init_state(pg), 0)
    jflat = from_nested(jout)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), jflat[k], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(jflat[k]).max()),
                                   err_msg=k)
        assert torch.equal(v, v[:1, :1].expand_as(v)), k


def test_mixed_sync_degraded_mean_bit_exact():
    """MixedSync on [2, 1] with party 0 dead: the aggregate is party 1's
    gradient exactly, as in the JAX package."""
    jtopo = JaxTopology(2, 1)
    jms = JaxMixed(bucket_bytes=0).bind_topology(jtopo)
    jms.bind_membership((False, True))
    rng = np.random.RandomState(1)
    g = {"w": rng.randn(2, 1, 33).astype(np.float32)}
    jout = _jax_sync_grads(jms, jtopo, g)
    ms = MixedSync(bucket_bytes=0).bind_topology(HiPSTopology(2, 1))
    ms.bind_membership((False, True))
    pg = {"w": torch.from_numpy(g["w"].copy())}
    out, _ = ms.sync_grads(pg, pg, ms.init_state(pg), 0)
    assert np.array_equal(out["w"].numpy(), jout["w"])
    assert np.array_equal(out["w"][0, 0].numpy(), g["w"][1, 0])
    assert np.array_equal(out["w"][1, 0].numpy(), g["w"][1, 0])


@pytest.mark.parametrize("algo", ["fsa", "mixed", "pipelined"])
def test_model_state_survivor_mean_matches_jax(mesh2x4, topo2x4, algo):
    rng = np.random.RandomState(4)
    ms = {"mean": rng.randn(2, 4, 16).astype(np.float32)}
    mk = {"fsa": (FSA, JaxFSA), "mixed": (MixedSync, JaxMixed),
          "pipelined": (lambda: PipelinedSync(FSA()),
                        lambda: JaxPipelined(JaxFSA()))}[algo]
    jsync = mk[1]().bind_topology(topo2x4)
    jsync.bind_membership((False, True))
    jstate = jsync.init_state({"w": jnp.zeros(3)},
                              model_state={"mean": jnp.zeros(16)})

    def f(m):
        out, st = jsync.sync_model_state(m, jstate, jnp.zeros((), jnp.int32))
        return st["inflight_ms"] if algo == "pipelined" else out

    from test_torch_sync import on_mesh
    jout = jax.device_get(on_mesh(mesh2x4, f)(ms))
    psync = mk[0]().bind_topology(HiPSTopology(2, 4))
    psync.bind_membership((False, True))
    pms = {"mean": torch.from_numpy(ms["mean"].copy())}
    pstate = psync.init_state({"w": torch.zeros(2, 4, 3)},
                              model_state={"mean": torch.zeros(2, 4, 16)})
    out, st = psync.sync_model_state(pms, pstate, 0)
    got = st["inflight_ms"] if algo == "pipelined" else out
    assert np.array_equal(got["mean"].numpy(), jout["mean"])
    # every replica, the dead party's too, holds the survivor's mean
    assert torch.equal(got["mean"], got["mean"][:1, :1].expand(2, 4, 16))
    alone = torch.from_numpy(ms["mean"][1]).sum(0) / 4
    assert torch.equal(got["mean"][0, 0], alone)


# ---- through the Trainer ---------------------------------------------------------

def _trainers(mesh, jtopo, extra, jtx, ptx, parties=2, workers=4):
    cfg = dict(num_parties=parties, workers_per_party=workers,
               precision="fp32", **extra)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    jtopo, jtx, config=JaxConfig(**cfg), mesh=mesh,
                    donate=False)
    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(parties, workers), ptx,
                 config=GeoConfig(**cfg), device="cpu")
    return jt, pt


DEGRADED_PATHS = {
    "fused_sgd_bsc": (dict(compression=BSC, fused_optim=True),
                      lambda: optim_pallas.fused_optimizer(
                          "sgd", learning_rate=0.1, momentum=0.9),
                      lambda: port_optim.fused_optimizer(
                          "sgd", learning_rate=0.1, momentum=0.9)),
    "zero_sgd_bsc": (dict(compression=BSC, zero=True),
                     lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: sgd(0.1, momentum=0.9)),
    "mixed_none": (dict(sync_mode="mixed", mixed_pull_interval=2),
                   lambda: optax.sgd(0.05), lambda: sgd(0.05)),
}


@pytest.mark.parametrize("path", sorted(DEGRADED_PATHS))
def test_degraded_trainer_steps_track_jax_trainer(mesh2x4, topo2x4, path):
    """A full step, then party 1 dead for two steps (reset policy), from
    converted weights: losses to rtol 1e-4, params to atol 2e-3 against
    the JAX Trainer; the live-party metric; every replica identical."""
    extra, jtx, ptx = DEGRADED_PATHS[path]
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    jt, pt = _trainers(mesh2x4, topo2x4, extra, jtx(), ptx())
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    params, stats = from_flax(p0, s0)
    pst = pt.init_state(params=params, model_state=stats)
    jl, pl, jn, pn = [], [], [], []
    jb = list(jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0))
    pb = list(pt.make_loader(x, y, 8, seed=0).epoch(0))
    for i in range(3):
        if i == 1:
            jst = jt.apply_membership(jst, (True, False))
            pst = pt.apply_membership(pst, (True, False))
        jst, jm = jt.train_step(jst, *jb[i])
        pst, pm = pt.train_step(pst, *pb[i])
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
        jn.append(float(jm["num_live_parties"]))
        pn.append(float(pm["num_live_parties"]))
    print(f"{path}: losses port {pl} jax {jl}")
    assert pn == jn == [2.0, 1.0, 1.0]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    jp = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                  jst.params))
    for k, v in pst.params.items():
        np.testing.assert_allclose(v[0, 0].numpy(), jp[k], atol=2e-3,
                                   err_msg=k)
        assert torch.equal(v, v[:1, :1].expand_as(v)), k


def _port_trainer(sync=None, parties=2, workers=1, lr=0.05, **cfg):
    topo = HiPSTopology(parties, workers)
    t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32), topo,
                sgd(lr), sync=sync,
                config=GeoConfig(num_parties=parties,
                                 workers_per_party=workers,
                                 precision="fp32", **cfg),
                device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (parties, workers, 8, 16, 16, 3)).astype(
        np.uint8)
    y = rng.randint(0, 10, (parties, workers, 8)).astype(np.int64)
    return t, t.init_state(seed=0), torch.from_numpy(x), torch.from_numpy(y)


def test_degraded_step_equals_the_survivors_run():
    """A degraded [2, 1] step (party 1 dead) equals a [1, 1] run of the
    survivor from the same state: the survivors' mean is the survivor's
    gradient, bit for bit, and so are the metrics."""
    t, st, x, y = _port_trainer(FSA())
    _, m_full = t.train_step(st, x, y)
    assert float(m_full["num_live_parties"]) == 2.0
    st_deg = t.apply_membership(st, (True, False))
    s_deg, m_deg = t.train_step(st_deg, x, y)
    assert float(m_deg["num_live_parties"]) == 1.0
    solo, st1, _, _ = _port_trainer(FSA(), parties=1)
    s_solo, m_solo = solo.train_step(st1, x[:1], y[:1])
    for k, v in s_deg.params.items():
        assert np.array_equal(v[0, 0].numpy(), s_solo.params[k][0, 0].numpy())
        assert torch.equal(v[0, 0], v[1, 0]), k
    assert float(m_deg["loss"]) == float(m_solo["loss"])


def test_degraded_4x2_step_equals_the_3x2_survivors_run():
    """The configuration chip_smoke.py's survivor identity runs on the
    card, small: one degraded [4, 2] step (party 1 dead) under the dense
    dc tier with the fused SGD-momentum equals a [3, 2] run of the three
    survivors from the same state, bit for bit (the party sum adds the
    rows in order, so the dead party's zeros change no rounding)."""
    def trainer(parties):
        return Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                       HiPSTopology(parties, 2),
                       port_optim.fused_optimizer("sgd", learning_rate=0.1,
                                                  momentum=0.9),
                       config=GeoConfig(num_parties=parties,
                                        workers_per_party=2,
                                        compression="none",
                                        fused_optim=True, precision="fp32"),
                       device="cpu")
    from geomx_tpu_torch.train.state import unreplicate_tree
    t4, t3 = trainer(4), trainer(3)
    st4 = t4.init_state(seed=0)
    st3 = t3.init_state(params=unreplicate_tree(st4.params),
                        model_state=unreplicate_tree(st4.model_state))
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randint(0, 256, (4, 2, 4, 16, 16, 3))
                         .astype(np.uint8))
    y = torch.from_numpy(rng.randint(0, 10, (4, 2, 4)).astype(np.int64))
    st4 = t4.apply_membership(st4, (True, False, True, True))
    s4, m4 = t4.train_step(st4, x, y)
    s3, m3 = t3.train_step(st3, x[[0, 2, 3]], y[[0, 2, 3]])
    for k, v in s4.params.items():
        assert torch.equal(v, v[:1, :1].expand_as(v)), k
        assert v[0, 0].numpy().tobytes() == \
            s3.params[k][0, 0].numpy().tobytes(), k
    for k, v in s4.model_state.items():
        assert v[0, 0].numpy().tobytes() == \
            s3.model_state[k][0, 0].numpy().tobytes(), k
    assert float(m4["loss"]) == float(m3["loss"])


def test_dead_party_rows_select_exactly_k_like_jax():
    """A dead party's bucket under the reset policy: signed zeros with
    zero residuals.  Select/pack emits exactly k pairs, the k lowest
    indices (lax.top_k's order among equal magnitudes), bit for bit with
    the JAX package's jnp path and Pallas kernel in interpret mode."""
    from test_torch_bsc import assert_select_parity
    rng = np.random.RandomState(9)
    n = 5000
    g = np.where(rng.rand(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    z = np.zeros(n, np.float32)
    vals, idx, new_u, new_v = assert_select_parity(g, z, z, 0.01)
    k = 50
    assert np.array_equal(np.sort(idx.numpy()), np.arange(k))
    assert not new_u.any() and not new_v.any()


def test_apply_membership_caches_steps():
    t, st, _, _ = _port_trainer(FSA())
    full = t.train_step
    st = t.apply_membership(st, (True, False))
    deg = t.train_step
    assert deg is not full
    assert t.apply_membership(st, (True, False)) is st
    st = t.apply_membership(st, MembershipEpoch(2, (True, True)))
    assert t.train_step is full and t._membership_version == 2
    st = t.apply_membership(st, [True, False])
    assert t.train_step is deg and t.sync.num_live == 1


def _dc_float_leaves(sync_state):
    return [v for v in port_leaves(sync_state["dc_comp"])
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def test_residual_policies_match_jax():
    """BSC residuals across a membership change: "reset" zeroes them,
    "carry" keeps copy (0, 0) re-replicated, as the JAX package's
    round trip does; a bad policy raises before any rebind."""
    t, st, x, y = _port_trainer(FSA(dc_compressor=_bsc("bsc,0.25")))
    for _ in range(2):
        st, _ = t.train_step(st, x, y)
    pre = [v[0, 0].clone() for v in _dc_float_leaves(st.sync_state)]
    assert any(v.any() for v in pre), "no residuals accumulated"
    s_carry = t.apply_membership(st, (True, False), policy="carry")
    for a, b in zip(pre, _dc_float_leaves(s_carry.sync_state)):
        assert torch.equal(b, a.expand_as(b))
    s_carry = t.apply_membership(s_carry, (True, True), policy="carry")
    s_reset = t.apply_membership(s_carry, (True, False), policy="reset")
    assert not any(v.any() for v in _dc_float_leaves(s_reset.sync_state))
    s2, m = t.train_step(s_reset, x, y)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="unknown residual policy") as pexc:
        t.apply_membership(s2, (True, True), policy="discard")
    assert t.sync.live_parties == (True, False)  # not half switched
    jt = _jax_small_trainer()
    with pytest.raises(ValueError) as jexc:
        jt[0].apply_membership(jt[1], (True, False), policy="discard")
    assert str(pexc.value) == str(jexc.value)


def _bsc(spec):
    from geomx_tpu_torch.compression import get_compressor
    return get_compressor(spec)


def _jax_small_trainer(sync=None):
    topo = JaxTopology(2, 1)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32), topo, optax.sgd(0.05),
                    sync=sync or JaxFSA(), donate=False)
    x = np.zeros((2, 16, 16, 3), np.uint8)
    return jt, jt.init_state(jax.random.PRNGKey(0), x)


def test_pipelined_drain_under_mid_flight_loss():
    """The reset policy discards the in-flight aggregate launched under
    the old membership: the drain then applies a zero aggregate (params
    unchanged), and degraded pipelined training goes on."""
    t, st, x, y = _port_trainer(PipelinedSync(FSA()))
    for _ in range(2):
        st, _ = t.train_step(st, x, y)
    infl = st.sync_state["inner"]["dc_comp"]["inflight"]
    assert any(b.any() for b in infl), "pipeline never filled"
    st = t.apply_membership(st, (True, False), policy="reset")
    assert not any(b.any() for b in
                   st.sync_state["inner"]["dc_comp"]["inflight"])
    drained = t.drain_pipeline(st)
    for k, v in drained.params.items():
        assert torch.equal(v, st.params[k]), k
    s2, m = t.train_step(drained, x, y)
    assert np.isfinite(float(m["loss"]))
    assert float(m["num_live_parties"]) == 1.0


def test_pipelined_carry_drains_the_renormalized_aggregate():
    """"carry" keeps the in-flight aggregate; the drain divides it by the
    new survivor count (1 here: the aggregate summed over both parties
    is applied whole), so the drained params move by twice the
    all-live drain's step."""
    t, st, x, y = _port_trainer(PipelinedSync(FSA()))
    for _ in range(2):
        st, _ = t.train_step(st, x, y)
    full = t.drain_pipeline(st)
    deg = t.drain_pipeline(t.apply_membership(st, (True, False),
                                              policy="carry"))
    moved = False
    for k, v in deg.params.items():
        d_full = full.params[k] - st.params[k]
        d_deg = v - st.params[k]
        # to the rounding of the params themselves (|p| <= ~1: 2 ulp)
        np.testing.assert_allclose(d_deg.numpy(), 2 * d_full.numpy(),
                                   rtol=1e-5, atol=2.4e-7, err_msg=k)
        moved |= bool(d_deg.any())
        assert torch.isfinite(v).all()
    assert moved, "carry policy drained a zero aggregate"


# ---- re-admission catch-up ----------------------------------------------------------

def _assert_state_equal(a, b):
    for f in ("params", "opt_state", "model_state", "sync_state"):
        la, lb = port_leaves(getattr(a, f)), port_leaves(getattr(b, f))
        assert len(la) == len(lb), f
        for u, v in zip(la, lb):
            if isinstance(u, torch.Tensor):
                assert u.dtype == v.dtype and torch.equal(u, v), f
            else:
                assert u == v, f
    assert a.step == b.step


def test_catchup_payload_round_trip():
    """The blob a returning party installs restores the full state (its
    params, optimizer, model and sync state) bit for bit, and the
    admitted state trains."""
    t, st, x, y = _port_trainer(FSA(), lr=0.05)
    st, _ = t.train_step(st, x, y)
    blob = t.catchup_payload(st)
    assert isinstance(blob, bytes) and len(blob) > 1000
    restored = t.admit_party(blob)
    _assert_state_equal(st, restored)
    s2, m = t.train_step(restored, x, y)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("fused", [False, True])
def test_zero_catchup_keeps_every_worker_shard(fused):
    """Under ZeRO the payload keeps party 0's whole worker axis of the
    optimizer state and the dc-tier residuals: each worker slot gets its
    own shard back (copy (0, 0) would hand every worker worker 0's)."""
    tx = port_optim.fused_optimizer("sgd", learning_rate=0.1,
                                    momentum=0.9) if fused \
        else sgd(0.1, momentum=0.9)
    topo = HiPSTopology(2, 2)
    t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32), topo, tx,
                config=GeoConfig(num_parties=2, workers_per_party=2,
                                 precision="fp32", zero=True,
                                 compression=BSC, fused_optim=fused),
                device="cpu")
    st = t.init_state(seed=0)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(0, 256, (2, 2, 8, 16, 16, 3))
                         .astype(np.uint8))
    y = torch.from_numpy(rng.randint(0, 10, (2, 2, 8)).astype(np.int64))
    for _ in range(2):
        st, _ = t.train_step(st, x, y)
    opt = [v for v in port_leaves(st.opt_state)
           if isinstance(v, torch.Tensor)]
    assert not torch.equal(opt[0][:, 0], opt[0][:, 1])
    back = t.admit_party(t.catchup_payload(st))
    for u, v in zip(opt, [v for v in port_leaves(back.opt_state)
                          if isinstance(v, torch.Tensor)]):
        assert torch.equal(u, v)
    for u, v in zip(_dc_float_leaves(st.sync_state),
                    _dc_float_leaves(back.sync_state)):
        assert torch.equal(u[0], v[0]) and torch.equal(v[1], v[0])
    for k, v in st.params.items():
        assert torch.equal(v, back.params[k])
    s2, m = t.train_step(back, x, y)
    assert np.isfinite(float(m["loss"]))
    # the worker-count check raises the JAX package's message
    from geomx_tpu.train.zero import place_zero_state as jax_place
    from geomx_tpu_torch.train.zero import host_zero_state, place_zero_state
    host = host_zero_state(st)
    with pytest.raises(ValueError, match="re-shard") as pexc:
        place_zero_state(host, HiPSTopology(2, 4), "cpu")
    jtopo = JaxTopology(2, 4)
    with pytest.raises(ValueError) as jexc:
        jax_place(host, jtopo, jtopo.build_mesh())
    assert str(pexc.value) == str(jexc.value)
    # ZeRO + carry keeps the state untouched
    assert t.apply_membership(st, (True, False), policy="carry") is st


def test_pack_catchup_is_the_checkpoint_format_and_restores_jax_trees(
        tmp_path):
    from geomx_tpu.resilience.liveness import pack_catchup as jax_pack
    from geomx_tpu_torch.utils.checkpoint import save_checkpoint
    tree = {"a": np.arange(5, dtype=np.float32), "b": {"c": np.ones(3)},
            "n": 7}
    blob = pack_catchup(tree)
    path = save_checkpoint(str(tmp_path / "st"), tree)
    with open(path, "rb") as f:
        assert blob == f.read()
    # the restored trees agree across the packages (not the bytes: a JAX
    # blob of a training state pickles flax/optax classes)
    for back in (unpack_catchup(blob), jax_unpack(jax_pack(tree)),
                 jax_unpack(blob)):
        assert np.array_equal(back["a"], tree["a"])
        assert np.array_equal(back["b"]["c"], tree["b"]["c"])
        assert back["n"] == 7
    t, st, _, _ = _port_trainer(FSA())
    host = unpack_catchup(t.catchup_payload(st))
    tt = torch.tensor([[1.0]])
    back = unpack_catchup(pack_catchup({"w": tt}), target={"w": tt})
    assert torch.equal(back["w"], tt)
    assert set(host) == {"step", "params", "opt_state", "model_state",
                         "sync_state"}


# ---- refusals ------------------------------------------------------------------------

def test_hfa_rejects_a_degraded_mask_as_jax_does():
    from geomx_tpu.sync import HFA as JaxHFA
    hfa = HFA(k1=2, k2=2).bind_topology(HiPSTopology(2, 1))
    jhfa = JaxHFA(k1=2, k2=2).bind_topology(JaxTopology(2, 1))
    with pytest.raises(ValueError, match="does not support") as pexc:
        hfa.bind_membership((True, False))
    with pytest.raises(ValueError) as jexc:
        jhfa.bind_membership((True, False))
    assert str(pexc.value) == str(jexc.value)
    hfa.bind_membership((True, True))
    assert hfa.live_parties is None


def test_multigps_refuses_membership():
    t, st, _, _ = _port_trainer(FSA(), workers=2, multi_gps=True,
                                bigarray_bound=1000)
    assert t._mgps is not None
    with pytest.raises(ValueError, match="MULTI_GPS"):
        t.apply_membership(st, (True, False))
    # the step builder refuses a masked sync too, as the JAX one does
    from geomx_tpu_torch.train.step import build_train_step
    fsa = FSA().bind_topology(HiPSTopology(2, 2))
    fsa.bind_membership((True, False))
    with pytest.raises(ValueError, match="degraded") as pexc:
        build_train_step(t.loss_fn, sgd(0.1), fsa, HiPSTopology(2, 2),
                         GeoConfig(num_parties=2, workers_per_party=2,
                                   multi_gps=True))
    assert "GEOMX_MULTI_GPS does not compose with a degraded" in \
        str(pexc.value)


def test_audit_at_a_membership_swap_is_refused(monkeypatch):
    """GEOMX_AUDIT=1: a swap whose step diverges from the armed
    reference's collective program is refused with AuditError before
    anything is swapped (tests/test_torch_analysis.py covers the clean
    swaps)."""
    from geomx_tpu_torch.analysis import AuditError
    monkeypatch.setenv("GEOMX_AUDIT", "1")
    cfg = GeoConfig.from_env(num_parties=2, workers_per_party=1,
                             precision="fp32")
    assert cfg.audit == JaxConfig.from_env().audit is True
    t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                HiPSTopology(2, 1), sgd(0.05), config=cfg, device="cpu")
    st = t.init_state(seed=0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.rand(2, 1, 2, 16, 16, 3) * 255)
                         .astype(np.uint8))
    t._audit_capture(st, x, torch.zeros((2, 1, 2), dtype=torch.int64))
    ref_sig, ref_findings = t._audit_sigs[None]
    t._audit_sigs[None] = (ref_sig[1:], ref_findings)
    with pytest.raises(AuditError, match="GX-COLLECTIVE-002"):
        t.apply_membership(st, (True, False))
    assert t.sync.live_parties is None
    assert t.apply_membership(st, (True, True)) is st  # no swap


def test_mask_validation():
    with pytest.raises(ValueError, match="at least one live"):
        normalize_live_mask((False, False), 2)
    with pytest.raises(ValueError, match="entries"):
        normalize_live_mask((True,), 2)


# ---- config surface --------------------------------------------------------------

def test_resilience_env_knobs(monkeypatch):
    monkeypatch.setenv("GEOMX_RESILIENCE_RESIDUALS", "carry")
    monkeypatch.setenv("GEOMX_RESILIENCE_MIN_LIVE", "2")
    monkeypatch.setenv("GEOMX_CHAOS_SCHEDULE",
                       "seed=9;blackout@2:party=1,steps=2")
    monkeypatch.setenv("PS_HEARTBEAT_TIMEOUT", "7.5")
    cfg = GeoConfig.from_env(num_parties=3)
    jcfg = JaxConfig.from_env(num_parties=3)
    for f in ("resilience_residuals", "resilience_min_live",
              "chaos_schedule", "heartbeat_timeout_s", "audit",
              "audit_severity"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    sched = ChaosSchedule.from_config(cfg)
    assert sched.seed == 9 and sched.last_step == 4
    ctrl = PartyLivenessController.from_config(cfg)
    jctrl = JaxController.from_config(jcfg)
    assert (ctrl.min_live, ctrl.num_parties, ctrl.timeout_s) == \
        (jctrl.min_live, jctrl.num_parties, jctrl.timeout_s) == (2, 3, 7.5)
    ctrl.mark_dead(2)
    with pytest.raises(RuntimeError, match="min_live"):
        ctrl.mark_dead(1)
    assert ChaosSchedule.from_config(GeoConfig()) is None
    # the Trainer's default policy comes from the config
    t, st, x, y = _port_trainer(FSA(dc_compressor=_bsc("bsc,0.25")),
                                resilience_residuals="carry")
    st, _ = t.train_step(st, x, y)
    pre = [v[0, 0].clone() for v in _dc_float_leaves(st.sync_state)]
    st = t.apply_membership(st, (True, False))
    assert all(torch.equal(v[0, 0], a) for v, a in
               zip(_dc_float_leaves(st.sync_state), pre))


# ---- utils/metrics.py ------------------------------------------------------------

def test_measure_summary_and_dump_match_jax(tmp_path):
    recs = [dict(epoch=e, iteration=i, loss=1.0 / (i + 1), acc=0.1 * i,
                 flag=True, name="x", bad=float("nan"))
            for e in range(2) for i in range(5)]
    pm, jm = Measure(str(tmp_path / "p.json")), JaxMeasure()
    for r in recs:
        pm.add(**r)
        jm.add(**r)
    # the clocks differ; the rest of every record is the caller's
    for m in (pm, jm):
        for i, r in enumerate(m.records):
            r["time"] = 0.25 * i
    ps, js = pm.summary(), jm.summary()
    assert json.dumps(ps, sort_keys=True) == json.dumps(js, sort_keys=True)
    assert set(ps["percentiles"]) == {"loss", "acc"}
    assert Measure().summary() == JaxMeasure().summary() == \
        {"iterations": 0}
    path = pm.dump()
    with open(path) as f:
        doc = json.load(f)
    assert doc["summary"]["iterations"] == 10
    assert len(doc["records"]) == 10
    with pytest.raises(ValueError, match="no output path"):
        Measure().dump()
