"""Port parity: the other sync algorithms (geomx_tpu_torch vs geomx_tpu on
the conftest 2x4 mesh): DCASGD, MixedSync, HFA, the DGT compressor and
the pipelined WAN sync with its drain, module by module and through the
Trainer.

Tolerances:

- bit for bit where the inputs make every op exact or singly rounded
  the same way in both packages: signed powers of two (dyadic values),
  differences of the weights that are powers of two, so each product
  is exact;
- rtol 1e-6 where a compressor's state carries a rounded value into a
  later multiply-add (BSC's ``u = 0.9 u + g``, DGT's ``contri`` EWMA):
  XLA contracts such a multiply-add into an FMA on the CPU and the port
  rounds the product on its own (ROADMAP.md Queue 3, "FMA
  contraction"), with an atol of 1e-6 of the tensor's largest magnitude
  where ``0.9 u + g`` cancels to near zero;
- the Trainer cases: losses to rtol 1e-4, params to atol 2e-3, as
  ``test_three_fp32_steps_track_jax_trainer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_train import FILTERS, STAGES

from geomx_tpu.compression import get_compressor as jax_compressor
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas
from geomx_tpu.optim.dcasgd import dcasgd as jax_dcasgd
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.sync import FSA as JaxFSA
from geomx_tpu.sync import HFA as JaxHFA
from geomx_tpu.sync import DGTCompressor as JaxDGT
from geomx_tpu.sync import MixedSync as JaxMixed
from geomx_tpu.sync import PipelinedSync as JaxPipelined
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.sync.pipeline import PipelinedCompressor as JaxPipelinedComp
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu.train.state import replicate_tree as jax_replicate
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.compression import NoCompressor, get_compressor
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as port_optim
from geomx_tpu_torch.optim import adam, dcasgd, get_optimizer, sgd
from geomx_tpu_torch.sync import (FSA, HFA, DGTCompressor, MixedSync,
                                  PipelinedSync, get_sync_algorithm)
from geomx_tpu_torch.sync.pipeline import PipelinedCompressor
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.tree import from_nested, leaf_names

torch.set_num_threads(2)

BSC = "bsc,0.01,select=sampled"
REPLICA = P(DC_AXIS, WORKER_AXIS)
# a small parameter tree: 1,818 elements, one bucket of 1,920, BSC k = 20
SHAPES = {"conv": {"bias": (16,), "kernel": (3, 3, 8, 16)},
          "dense": {"bias": (10,), "kernel": (64, 10)}}
TOPO = HiPSTopology(2, 4)


# ---- helpers ----------------------------------------------------------------

def nested(fn):
    """A tree of SHAPES with ``fn(shape)`` at each leaf."""
    return {m: {k: fn(s) for k, s in d.items()} for m, d in SHAPES.items()}


def powers(rng, shape, lo=0, hi=12, zeros=0.3):
    """Signed powers of two 2^-lo .. 2^-(hi-1), a share of them zero."""
    x = np.ldexp(1.0, -rng.randint(lo, hi, shape)).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], shape).astype(np.float32)
    x[rng.rand(*shape) < zeros] = 0.0
    return x


def replica_values(rng, same_in_party=False, **kw):
    """A ``[2, 4, *shape]`` tree of powers of two, per replica or per
    party (identical across a party's workers)."""
    def leaf(s):
        if same_in_party:
            return np.repeat(powers(rng, (2, 1) + s, **kw), 4, axis=1)
        return powers(rng, (2, 4) + s, **kw)
    return nested(leaf)


def broadcast(tree):
    """One replica's tree copied to ``[2, 4, ...]`` (numpy)."""
    return jax.tree.map(
        lambda a: np.ascontiguousarray(np.broadcast_to(a, (2, 4) + a.shape)),
        tree)


def port(tree):
    """A nested numpy tree -> the port's flat dict of tensors."""
    return {k: torch.from_numpy(np.array(v))
            for k, v in from_nested(tree).items()}


def port_leaves(x):
    """The port state's tensors in ``jax.tree.leaves`` order."""
    if isinstance(x, dict):
        return [t for k in leaf_names(x) for t in port_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in port_leaves(v)]
    return [x]


def assert_tree_equal(jtree, ptree, exact=True, what=""):
    jl = [np.asarray(a) for a in jax.tree.leaves(jtree)]
    pl = [t.numpy() for t in port_leaves(ptree)]
    assert len(jl) == len(pl), (what, len(jl), len(pl))
    for i, (a, b) in enumerate(zip(jl, pl)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        if exact or a.dtype != np.float32:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} leaf {i}")
        else:
            scale = float(np.abs(a).max()) if a.size else 0.0
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=f"{what} leaf {i}")


def on_mesh(mesh, fn):
    """``jit(shard_map(fn))`` over ``[2, 4, ...]`` inputs: ``fn`` sees one
    replica's values and returns a tree of them."""
    def device(*args):
        out = fn(*jax.tree.map(lambda a: a[0, 0], args))
        return jax.tree.map(lambda a: a[None, None], out)
    return jax.jit(shard_map_compat(device, mesh, in_specs=REPLICA,
                                    out_specs=REPLICA))


def steps_array(step):
    return np.full((2, 4), step, np.int32)


def weights(t, w0, delta):
    """w_t = w0 + t * delta: each difference of two is a power of two
    (or zero) for t <= 3, so DCASGD's product is exact."""
    return jax.tree.map(lambda a, d: (a + t * d).astype(np.float32), w0,
                        delta)


def weight_walk(rng):
    w0 = nested(lambda s: powers(rng, s, 0, 6, zeros=0.0))
    delta = nested(lambda s: np.float32(2.0 ** -12)
                   * rng.choice([-1.0, 1.0], s).astype(np.float32))
    return w0, delta


# ---- DCASGD -----------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_dcasgd_update_bit_equal(momentum, weight_decay):
    """From the init state and from a mid-run state of powers of two
    (previous weights w/2, 2w or w, so ``w - pw`` is a power of two):
    new params, momentum and previous weights bit for bit."""
    rng = np.random.RandomState(1)
    lr, lam = 0.0625, 0.04
    jtx = jax_dcasgd(lr, momentum=momentum, lamda=lam,
                     weight_decay=weight_decay)
    ptx = dcasgd(lr, momentum=momentum, lamda=lam,
                 weight_decay=weight_decay)
    assert isinstance(get_optimizer("dcasgd", lr), type(ptx))

    @jax.jit
    def jstep(g, st, w):
        upd, st2 = jtx.update(g, st, w)
        return optax.apply_updates(w, upd), st2

    w = nested(lambda s: powers(rng, s, 0, 6, zeros=0.0))
    mid = jtx.init(w)._replace(
        momentum=nested(lambda s: powers(rng, s)),
        previous_weights=jax.tree.map(
            lambda a: a * rng.choice([0.5, 2.0, 1.0], a.shape)
            .astype(np.float32), w))
    for jst in (jtx.init(w), mid):
        g = nested(lambda s: powers(rng, s))
        pst = {"momentum": port(jst.momentum),
               "previous_weights": port(jst.previous_weights)}
        jw, jst2 = jstep(g, jst, w)
        pw, pst2 = ptx.update(port(g), pst, port(w))
        assert_tree_equal(jw, pw, what="params")
        assert_tree_equal(jst2, pst2, what="state")


# ---- MixedSync ----------------------------------------------------------------

@pytest.mark.parametrize("pull", [1, 2])
@pytest.mark.parametrize("lam", [0.0, 0.04])
@pytest.mark.parametrize("dc", ["none", BSC])
def test_mixed_sync_tracks_jax(mesh2x4, topo2x4, pull, lam, dc):
    """sync_grads, the stale copy and the dc state over 3 steps.  With
    DCASGD each party's workers hold one gradient (a power of two), so
    ``lam * g * g`` is exact."""
    rng = np.random.RandomState(3)
    cfg = dict(num_parties=2, workers_per_party=4, compression=dc,
               sync_mode="mixed", dcasgd=lam > 0, mixed_pull_interval=pull)
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo2x4)
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(TOPO)
    assert isinstance(jsync, JaxMixed) and isinstance(psync, MixedSync)
    assert psync.dcasgd_lambda == jsync.dcasgd_lambda == lam
    w0, delta = weight_walk(rng)
    jstate = jax_replicate(jsync.init_state(w0), topo2x4, mesh2x4)
    pstate = psync.init_state(port(broadcast(w0)))
    assert_tree_equal(jstate, pstate, what="init")

    def device(g, w, w_next, st, step):
        out, st = jsync.sync_grads(g, w, st, step)
        _, st = jsync.sync_params(w_next, st, step)
        return out, st

    fn = on_mesh(mesh2x4, device)
    for step in range(3):
        g = replica_values(rng, same_in_party=lam > 0)
        w, w_next = (broadcast(weights(t, w0, delta))
                     for t in (step, step + 1))
        jout, jstate = fn(g, w, w_next, jstate, steps_array(step))
        pout, pstate = psync.sync_grads(port(g), port(w), pstate, step)
        params, pstate = psync.sync_params(port(w_next), pstate, step)
        exact = dc == "none"
        assert_tree_equal(jout, pout, exact, what=f"grads step {step}")
        assert_tree_equal(jstate, pstate, exact, what=f"state step {step}")
        # the stale copy is the pulled weights, never the same tensors
        pulled = (step + 1) % pull == 0
        for k, t in pstate["stale"].items():
            assert torch.equal(t, params[k]) == pulled
            assert t.data_ptr() != params[k].data_ptr()


# ---- HFA ----------------------------------------------------------------------

@pytest.mark.parametrize("k1,k2", [(2, 2), (1, 2)])
@pytest.mark.parametrize("dc", ["none", BSC])
def test_hfa_params_and_milestone_track_jax(mesh2x4, topo2x4, k1, k2, dc):
    """Per-replica params drift for 4 steps; the local tier fires every
    k1 steps, the global one every k1*k2 (at steps 4, or 2 and 4):
    params, milestone, dc state and model state as the JAX package's."""
    rng = np.random.RandomState(5)
    cfg = dict(num_parties=2, workers_per_party=4, compression=dc,
               sync_mode="hfa", hfa_k1=k1, hfa_k2=k2)
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo2x4)
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(TOPO)
    assert isinstance(jsync, JaxHFA) and isinstance(psync, HFA)
    w0 = nested(lambda s: powers(rng, s, 0, 6, zeros=0.0))
    jstate = jax_replicate(jsync.init_state(w0), topo2x4, mesh2x4)
    pstate = psync.init_state(port(broadcast(w0)))

    def device(w, ms, st, step):
        w, st = jsync.sync_params(w, st, step)
        ms, st = jsync.sync_model_state(ms, st, step)
        return w, ms, st

    fn = on_mesh(mesh2x4, device)
    fired = 0
    for step in range(4):
        w = replica_values(rng, lo=0, hi=8, zeros=0.0)
        ms = {"bn": {"mean": powers(rng, (2, 4, 6), zeros=0.0)}}
        jw, jms, jstate = fn(w, ms, jstate, steps_array(step))
        pw, pstate = psync.sync_params(port(w), pstate, step)
        pms, pstate = psync.sync_model_state(port(ms), pstate, step)
        exact = dc == "none" or fired == 0
        assert_tree_equal(jw, pw, exact, what=f"params step {step}")
        assert_tree_equal(jms, pms, what=f"model state step {step}")
        assert_tree_equal(jstate, pstate, exact, what=f"state step {step}")
        if (step + 1) % (k1 * k2) == 0:
            fired += 1
            for k, t in pw.items():  # both tiers fired: one value
                assert torch.equal(t, t[:1, :1].expand_as(t)), k
                assert t.data_ptr() != pstate["milestone"][k].data_ptr()
    assert fired == 4 // (k1 * k2)


def test_hfa_one_party_state_is_empty():
    topo = HiPSTopology(1, 4)
    psync = HFA(k1=1, k2=1).bind_topology(topo)
    jsync = JaxHFA(k1=1, k2=1).bind_topology(JaxTopology(1, 4))
    w = port(broadcast(nested(lambda s: np.ones(s, np.float32))))
    w = {k: v[:1] for k, v in w.items()}
    assert psync.init_state(w) == {} == jsync.init_state(
        nested(lambda s: np.ones(s, np.float32)))
    w2, st = psync.sync_params(w, {}, 0)
    assert st == {} and all(torch.equal(w2[k], w[k]) for k in w)


# ---- DGT ----------------------------------------------------------------------

# (block elements, k, channels, tied blocks): a drain every 2 steps;
# tied contributions cut by k (every value +-1/8 or 0, so blocks share
# their mean |g|); k_now >= nb (every block sent, every step a drain); a
# block of 5 (no leaf a multiple of it) with a drain at step 4
DGT_CASES = {"drain": (8, 0.5, 2, False), "ties": (8, 0.4, 3, True),
             "all_blocks": (16, 1.0, 1, False), "ragged": (5, 0.3, 4, False)}


@pytest.mark.parametrize("form", ["tree", "leaf"])
@pytest.mark.parametrize("case", sorted(DGT_CASES))
def test_dgt_tracks_jax(mesh2x4, form, case):
    """The summed output and contri / pending / step over 4 steps, the
    tree form (one flat vector) and the leaf form (the conv kernel);
    wire_bytes_leaf as the JAX package's."""
    block, k, channels, tied = DGT_CASES[case]
    rng = np.random.RandomState(9)
    kw = dict(block_elems=block, k=k, alpha=0.3, channels=channels)
    jdgt = JaxDGT(inner=jax_compressor("none"), **kw)
    pdgt = DGTCompressor(inner=NoCompressor(), **kw)
    shapes = SHAPES if form == "tree" else {"conv": {"kernel": (3, 3, 8, 16)}}

    def values():
        lo, hi = (3, 4) if tied else (0, 12)
        return {m: {n: powers(rng, (2, 4) + s, lo, hi)
                    for n, s in d.items()} for m, d in shapes.items()}

    example = values()
    if form == "tree":
        jinit = jdgt.init_state(jax.tree.map(lambda a: a[0, 0], example))
        pstate = pdgt.init_state(port(example))

        def device(g, st):
            return jdgt.allreduce(g, st, DC_AXIS, 2)
    else:
        leaf = example["conv"]["kernel"]
        jinit = jdgt.init_leaf_state(leaf[0, 0])
        pstate = pdgt.init_leaf_state(torch.from_numpy(leaf))

        def device(g, st):
            return jdgt.allreduce_leaf(g, st, DC_AXIS, 2)
    jstate = jax.tree.map(
        lambda a: np.broadcast_to(np.asarray(a), (2, 4) + np.shape(a)),
        jinit)
    fn = on_mesh(mesh2x4, device)
    for step in range(4):
        g = values()
        if form == "tree":
            jout, jstate = fn(g, jstate)
            pout, pstate = pdgt.allreduce(port(g), pstate, DC_AXIS, 2)
        else:
            g = g["conv"]["kernel"]
            jout, jstate = fn(g, jstate)
            pout, pstate = pdgt.allreduce_leaf(torch.from_numpy(g), pstate,
                                               DC_AXIS, 2)
        assert_tree_equal(jout, pout, what=f"sum step {step}")
        jc, pc = np.asarray(jstate["contri"]), pstate["contri"].numpy()
        np.testing.assert_allclose(pc, jc, rtol=1e-6, atol=0)
        assert_tree_equal(jstate["pending"], pstate["pending"],
                          what=f"pending step {step}")
        assert_tree_equal(jstate["step"], pstate["step"])
        if (step + 1) % channels == 0:  # a drain sends every block
            assert not pstate["pending"].any()
    assert (pstate["step"] == 4).all()
    leaf = np.zeros((3, 3, 8, 16), np.float32)
    assert pdgt.wire_bytes_leaf(torch.zeros((2, 4) + leaf.shape)) == \
        jdgt.wire_bytes_leaf(leaf)


def test_dgt_wrap_of_bsc_wire_bytes_match_jax():
    kw = dict(block_elems=1024, k=0.8, alpha=0.3, channels=3)
    jdgt = JaxDGT(inner=jax_compressor("bsc,0.01"), **kw)
    pdgt = DGTCompressor(inner=get_compressor("bsc,0.01"), **kw)
    for shape in [(272_512,), (3, 3, 64, 64), (100,)]:
        assert pdgt.wire_bytes_leaf(torch.zeros((2, 4) + shape)) == \
            jdgt.wire_bytes_leaf(np.zeros(shape, np.float32))


# ---- the pipelined sync ---------------------------------------------------

@pytest.mark.parametrize("inner", ["fsa", "mixed"])
@pytest.mark.parametrize("lam", [0.0, 0.04])
def test_pipelined_sync_tracks_jax(mesh2x4, topo2x4, inner, lam):
    """Three steps and a drain: the zero warm-up step, the in-flight
    buffers, prev_params, the model-state double buffer seeded with the
    initial stats, and the drain's gradient and stats, as the JAX
    package's.  The dc tier is dense, each party's workers hold one
    gradient (a power of two), so every op is exact."""
    rng = np.random.RandomState(13)
    cfg = dict(num_parties=2, workers_per_party=4, sync_mode=inner,
               pipeline_depth=1, pipeline_dcasgd=lam, mixed_pull_interval=2)
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo2x4)
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(TOPO)
    assert isinstance(jsync, JaxPipelined) and \
        isinstance(psync, PipelinedSync)
    assert psync.name == jsync.name == f"pipelined_{inner}"
    w0, delta = weight_walk(rng)
    ms0 = {"bn": {"mean": powers(rng, (6,), zeros=0.0)}}
    jstate = jax_replicate(jsync.init_state(w0, model_state=ms0), topo2x4,
                           mesh2x4)
    pstate = psync.init_state(port(broadcast(w0)),
                              model_state=port(broadcast(ms0)))
    assert_tree_equal(jstate, pstate, what="init")
    assert ("prev_params" in pstate) == (lam > 0) and "inflight_ms" in pstate

    def device(g, w, w_next, ms, st, step):
        out, st = jsync.sync_grads(g, w, st, step)
        _, st = jsync.sync_params(w_next, st, step)
        ms, st = jsync.sync_model_state(ms, st, step)
        return out, ms, st

    fn = on_mesh(mesh2x4, device)
    for step in range(3):
        g = replica_values(rng, same_in_party=True)
        ms = {"bn": {"mean": powers(rng, (2, 4, 6), zeros=0.0)}}
        w, w_next = (broadcast(weights(t, w0, delta))
                     for t in (step, step + 1))
        jout, jms, jstate = fn(g, w, w_next, ms, jstate, steps_array(step))
        pout, pstate = psync.sync_grads(port(g), port(w), pstate, step)
        _, pstate = psync.sync_params(port(w_next), pstate, step)
        pms, pstate = psync.sync_model_state(port(ms), pstate, step)
        assert_tree_equal(jout, pout, what=f"grads step {step}")
        assert_tree_equal(jms, pms, what=f"model state step {step}")
        assert_tree_equal(jstate, pstate, what=f"state step {step}")
        if step == 0:  # the warm-up bubble applies a zero aggregate
            assert not any(t.any() for t in pout.values())
            assert_tree_equal(broadcast(ms0), pms)

    w = broadcast(weights(3, w0, delta))

    def drain(w, ms, st):
        g, st = jsync.drain_grads(w, st)
        ms, st = jsync.drain_model_state(ms, st)
        return g, ms, st

    jg, jms, jstate = on_mesh(mesh2x4, drain)(w, ms, jstate)
    pg, pstate = psync.drain_grads(port(w), pstate)
    pms, pstate = psync.drain_model_state(port(ms), pstate)
    assert_tree_equal(jg, pg, what="drained grads")
    assert_tree_equal(jms, pms, what="drained model state")
    assert_tree_equal(jstate, pstate, what="drained state")
    assert not any(b.any() for b in
                   pstate["inner"]["dc_comp"]["inflight"])


@pytest.mark.parametrize("dc", ["none", BSC])
def test_pipelined_is_the_synchronous_run_one_step_late(dc):
    """Staleness 1: the pipelined FSA's aggregate at step t + 1 is the
    synchronous FSA's at step t, bit for bit, and the drain returns the
    last one."""
    rng = np.random.RandomState(17)
    mk = dict(num_parties=2, workers_per_party=4, compression=dc)
    sync = get_sync_algorithm(GeoConfig(**mk)).bind_topology(TOPO)
    pipe = get_sync_algorithm(GeoConfig(pipeline_depth=1, **mk)) \
        .bind_topology(TOPO)
    w = port(broadcast(nested(lambda s: powers(rng, s, zeros=0.0))))
    s_sync, s_pipe = sync.init_state(w), pipe.init_state(w)
    previous = None
    for step in range(3):
        g = port(replica_values(rng))
        a, s_sync = sync.sync_grads(g, w, s_sync, step)
        b, s_pipe = pipe.sync_grads(g, w, s_pipe, step)
        want = previous or {k: torch.zeros_like(v) for k, v in a.items()}
        assert all(torch.equal(b[k], want[k]) for k in a)
        previous = a
    drained, _ = pipe.drain_grads(w, s_pipe)
    assert all(torch.equal(drained[k], previous[k]) for k in previous)


def test_pipelined_rejections_raise_the_jax_errors():
    cases = [
        (lambda: JaxPipelined(JaxHFA()), lambda: PipelinedSync(HFA()),
         "fsa or mixed only"),
        (lambda: JaxPipelined(JaxPipelined(JaxFSA())),
         lambda: PipelinedSync(PipelinedSync(FSA())), "fsa or mixed only"),
        (lambda: JaxPipelined(JaxFSA(), depth=2),
         lambda: PipelinedSync(FSA(), depth=2), "depth 1"),
        (lambda: JaxPipelinedComp(JaxPipelinedComp(jax_compressor("none"))),
         lambda: PipelinedCompressor(PipelinedCompressor(NoCompressor())),
         "already pipelined"),
        (lambda: jax_sync(JaxConfig(sync_mode="hfa", num_parties=2,
                                    pipeline_depth=1)),
         lambda: get_sync_algorithm(GeoConfig(sync_mode="hfa", num_parties=2,
                                              pipeline_depth=1)),
         "fsa or mixed only"),
    ]
    for jax_fn, port_fn, match in cases:
        with pytest.raises(Exception, match=match) as jexc:
            jax_fn()
        with pytest.raises(Exception, match=match) as pexc:
            port_fn()
        assert type(pexc.value) is type(jexc.value) is ValueError
    # the shallow copy leaves the caller's algorithm unpipelined
    fsa = FSA()
    before = fsa.dc_compressor
    pipe = PipelinedSync(fsa)
    assert fsa.dc_compressor is before
    assert isinstance(pipe.inner.dc_compressor, PipelinedCompressor)
    assert pipe.inner.dc_compressor.inner is before


def test_pipeline_depth_read_when_depth_is_none(monkeypatch):
    monkeypatch.setenv("GEOMX_PIPELINE_DEPTH", "2.0")
    with pytest.raises(ValueError, match="depth 1") as jexc:
        JaxPipelined(JaxFSA())
    with pytest.raises(ValueError, match="depth 1") as pexc:
        PipelinedSync(FSA())
    assert str(pexc.value) == str(jexc.value)
    monkeypatch.setenv("GEOMX_PIPELINE_DEPTH", "1")
    assert PipelinedSync(FSA()).depth == JaxPipelined(JaxFSA()).depth == 1


# ---- through the Trainer ------------------------------------------------------

# path -> (GeoConfig overrides, JAX optimizer, port optimizer): the three
# new chip_smoke.py paths at a small size; HFA at K1 1, K2 2 so that both
# tiers fire within the 3 steps
TRAINER_PATHS = {
    "mixed_dcasgd": (dict(compression=BSC, sync_mode="mixed", dcasgd=True,
                          dcasgd_lambda=0.04, mixed_pull_interval=2,
                          fused_optim=True),
                     lambda: optim_pallas.fused_optimizer(
                         "adam", learning_rate=0.01),
                     lambda: port_optim.fused_optimizer(
                         "adam", learning_rate=0.01)),
    "hfa_dgt": (dict(compression=BSC, sync_mode="hfa", hfa_k1=1, hfa_k2=2,
                     enable_dgt=2, dgt_k=0.8, udp_channel_num=3,
                     dgt_block_size=4096, dgt_contri_alpha=0.3),
                lambda: optax.adam(0.01), lambda: adam(0.01)),
    "pipelined_fsa": (dict(compression=BSC, pipeline_depth=1),
                      lambda: optax.sgd(0.1, momentum=0.9),
                      lambda: sgd(0.1, momentum=0.9)),
}


def _trainers(path, mesh2x4, topo2x4):
    extra, jtx, ptx = TRAINER_PATHS[path]
    cfg = dict(num_parties=2, workers_per_party=4, precision="fp32", **extra)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo2x4, jtx(), config=JaxConfig(**cfg), mesh=mesh2x4,
                    donate=False)
    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 4), ptx(), config=GeoConfig(**cfg),
                 device="cpu")
    return jt, pt


@pytest.mark.parametrize("path", sorted(TRAINER_PATHS))
def test_three_fp32_steps_track_jax_trainer(mesh2x4, topo2x4, path):
    """Three fp32 steps of a small ResNet from converted weights: losses
    to rtol 1e-4, params to atol 2e-3 against the JAX Trainer; every
    replica identical after them (MixedSync and the pipeline replicate
    the update; HFA's global tier fired at step 2 and its local tier at
    step 3).  MixedSync: the gradients are taken at the stale copy — the
    second step's loss is the forward at the initial weights (the first
    pull lands after step 2).  The pipeline: the drain as the JAX
    package's."""
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    jt, pt = _trainers(path, mesh2x4, topo2x4)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    params, stats = from_flax(p0, s0)
    pst = pt.init_state(params=params, model_state=stats)
    plosses, batches = [], list(pt.make_loader(x, y, 8, seed=0).epoch(0))
    for xb, yb in batches:
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"{path}: losses port {plosses} jax {jlosses}")
    assert len(jlosses) == len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    jparams = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                       jst.params))
    for k, v in pst.params.items():
        np.testing.assert_allclose(v[0, 0].numpy(), jparams[k], atol=2e-3,
                                   err_msg=k)
        if path != "hfa_dgt":
            assert torch.equal(v, v[:1, :1].expand_as(v)), k

    if path == "mixed_dcasgd":
        # trouble spot 1: the second step ran at the stale copy (the
        # initial weights), not at the weights the first step made
        def loss_at(state, batch):
            xb, yb = batch
            losses = [pt.loss_fn({k: v[p, w] for k, v in state.params.items()},
                                 {k: v[p, w] for k, v in
                                  state.model_state.items()},
                                 xb[p, w], yb[p, w])[0]
                      for p in range(2) for w in range(4)]
            return float(torch.stack(losses).view(2, 4).mean(1).mean(0))

        init = pt.init_state(params=params, model_state=stats)
        after_one, _ = pt.train_step(init, *batches[0])
        assert plosses[1] == loss_at(init, batches[1])
        assert plosses[1] != loss_at(after_one, batches[1])

    if path == "pipelined_fsa":
        jd = jt.drain_pipeline(jst)
        pd = pt.drain_pipeline(pst)
        jd_params = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                             jd.params))
        for k, v in pd.params.items():
            np.testing.assert_allclose(v[0, 0].numpy(), jd_params[k],
                                       atol=2e-3, err_msg=k)
        assert not any(b.any() for b in
                       pd.sync_state["inner"]["dc_comp"]["inflight"])


def _small_trainer(sync, lr=0.05):
    t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                HiPSTopology(2, 4), sgd(lr), sync=sync,
                config=GeoConfig(num_parties=2, workers_per_party=4,
                                 precision="fp32"),
                device="cpu")
    rng = np.random.RandomState(19)
    x = rng.randint(0, 256, (128, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 128).astype(np.int32)
    return t, t.init_state(seed=0), list(t.make_loader(x, y, 8).epoch(0))


def test_drain_applies_the_parked_aggregate_exactly_once():
    """As tests/test_pipeline.py pins it: the bubble step plus the drain
    equal one synchronous step; the gradient buffer comes back zeroed,
    the model state is the parked statistics; a synchronous algorithm's
    drain is a no-op."""
    t_pipe, s_pipe, b = _small_trainer(PipelinedSync(FSA()))
    t_sync, s_sync, _ = _small_trainer(FSA())
    s_sync1, _ = t_sync.train_step(s_sync, *b[0])
    s_pipe1, _ = t_pipe.train_step(s_pipe, *b[0])
    for k, v in s_pipe1.params.items():  # the bubble: nothing applied
        assert torch.equal(v, s_pipe.params[k])
    parked = s_pipe1.sync_state["inflight_ms"]
    drained = t_pipe.drain_pipeline(s_pipe1)
    for k, v in drained.params.items():
        np.testing.assert_allclose(v.numpy(), s_sync1.params[k].numpy(),
                                   atol=1e-6, err_msg=k)
    for k, v in drained.model_state.items():
        assert torch.equal(v, parked[k])
    assert not any(x.any() for x in
                   drained.sync_state["inner"]["dc_comp"]["inflight"])
    # a second drain applies nothing more: the buffer is empty
    again = t_pipe.drain_pipeline(drained)
    for k, v in again.params.items():
        assert torch.equal(v, drained.params[k])
    assert t_sync.drain_pipeline(s_sync1) is s_sync1


def test_drain_under_the_fused_apply_raises_as_jax_does(mesh2x4, topo2x4):
    """The JAX package's drain hands a leaf tree to the fused optimizer
    whose state lives on the bucket layout, and raises ValueError; the
    port refuses the same call with the same type."""
    cfg = dict(num_parties=2, workers_per_party=4, compression=BSC,
               pipeline_depth=1, fused_optim=True, precision="fp32")
    rng = np.random.RandomState(23)
    x = rng.randint(0, 256, (64, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 64).astype(np.int32)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32), topo2x4,
                    optim_pallas.fused_optimizer("sgd", learning_rate=0.1),
                    config=JaxConfig(**cfg), mesh=mesh2x4, donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    with pytest.raises(ValueError):
        jt.drain_pipeline(jst)
    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 4),
                 port_optim.fused_optimizer("sgd", learning_rate=0.1),
                 config=GeoConfig(**cfg), device="cpu")
    pst = pt.init_state(seed=0)
    pst, _ = pt.train_step(pst, *next(iter(pt.make_loader(x, y, 8)
                                          .epoch(0))))
    with pytest.raises(ValueError, match="GEOMX_FUSED_OPTIM"):
        pt.drain_pipeline(pst)


def test_replicated_grads_flags_match_jax():
    assert FSA.grads_replicated_after_sync is JaxFSA.grads_replicated_after_sync
    for p, j in ((MixedSync(), JaxMixed()), (HFA(), JaxHFA()),
                 (PipelinedSync(FSA()), JaxPipelined(JaxFSA()))):
        assert p.grads_replicated_after_sync is j.grads_replicated_after_sync
