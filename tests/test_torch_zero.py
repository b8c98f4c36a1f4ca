"""Port parity: the ZeRO-sharded weight update (geomx_tpu_torch vs
geomx_tpu on the conftest 2x4 mesh): the reduce-scatter and the tiled
all-gather, ``ZeroPlan``, the bucket-shard view of the dc tier, the
shard forms of FSA, MixedSync (with DCASGD) and the pipelined sync with
its drain, and three Trainer steps of each ZeRO path.

Tolerances:

- bit for bit where every op is exact in both packages: signed powers of
  two (dyadic values) that sum without rounding, a learning rate and a
  momentum that are powers of two, differences of the weights that are
  powers of two (the DCASGD product);
- rtol 1e-6 (with an atol of 1e-6 of the tensor's largest magnitude)
  where a rounded value meets a multiply-add: BSC's ``u = 0.9 u + g``,
  Adam's moments and square root.  XLA contracts such a multiply-add
  into an FMA on the CPU and the port rounds the product on its own
  (ROADMAP.md Queue 3, "FMA contraction");
- the Trainer cases: losses to rtol 1e-4, params to atol 2e-3, as the
  other Trainer parity tests (convolution sums differ in order between
  the packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from test_torch_sync import (TOPO, assert_tree_equal, broadcast, nested,
                             on_mesh, port, port_leaves, powers,
                             replica_values, steps_array, weight_walk,
                             weights)
from test_torch_train import FILTERS, STAGES

from geomx_tpu.compression import get_compressor as jax_compressor
from geomx_tpu.compression.bucketing import \
    BucketedCompressor as JaxBucketed
from geomx_tpu.compression.twobit import TwoBitCompressor
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu.train import zero as jax_zero
from geomx_tpu.train.state import replicate_tree as jax_replicate
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.compression import get_compressor
from geomx_tpu_torch.compression.bucketing import BucketedCompressor
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as port_optim
from geomx_tpu_torch.optim import adam, sgd
from geomx_tpu_torch.parallel.collectives import (all_gather, psum,
                                                  psum_scatter)
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.train import zero as port_zero
from geomx_tpu_torch.tree import from_nested, leaf_names

torch.set_num_threads(2)

# SHAPES' 1,818 elements pad to one 2,048-element bucket at pad_to 512:
# four 512-element shards, so BSC needs min_sparse_size <= 512 (k = 6)
BSC = "bsc,0.01,select=sampled,min_sparse_size=256"


def shard_rows(rng, n, W=4, lo=0, hi=12):
    """``[2, 4, n]`` powers of two, the same in both parties' slot w."""
    x = powers(rng, (1, W, n), lo, hi)
    return np.ascontiguousarray(np.broadcast_to(x, (2, W, n)))


# ---- the collectives ---------------------------------------------------------

@pytest.mark.parametrize("axis", [WORKER_AXIS, DC_AXIS])
def test_psum_scatter_and_tiled_all_gather_match_lax(mesh2x4, axis):
    """``lax.psum_scatter(x.reshape(A, s), scatter_dimension=0)`` and
    ``lax.all_gather(shard, tiled=True)`` in ``shard_map``, bit for bit
    on dyadic inputs; the scattered chunk is also the bits of the same
    chunk of ``psum`` (one reduction)."""
    rng = np.random.RandomState(0)
    A = 4 if axis == WORKER_AXIS else 2
    s = 24
    x = powers(rng, (2, 4, A * s))

    def device(v):
        sc = lax.psum_scatter(v.reshape(A, s), axis, scatter_dimension=0)
        return sc, lax.all_gather(sc, axis, tiled=True)

    jsc, jga = on_mesh(mesh2x4, device)(x)
    t = torch.from_numpy(x)
    psc = psum_scatter(t, axis)
    pga = all_gather(psc, axis, tiled=True)
    assert psc.shape == (2, 4, s) and psc.is_contiguous()
    assert pga.shape == (2, 4, A * s)
    np.testing.assert_array_equal(psc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(pga.numpy(), np.asarray(jga))
    # slot a holds chunk a of the full sum, whatever the input values
    y = torch.randn(2, 4, A * s, generator=torch.Generator().manual_seed(1))
    full = psum(y, axis)
    chunks = psum_scatter(y, axis)
    for p in range(2):
        for w in range(4):
            a = w if axis == WORKER_AXIS else p
            assert torch.equal(chunks[p, w], full[p, w, a * s:(a + 1) * s])
    with pytest.raises(ValueError, match="psum_scatter"):
        psum_scatter(torch.zeros(2, 4, A * s + 1), axis)


# ---- ZeroPlan ----------------------------------------------------------------

def jax_topo():
    from geomx_tpu.topology import HiPSTopology as JaxTopology
    return JaxTopology(2, 4)


def plans(W=4, inner="none"):
    jplan, pplan = jax_zero.ZeroPlan(W), port_zero.ZeroPlan(W)
    jplan.bind_compressor(JaxBucketed(jax_compressor(inner)))
    pplan.bind_compressor(BucketedCompressor(get_compressor(inner)))
    return jplan, pplan


def test_zero_plan_scatter_and_tree_shards_match_jax(mesh2x4):
    """``scatter_bucket`` (the worker mean as shards) and
    ``tree_shards`` (each worker's slice of a replicated tree), bit for
    bit; the layout re-pads to 128 * W."""
    rng = np.random.RandomState(1)
    jplan, pplan = plans()
    assert pplan.pad_to == jplan.pad_to == 512
    assert pplan.bucketed.pad_to == jplan.bucketed.pad_to == 512
    w = nested(lambda s: powers(rng, s, zeros=0.0))
    bucket = powers(rng, (2, 4, 2048))

    def device(b, tree):
        bk = jplan.bucketed.zero_bucketer(jax.tree.leaves(tree))
        return (jplan.scatter_bucket(b, WORKER_AXIS),
                jplan.tree_shards(tree, bk, lax.axis_index(WORKER_AXIS)))

    jsc, jsh = on_mesh(mesh2x4, device)(bucket, broadcast(w))
    pw = port(broadcast(w))
    bk = pplan.bucketed.zero_bucketer([pw[k] for k in leaf_names(pw)])
    assert bk.bucket_sizes == [2048]
    np.testing.assert_array_equal(
        pplan.scatter_bucket(torch.from_numpy(bucket)).numpy(),
        np.asarray(jsc))
    psh = pplan.tree_shards(pw, bk)
    assert [t.shape for t in psh] == [(2, 4, 512)]
    assert_tree_equal(jsh, psh, what="tree shards")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_apply_shard_update_matches_jax(mesh2x4, fused, kind):
    """Two shard-local updates and the params they gather back, per
    leaf (``tx.update`` on the shard list) and fused (the kernels'
    plain versions over ``[P, W, n / W]``): SGD with lr 1/16 and
    momentum 1/2 bit for bit; Adam to rtol 1e-6."""
    rng = np.random.RandomState(2)
    jplan, pplan = plans()
    if kind == "sgd":
        kw = dict(learning_rate=0.0625, momentum=0.5)
        jtx = optim_pallas.fused_optimizer("sgd", **kw)
        ptx = port_optim.fused_optimizer("sgd", **kw)
    else:
        jtx = optim_pallas.fused_optimizer("adam", learning_rate=0.01)
        ptx = port_optim.fused_optimizer("adam", learning_rate=0.01)
    if fused:
        jplan.fused_spec = optim_pallas.fused_spec_of(jtx)
        jplan.fused_interpret = True
        pplan.fused_spec = port_optim.fused_spec_of(ptx)
    w = broadcast(nested(lambda s: powers(rng, s, 0, 6, zeros=0.0)))
    jopt = jax_replicate(jtx.init([jnp.zeros((512,), jnp.float32)]),
                         jax_topo(), mesh2x4)
    pw = port(w)
    popt = ptx.init(pplan.shard_example(pw, pplan.bucketed))
    assert [t.shape for t in port_leaves(popt) if hasattr(t, "shape")] \
        == [(2, 4, 512)] * (1 if kind == "sgd" else 2)

    fn = on_mesh(mesh2x4, lambda g, p, st: jplan.apply_shard_update(
        jtx, [g], p, st, WORKER_AXIS))
    jw = w
    for step in range(2):
        g = shard_rows(rng, 512)
        jw, jopt = fn(g, jw, jopt)
        pw, popt = pplan.apply_shard_update(ptx, [torch.from_numpy(g)], pw,
                                            popt)
        assert_tree_equal(jw, pw, exact=kind == "sgd",
                          what=f"params step {step}")
        for k, v in pw.items():  # the gather replicates the params
            assert torch.equal(v, v[:1, :1].expand_as(v)), k
    if kind == "sgd":
        assert_tree_equal(jax.tree.leaves(jopt), port_leaves(popt),
                          what="trace")


# ---- the bucket-shard view of the dc tier ------------------------------------

@pytest.mark.parametrize("spec", ["none", BSC, "2bit,0.5"])
def test_shard_state_and_allreduce_match_jax(mesh2x4, spec):
    """``init_shard_state`` shapes, two ``allreduce_shards`` of
    ``[P, W, n / W]`` shards (output and state) and ``shard_wire_bytes``
    as the JAX package's; a bucket that does not split into W shards
    raises its ValueError."""
    rng = np.random.RandomState(3)
    jplan, pplan = plans(inner=spec)
    jb, pb = jplan.bucketed, pplan.bucketed
    example = nested(lambda s: np.zeros(s, np.float32))
    jstate = jax_replicate(jb.init_shard_state(example, 4), jax_topo(),
                           mesh2x4)
    pex = port(broadcast(example))
    pstate = pb.init_shard_state(pex, 4)
    assert_tree_equal(jstate, pstate, what="init")
    # the port's 2-bit wire is the kernel path's row-blocked words, as
    # the JAX package's Pallas path counts them
    jwire = jb if spec != "2bit,0.5" else JaxBucketed(
        TwoBitCompressor(0.5, use_pallas=True), pad_to=512)
    assert pb.shard_wire_bytes(pex, 4) == jwire.shard_wire_bytes(example, 4)

    def device(sh, st):
        bk = jb.zero_bucketer(jax.tree.leaves(example))
        return jb.allreduce_shards([sh], st, DC_AXIS, 2, bk)

    fn = on_mesh(mesh2x4, device)
    bk = pb.zero_bucketer([pex[k] for k in leaf_names(pex)])
    for step in range(2):
        sh = powers(rng, (2, 4, 512))
        jout, jstate = fn(sh, jstate)
        pout, pstate = pb.allreduce_shards([torch.from_numpy(sh)], pstate,
                                           DC_AXIS, 2, bk)
        exact = spec == "none"
        assert_tree_equal(jout, pout, exact, what=f"out step {step}")
        assert_tree_equal(jstate, pstate, exact, what=f"state step {step}")

    # a bucket of 1,920 (pad_to 128) does not split into 7 shards
    jbad = JaxBucketed(jax_compressor(spec))
    pbad = BucketedCompressor(get_compressor(spec))
    with pytest.raises(ValueError) as jexc:
        jbad.init_shard_state(example, 7)
    with pytest.raises(ValueError) as pexc:
        pbad.init_shard_state(pex, 7)
    assert str(pexc.value) == str(jexc.value)


# ---- the shard forms of the sync algorithms ----------------------------------

@pytest.mark.parametrize("mode,lam,pull", [("fsa", 0.0, 1),
                                           ("mixed", 0.04, 2),
                                           ("mixed", 0.0, 1)])
@pytest.mark.parametrize("dc", ["none", BSC])
def test_sync_grad_shards_track_jax(mesh2x4, topo2x4, mode, lam, pull, dc):
    """Three steps of ``sync_grad_shards`` and ``sync_params``: the
    shards and the state (MixedSync's full stale copy, the shard-shaped
    dc state) as the JAX package's.  With DCASGD each party's workers
    hold one gradient, so the worker mean and ``lam * g * g`` are
    exact."""
    rng = np.random.RandomState(4)
    cfg = dict(num_parties=2, workers_per_party=4, compression=dc,
               sync_mode=mode, dcasgd=lam > 0, mixed_pull_interval=pull)
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo2x4) \
        .bind_zero(jax_zero.ZeroPlan(4))
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(TOPO) \
        .bind_zero(port_zero.ZeroPlan(4))
    w0, delta = weight_walk(rng)
    jstate = jax_replicate(jsync.init_state(w0), topo2x4, mesh2x4)
    pstate = psync.init_state(port(broadcast(w0)))
    assert_tree_equal(jstate, pstate, what="init")

    def device(g, w, w_next, st, step):
        out, st = jsync.sync_grad_shards(g, w, st, step)
        _, st = jsync.sync_params(w_next, st, step)
        return out, st

    fn = on_mesh(mesh2x4, device)
    for step in range(3):
        g = replica_values(rng, same_in_party=lam > 0)
        w, w_next = (broadcast(weights(t, w0, delta))
                     for t in (step, step + 1))
        jout, jstate = fn(g, w, w_next, jstate, steps_array(step))
        pout, pstate = psync.sync_grad_shards(port(g), port(w), pstate, step)
        _, pstate = psync.sync_params(port(w_next), pstate, step)
        exact = dc == "none"
        assert [t.shape for t in pout] == [(2, 4, 512)]
        assert_tree_equal(jout, pout, exact, what=f"shards step {step}")
        assert_tree_equal(jstate, pstate, exact, what=f"state step {step}")


@pytest.mark.parametrize("inner", ["fsa", "mixed"])
def test_pipelined_shards_and_drain_track_jax(mesh2x4, topo2x4, inner):
    """The pipelined sync under ZeRO: the zero warm-up step, the
    shard-sized in-flight buffers, then ``drain_grad_shards`` (through
    ``peek_shards``) returning the parked aggregates, divided, with the
    buffer zeroed; bit for bit on a dense dc tier."""
    rng = np.random.RandomState(5)
    cfg = dict(num_parties=2, workers_per_party=4, sync_mode=inner,
               pipeline_depth=1, mixed_pull_interval=2)
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo2x4) \
        .bind_zero(jax_zero.ZeroPlan(4))
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(TOPO) \
        .bind_zero(port_zero.ZeroPlan(4))
    w0, delta = weight_walk(rng)
    jstate = jax_replicate(jsync.init_state(w0), topo2x4, mesh2x4)
    pstate = psync.init_state(port(broadcast(w0)))
    assert_tree_equal(jstate, pstate, what="init")
    inflight = pstate["inner"]["dc_comp"]["inflight"]
    assert [t.shape for t in inflight] == [(2, 4, 512)]

    def device(g, w, st, step):
        return jsync.sync_grad_shards(g, w, st, step)

    fn = on_mesh(mesh2x4, device)
    last = None
    for step in range(3):
        g = replica_values(rng, same_in_party=True)
        w = broadcast(weights(step, w0, delta))
        jout, jstate = fn(g, w, jstate, steps_array(step))
        pout, pstate = psync.sync_grad_shards(port(g), port(w), pstate, step)
        assert_tree_equal(jout, pout, what=f"shards step {step}")
        assert_tree_equal(jstate, pstate, what=f"state step {step}")
        if step == 0:
            assert not any(t.any() for t in pout)
        last = [t / 2 for t in pstate["inner"]["dc_comp"]["inflight"]]

    w = broadcast(weights(3, w0, delta))
    jg, jstate = on_mesh(mesh2x4, jsync.drain_grad_shards)(w, jstate)
    pg, pstate = psync.drain_grad_shards(port(w), pstate)
    assert_tree_equal(jg, pg, what="drained shards")
    assert_tree_equal(jstate, pstate, what="drained state")
    assert all(torch.equal(a, b) for a, b in zip(pg, last))
    assert not any(t.any() for t in pstate["inner"]["dc_comp"]["inflight"])


# ---- through the Trainer ------------------------------------------------------

# path -> (GeoConfig overrides, JAX optimizer, port optimizer)
ZERO_PATHS = {
    "sgd_momentum": (dict(compression="none"),
                     lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: sgd(0.1, momentum=0.9)),
    "adam_bsc": (dict(compression="bsc,0.01,select=sampled"),
                 lambda: optax.adam(0.01), lambda: adam(0.01)),
    "pipelined_fused_adam": (
        dict(compression="bsc,0.01,select=sampled", pipeline_depth=1,
             fused_optim=True),
        lambda: optim_pallas.fused_optimizer("adam", learning_rate=0.01),
        lambda: port_optim.fused_optimizer("adam", learning_rate=0.01)),
    "mixed_dcasgd_fused_sgd": (
        dict(compression="bsc,0.01,select=sampled", sync_mode="mixed",
             dcasgd=True, mixed_pull_interval=2, fused_optim=True),
        lambda: optim_pallas.fused_optimizer("sgd", learning_rate=0.1),
        lambda: port_optim.fused_optimizer("sgd", learning_rate=0.1)),
}


def zero_trainers(path, mesh2x4, topo2x4):
    extra, jtx, ptx = ZERO_PATHS[path]
    cfg = dict(num_parties=2, workers_per_party=4, precision="fp32",
               zero=True, **extra)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo2x4, jtx(), config=JaxConfig(**cfg), mesh=mesh2x4,
                    donate=False)
    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 4), ptx(), config=GeoConfig(**cfg),
                 device="cpu")
    return jt, pt


@pytest.mark.parametrize("path", sorted(ZERO_PATHS))
def test_three_zero_steps_track_jax_trainer(mesh2x4, topo2x4, path):
    """Three fp32 ZeRO steps of a small ResNet from converted weights:
    losses to rtol 1e-4, params to atol 2e-3 against the JAX Trainer;
    params identical over every replica; the optimizer state a worker's
    shard, identical across parties and distinct across workers.  The
    pipelined path then drains as the JAX package's: its ZeRO drain runs
    through ``apply_shard_update``, the fused kernels included."""
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    jt, pt = zero_trainers(path, mesh2x4, topo2x4)
    assert pt._zero_plan is not None and jt._zero_plan is not None
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
    jshapes = [np.shape(a) for a in jax.tree.leaves(jst.opt_state)]
    pshapes = [tuple(t.shape) for t in port_leaves(pst.opt_state)
               if isinstance(t, torch.Tensor)]
    assert pshapes == [s for s in jshapes if len(s) == 3]
    plosses = []
    for xb, yb in pt.make_loader(x, y, 8, seed=0).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"{path}: losses port {plosses} jax {jlosses}")
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)

    def check(jstate, pstate, what):
        jp = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                      jstate.params))
        for k, v in pstate.params.items():
            np.testing.assert_allclose(v[0, 0].numpy(), jp[k], atol=2e-3,
                                       err_msg=f"{what} {k}")
            assert torch.equal(v, v[:1, :1].expand_as(v)), k
        # the optimizer state is a worker's shard, the same in every
        # party; the dc-tier residuals are each party's own
        for t in port_leaves(pstate.opt_state):
            if isinstance(t, torch.Tensor):
                assert t.shape[2] == 19_968 // 4  # 19,954 padded to 512s
                assert torch.equal(t[0], t[1]), what
                assert not torch.equal(t[:, 0], t[:, 1]), what

    check(jst, pst, "after 3 steps")
    if path.startswith("pipelined"):
        jd, pd = jt.drain_pipeline(jst), pt.drain_pipeline(pst)
        check(jd, pd, "drained")
        assert not any(t.any() for t in
                       pd.sync_state["inner"]["dc_comp"]["inflight"])


def test_zero_dense_matches_the_replicated_update():
    """With the uncompressed dc tier the ZeRO trajectory is the
    replicated one (tests/test_zero.py:93-100's identity, 1e-6)."""
    rng = np.random.RandomState(12)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    out = []
    for zero in (False, True):
        t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                    HiPSTopology(2, 4), adam(1e-3),
                    config=GeoConfig(num_parties=2, workers_per_party=4,
                                     precision="fp32", zero=zero),
                    device="cpu")
        st = t.init_state(seed=0)
        for xb, yb in t.make_loader(x, y, 8, seed=0).epoch(0):
            st, _ = t.train_step(st, xb, yb)
        out.append(st.params)
    for k in out[0]:
        np.testing.assert_allclose(out[1][k].numpy(), out[0][k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def state_bytes(tree):
    return sum(t.numel() * t.element_size() for t in port_leaves(tree)
               if isinstance(t, torch.Tensor)) / 8


def test_per_slot_state_bytes_shrink_about_one_over_w():
    """Adam's moments plus the BSC residuals a slot: the sharded form is
    under 1.5 / W of the replicated one (tests/test_zero.py:160), and
    each residual is ``[P, W, n / W]`` of a padded bucket (:176)."""
    sizes = {}
    for zero in (False, True):
        t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                    HiPSTopology(2, 4), adam(1e-3),
                    config=GeoConfig(num_parties=2, workers_per_party=4,
                                     compression="bsc,0.05,"
                                     "min_sparse_size=16", zero=zero),
                    device="cpu")
        st = t.init_state(seed=0)
        sizes[zero] = (state_bytes(st.opt_state),
                       state_bytes(st.sync_state["dc_comp"]))
        if zero:
            bk = t.sync.dc_compressor.zero_bucketer(
                [st.params[k] for k in leaf_names(st.params)])
            for leaf in port_leaves(st.sync_state["dc_comp"]):
                assert leaf.shape[:2] == (2, 4)
                assert leaf.shape[2] in {n // 4 for n in bk.bucket_sizes}
    for i in range(2):
        assert sizes[True][i] / sizes[False][i] < 1.5 / 4, sizes


@pytest.mark.parametrize("over", [
    dict(sync_mode="hfa"), dict(bucket_bytes=0),
    dict(multi_gps=True, bigarray_bound=128),
    dict(pipeline_depth=1, pipeline_dcasgd=0.04),
], ids=["hfa", "no_bucketing", "multigps", "pipelined_dcasgd"])
def test_invalid_compositions_raise_the_jax_errors(topo2x4, over):
    """tests/test_zero.py:449-458: the same type and message."""
    cfg = dict(num_parties=2, workers_per_party=4, zero=True, **over)
    with pytest.raises(ValueError) as jexc:
        JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS),
                   topo2x4, optax.sgd(0.1), config=JaxConfig(**cfg))
    with pytest.raises(ValueError) as pexc:
        Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.1),
                config=GeoConfig(**cfg), device="cpu")
    assert str(pexc.value) == str(jexc.value)


def test_bind_zero_never_mutates_the_callers_sync():
    """tests/test_zero.py:461-483: the Trainer binds a copy; the
    caller's sync keeps no plan and its padding; a ZeRO-bound sync under
    ``zero=False`` is refused."""
    cfg = GeoConfig(num_parties=2, workers_per_party=4, zero=True)
    sync = get_sync_algorithm(cfg)
    pad_before = sync.dc_compressor.pad_to
    tr = Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.1),
                 sync=sync, config=cfg, device="cpu")
    assert sync.zero_plan is None
    assert sync.dc_compressor.pad_to == pad_before == 128
    assert tr.sync is not sync and tr.sync.zero_plan is not None
    assert tr.sync.dc_compressor.pad_to == 512
    assert tr._zero_plan is tr.sync.zero_plan
    # a pipelined sync copies its inner algorithm and compressor stack
    pipe = get_sync_algorithm(GeoConfig(num_parties=2, workers_per_party=4,
                                        pipeline_depth=1))
    bound = pipe.bind_zero(port_zero.ZeroPlan(4))
    assert pipe.zero_plan is None and pipe.inner.zero_plan is None
    assert pipe.inner.dc_compressor.inner.pad_to == 128
    assert bound.inner.dc_compressor.inner.pad_to == 512
    with pytest.raises(ValueError, match="ZeRO-bound"):
        Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.1),
                sync=tr.sync, config=GeoConfig(num_parties=2,
                                               workers_per_party=4),
                device="cpu")


@pytest.mark.parametrize("t_shape", [(2, 4, 256), (2, 2, 640), (1, 8, 96)])
def test_fit_helpers_match_jax(t_shape):
    """The numpy layout helpers of a sharded checkpoint, on the same
    arrays: re-sharding a [2, 4, 320] shard leaf and a per-slot count,
    re-fitting flat buckets both ways, the replicated copy and its
    ValueError; the meta block."""
    rng = np.random.RandomState(13)
    shard = np.broadcast_to(rng.randn(1, 4, 320).astype(np.float32),
                            (2, 4, 320)).copy()
    count = np.full((2, 4), 7, np.int32)
    for old in (shard, count):
        shape = t_shape if old.ndim == 3 else t_shape[:2]
        np.testing.assert_array_equal(port_zero._fit_shard_leaf(old, shape),
                                      jax_zero._fit_shard_leaf(old, shape))
    for n in (100, 1280, 2000):
        np.testing.assert_array_equal(port_zero._fit_flat(shard[0], n),
                                      jax_zero._fit_flat(shard[0], n))
    rep = np.broadcast_to(rng.randn(3, 5).astype(np.float32), (2, 4, 3, 5))
    np.testing.assert_array_equal(
        port_zero._fit_replicated_leaf(rep, t_shape[:2] + (3, 5)),
        jax_zero._fit_replicated_leaf(rep, t_shape[:2] + (3, 5)))
    with pytest.raises(ValueError) as jexc:
        jax_zero._fit_replicated_leaf(rep, t_shape)
    with pytest.raises(ValueError) as pexc:
        port_zero._fit_replicated_leaf(rep, t_shape)
    assert str(pexc.value) == str(jexc.value)
    topo = HiPSTopology(*t_shape[:2])
    for plan in (None, port_zero.ZeroPlan(t_shape[1])):
        assert port_zero.zero_checkpoint_meta(plan, topo) == \
            jax_zero.zero_checkpoint_meta(plan, topo)
