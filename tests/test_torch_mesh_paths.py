"""Port parity: the sync algorithms and WAN compressors on the device mesh
(geomx_tpu_torch's ``run_on_mesh`` against the stacked port path, and
three paths against the JAX Trainer's ``shard_map`` on the conftest
meshes).

Every path runs one program a slot on ``["cpu"] * 8`` (the CPU has one
torch device, as ``tests/test_torch_mesh.py`` sets out): MixedSync with
and without DCASGD (and under ZeRO), HFA, DGT and both together, the
pipeline and its drains, MultiGPS, a worker-tier compressor, 2-bit in
both forms, FP16 in both forms, MPQ and the owner-routed sparse_agg.
After every step (and after the drain) the gathered state, the loss
and the accuracy are the stacked port path's bits.  The JAX comparisons
keep the tolerances of ``tests/test_torch_mesh.py``; the 2-bit paths use
a power-of-two threshold (the JAX kernel path's sum agrees with the
jnp one only then).

The repair tests hold the shared compressor objects to their contract
under slot threads: a 2-bit all-reduce reads its wire from a local, a
BSC sparse_agg record and a 2-bit wire record are slot ``(0, 0)``'s
alone, and the owner-routed all-reduce checks its axis size against the
slot's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_mesh import ITEM, assert_bits_equal, cpu_mesh, tensors_of
from test_torch_train import FILTERS, STAGES

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas as jo
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.compression import get_compressor
from geomx_tpu_torch.compression import sparseagg as psa
from geomx_tpu_torch.compression.bisparse import BiSparseCompressor
from geomx_tpu_torch.compression.twobit import TwoBitCompressor
from geomx_tpu_torch.models import MLP, ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as po
from geomx_tpu_torch.optim import adam, sgd
from geomx_tpu_torch.parallel import collectives as pc
from geomx_tpu_torch.sync import FSA
from geomx_tpu_torch.topology import DC_AXIS, PlacedTree
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

BSC = "bsc,0.01,select=sampled"


def _fsa_worker_2bit():
    """FSA with a 2-bit worker tier under the BSC dc tier."""
    return FSA(dc_compressor=get_compressor(BSC),
               worker_compressor=get_compressor("2bit,0.5"))


# path -> ([P, W], GeoConfig fields, port optimizer, sync factory or None):
# chip_smoke.py's configurations at the small ResNet's size; HFA at K1 1,
# K2 2 and DGT on 2 channels, so that both tiers fire and DGT drains
# within the 3 steps
CASES = {
    "mixed": ((2, 4), dict(compression=BSC, sync_mode="mixed",
                           mixed_pull_interval=2),
              lambda: sgd(0.1, momentum=0.9), None),
    "mixed_dcasgd": ((2, 4), dict(compression=BSC, sync_mode="mixed",
                                  dcasgd=True, dcasgd_lambda=0.04,
                                  mixed_pull_interval=2, fused_optim=True),
                     lambda: po.fused_optimizer("adam", learning_rate=0.01),
                     None),
    "zero_mixed_dcasgd": ((2, 4), dict(compression=BSC, sync_mode="mixed",
                                       dcasgd=True, dcasgd_lambda=0.04,
                                       mixed_pull_interval=2, zero=True,
                                       fused_optim=True),
                          lambda: po.fused_optimizer("sgd", learning_rate=0.1,
                                                     momentum=0.9), None),
    "hfa": ((2, 4), dict(compression=BSC, sync_mode="hfa", hfa_k1=1,
                         hfa_k2=2),
            lambda: adam(0.01), None),
    "dgt": ((2, 4), dict(compression=BSC, enable_dgt=2, dgt_k=0.5,
                         udp_channel_num=2, dgt_block_size=4096,
                         dgt_contri_alpha=0.3),
            lambda: sgd(0.1, momentum=0.9), None),
    "hfa_dgt": ((2, 4), dict(compression=BSC, sync_mode="hfa", hfa_k1=1,
                             hfa_k2=2, enable_dgt=2, dgt_k=0.8,
                             udp_channel_num=3, dgt_block_size=4096,
                             dgt_contri_alpha=0.3),
                lambda: adam(0.01), None),
    "pipelined_fsa": ((2, 4), dict(compression=BSC, pipeline_depth=1),
                      lambda: sgd(0.1, momentum=0.9), None),
    "zero_pipelined_adam": ((2, 4), dict(compression=BSC, zero=True,
                                         pipeline_depth=1, fused_optim=True),
                            lambda: po.fused_optimizer("adam",
                                                       learning_rate=0.01),
                            None),
    "multigps_bsc": ((2, 4), dict(compression=BSC, multi_gps=True,
                                  bigarray_bound=1000),
                     lambda: sgd(0.1, momentum=0.9), None),
    "worker_compressor": ((2, 4), dict(), lambda: sgd(0.1, momentum=0.9),
                          _fsa_worker_2bit),
    "twobit": ((2, 4), dict(compression="2bit,0.5", fused_optim=True),
               lambda: po.fused_optimizer("adam", learning_rate=0.01), None),
    "twobit_lattice": ((4, 2), dict(compression="2bit,0.5,sparse_agg=1"),
                       lambda: sgd(0.1, momentum=0.9), None),
    "fp16": ((2, 4), dict(compression="fp16"),
             lambda: sgd(0.1, momentum=0.9), None),
    "fp16_lattice": ((4, 2), dict(compression="fp16,sparse_agg=1"),
                     lambda: sgd(0.1, momentum=0.9), None),
    # per leaf: the leaves of 2,000 elements or more take BSC, the rest
    # FP16
    "mpq": ((2, 4), dict(compression="mpq,0.01,2000", bucket_bytes=0),
            lambda: sgd(0.1, momentum=0.9), None),
    "sparse_agg": ((4, 2), dict(compression=BSC + ",sparse_agg=1",
                                fused_optim=True),
                   lambda: po.fused_optimizer("sgd", learning_rate=0.1,
                                              momentum=0.9), None),
}


def _data(seed=11, n=192, hw=16):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    y = rng.randint(0, 10, n).astype(np.int32)
    return x, y


def _trainer(case, mesh=None):
    shape, fields, tx, sync = CASES[case]
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    cfg = GeoConfig(num_parties=shape[0], workers_per_party=shape[1],
                    precision="fp32", **fields)
    return Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                   HiPSTopology(*shape), tx(), config=cfg,
                   sync=None if sync is None else sync(), **kw)


@pytest.mark.filterwarnings("ignore:multi_gps")
@pytest.mark.parametrize("case", sorted(CASES))
def test_meshed_path_equals_stacked(case):
    """Three fp32 steps of a small ResNet on the mesh and stacked from one
    seed and the same batches: the gathered state, the loss and the
    accuracy are the stacked path's bits after every step, and after the
    drain where the sync has one."""
    shape = CASES[case][0]
    x, y = _data()
    st, mt = _trainer(case), _trainer(case, cpu_mesh(*shape))
    ss, ms = st.init_state(seed=0), mt.init_state(seed=0)
    assert isinstance(ms, PlacedTree)
    batches = list(st.make_loader(x, y, 8, seed=0).epoch(0))
    assert len(batches) == 3
    for i, (xb, yb) in enumerate(batches):
        ss, sm = st.train_step(ss, xb, yb)
        ms, mm = mt.train_step(ms, xb, yb)
        assert float(mm["loss"]) == float(sm["loss"]), (case, i)
        assert float(mm["accuracy"]) == float(sm["accuracy"]), (case, i)
        assert_bits_equal(mt.mesh.gather(ms), ss, f"{case} step {i + 1}")
    if hasattr(st.sync, "drain_grads"):
        ss, ms = st.drain_pipeline(ss), mt.drain_pipeline(ms)
        assert isinstance(ms, PlacedTree)
        assert_bits_equal(mt.mesh.gather(ms), ss, f"{case} drain")


# path -> ([P, W], GeoConfig fields, JAX optimizer, port optimizer)
JAX_PATHS = {
    "twobit_adam": ((2, 4), dict(compression="2bit,0.5", fused_optim=True),
                    lambda: jo.fused_optimizer("adam", learning_rate=0.01),
                    lambda: po.fused_optimizer("adam", learning_rate=0.01)),
    "sparse_agg": ((4, 2), dict(compression=BSC + ",sparse_agg=1"),
                   lambda: optax.sgd(0.1, momentum=0.9),
                   lambda: sgd(0.1, momentum=0.9)),
    "mixed_dcasgd": ((2, 4), dict(compression=BSC, sync_mode="mixed",
                                  dcasgd=True, dcasgd_lambda=0.04,
                                  mixed_pull_interval=2, fused_optim=True),
                     lambda: jo.fused_optimizer("adam", learning_rate=0.01),
                     lambda: po.fused_optimizer("adam", learning_rate=0.01)),
}


@pytest.mark.parametrize("path", sorted(JAX_PATHS))
def test_meshed_slice_tracks_jax(request, path):
    """Three fp32 steps from the JAX Trainer's weights on its conftest
    mesh (the Pallas paths as the JAX package's CPU tests run them):
    the meshed port's losses within rtol 1e-4 and every slot's params
    within atol 2e-3 (``tests/test_torch_mesh.py``)."""
    shape, fields, jtx, ptx = JAX_PATHS[path]
    topo = request.getfixturevalue(f"topo{shape[0]}x{shape[1]}")
    x, y = _data()
    cfg = dict(num_parties=shape[0], workers_per_party=shape[1],
               precision="fp32", **fields)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo, jtx(), config=JaxConfig(**cfg),
                    mesh=topo.build_mesh(), donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    mt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(*shape), ptx(), config=GeoConfig(**cfg),
                 mesh=cpu_mesh(*shape))
    params, stats = from_flax(p0, s0)
    ms = mt.init_state(params=params, model_state=stats)
    plosses = []
    for xb, yb in mt.make_loader(x, y, 8, seed=0).epoch(0):
        ms, mm = mt.train_step(ms, xb, yb)
        plosses.append(float(mm["loss"]))
    print(f"{path}: losses port (meshed) {plosses} jax {jlosses}")
    assert len(plosses) == len(jlosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    jparams = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                       jst.params))
    for p, w, _ in mt.mesh.slots():
        for k, v in ms.slot(p, w).params.items():
            np.testing.assert_allclose(v[0, 0].numpy(), jparams[k],
                                       atol=2e-3, err_msg=f"({p}, {w}) {k}")


# ---- the repairs: shared compressors under slot threads --------------------

def _stress(fn, mesh, args, rounds: int = 20):
    """``run_on_mesh(fn)`` ``rounds`` times on a 1 us interpreter switch
    interval, so the slot threads interleave between any two lines."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        return [pc.run_on_mesh(fn, mesh, args) for _ in range(rounds)]
    finally:
        sys.setswitchinterval(interval)


def _distinct(shape, n, seed):
    """A ``[P, W, n]`` gradient whose rows differ from slot to slot."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape + (n,), generator=g)


@pytest.mark.parametrize("lattice", [False, True])
def test_twobit_reads_its_own_wire_under_slot_threads(lattice):
    """F6: one 2-bit compressor serves every slot; each slot's sum and
    residual are the stacked all-reduce's block for slot-distinct
    operands (a slot reading the shared record would sum another
    worker's words), and ``last_wire`` is slot (0, 0)'s block of the
    stacked wire."""
    mesh = cpu_mesh(2, 4)
    g, r = _distinct((2, 4), 3000, 1), _distinct((2, 4), 3000, 2) * 0.25
    comp = TwoBitCompressor(0.5, sparse_agg=lattice)
    want, want_r = comp.allreduce_leaf(g, r, DC_AXIS, 2)
    stacked_wire = comp.last_wire
    comp.last_wire = None
    args = list(zip(mesh.place(g).slots, mesh.place(r).slots))

    def program(gs, rs):
        return comp.allreduce_leaf(gs, rs, DC_AXIS, 2)
    for outs in _stress(program, mesh, args):
        assert torch.equal(mesh.gather(PlacedTree(mesh, [o[0] for o in outs])),
                           want)
        assert torch.equal(mesh.gather(PlacedTree(mesh, [o[1] for o in outs])),
                           want_r)
        assert torch.equal(comp.last_wire, stacked_wire[:1, :1])


def test_sparse_agg_record_is_slot_zeros_under_slot_threads():
    """F8: the BSC sparse_agg all-reduce on one compressor from every
    slot: each slot's sum and error-feedback state are the stacked
    block, and ``last_wire`` holds slot (0, 0)'s record (the stacked
    record's [0, 0] block), never another slot's; the stacked record's
    ``wire_stats`` are unchanged by a meshed run."""
    mesh = cpu_mesh(4, 2)
    n = 4096
    g = _distinct((4, 2), n, 3)
    state = (torch.zeros(4, 2, n), torch.zeros(4, 2, n))
    comp = BiSparseCompressor(0.01, select="sampled", sparse_agg=True)
    want, (wu, wv) = comp.allreduce_leaf(g, state, DC_AXIS, 4)
    stacked = comp.last_wire
    stats = psa.wire_stats(stacked)
    args = list(zip(mesh.place(g).slots, mesh.place(state[0]).slots,
                    mesh.place(state[1]).slots))

    def program(gs, us, vs):
        return comp.allreduce_leaf(gs, (us, vs), DC_AXIS, 4)
    for outs in _stress(program, mesh, args):
        got = [mesh.gather(PlacedTree(mesh, [o[0] for o in outs])),
               mesh.gather(PlacedTree(mesh, [o[1][0] for o in outs])),
               mesh.gather(PlacedTree(mesh, [o[1][1] for o in outs]))]
        for a, b in zip(got, (want, wu, wv)):
            assert torch.equal(a, b)
        rec = comp.last_wire
        assert sorted(rec) == sorted(stacked)
        for k in ("overflow_idx", "merged_idx", "kept_idx"):
            assert torch.equal(rec[k], stacked[k][:1, :1]), k
    assert psa.wire_stats(stacked) == stats


def _sparse_allreduce(vals, idx, n, axis_size):
    comp = BiSparseCompressor(0.01, select="sampled", sparse_agg=True)
    return psa.sparse_allreduce(vals, idx, n, DC_AXIS, axis_size,
                                comp.decompress)[0]


@pytest.mark.parametrize("axis_size", [4, 2])
def test_meshed_sparse_allreduce_checks_the_slots_axis_size(axis_size):
    """F7: inside a slot the operand is [1, 1, k], so the axis size comes
    from the slot: the meshed all-reduce gives the stacked bits at the
    right size, and a wrong ``axis_size`` raises inside a slot as it
    does stacked."""
    mesh = cpu_mesh(4, 2)
    n, k = 1000, 40
    rng = np.random.RandomState(4)
    idx = torch.from_numpy(np.stack([rng.permutation(n)[:k] for _ in
                                     range(8)]).reshape(4, 2, k)
                           .astype(np.int32))
    vals = torch.from_numpy(rng.randn(4, 2, k).astype(np.float32))
    args = list(zip(mesh.place(vals).slots, mesh.place(idx).slots))

    def program(v, i):
        return _sparse_allreduce(v, i, n, axis_size)
    if axis_size != 4:
        with pytest.raises(ValueError, match="has 4 replicas, not "
                           "axis_size=2") as stacked:
            _sparse_allreduce(vals, idx, n, axis_size)
        with pytest.raises(ValueError) as meshed:
            pc.run_on_mesh(program, mesh, args)
        assert str(meshed.value) == str(stacked.value)
        return
    outs = pc.run_on_mesh(program, mesh, args)
    assert torch.equal(mesh.gather(PlacedTree(mesh, outs)),
                       _sparse_allreduce(vals, idx, n, 4))


# ---- MultiGPS: a slot holds its worker's shards ------------------------------

def test_multigps_slot_holds_its_workers_shards():
    """The meshed MultiGPS state is shaped by the step's plan: a slot's
    optimizer state holds worker w's ``ceil(n / W)`` shard of every big
    leaf (the stacked plan's [p, w] row after a step) and the whole of
    every small one."""
    x, y = _data(5, 128, 8)
    cfg = GeoConfig(num_parties=2, workers_per_party=4, precision="fp32",
                    compression="bsc,0.01,select=sampled,min_sparse_size=256",
                    multi_gps=True, bigarray_bound=1000)

    def trainer(mesh=None):
        kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
        return Trainer(MLP(hidden=(32,)), HiPSTopology(2, 4),
                       sgd(0.1, momentum=0.9), config=cfg, **kw)
    st, mt = trainer(), trainer(cpu_mesh())
    assert mt._mgps is not None and st._mgps is not None
    ss = st.init_state(seed=0, sample_input=x[:2])
    ms = mt.init_state(seed=0, sample_input=x[:2])
    for xb, yb in list(st.make_loader(x, y, 4, seed=0).epoch(0))[:2]:
        ss, _ = st.train_step(ss, xb, yb)
        ms, _ = mt.train_step(ms, xb, yb)
    plan = mt._mgps
    trace = ms.slot(1, 2).opt_state["trace"]
    big = [k for k, p in ss.params.items() if plan.is_big(p[0, 0].numel())]
    assert big and len(big) < len(ss.params)
    for k, p in ss.params.items():
        n = p[0, 0].numel()
        want = (1, 1, plan.shard_len(n)) if k in big else (1, 1) + p.shape[2:]
        assert tuple(trace[k].shape) == want, k
    for p_, w, _ in mt.mesh.slots():
        for (k, a), (_, b) in zip(tensors_of(ms.slot(p_, w).opt_state),
                                  tensors_of(ss.opt_state)):
            assert torch.equal(a[0, 0], b[p_, w]), (p_, w, k)
    assert not torch.equal(ms.slot(0, 0).opt_state["trace"][big[0]],
                           ms.slot(0, 1).opt_state["trace"][big[0]])
    assert_bits_equal(mt.mesh.gather(ms), ss, "multigps")


# ---- the composition errors are the stacked ones ------------------------------

COMPOSITIONS = {
    "pipeline_multigps": dict(pipeline_depth=1, multi_gps=True),
    "hfa_pipeline": dict(sync_mode="hfa", pipeline_depth=1),
    "hfa_zero": dict(sync_mode="hfa", zero=True),
    "zero_multigps": dict(zero=True, multi_gps=True),
    "mixed_multigps": dict(sync_mode="mixed", multi_gps=True),
    "fused_multigps": dict(fused_optim=True, multi_gps=True),
    "zero_pipeline_dcasgd": dict(zero=True, pipeline_depth=1,
                                 pipeline_dcasgd=0.1),
}


@pytest.mark.parametrize("case", sorted(COMPOSITIONS))
def test_composition_errors_are_the_stacked_ones(case):
    """A composition the stacked step refuses raises under a mesh too,
    with the same type and message."""
    fields = dict(num_parties=2, workers_per_party=4, compression=BSC,
                  **COMPOSITIONS[case])
    tx = po.fused_optimizer("sgd", learning_rate=0.1) \
        if fields.get("fused_optim") else sgd(0.1)

    def build(mesh=None):
        kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
        return Trainer(MLP(hidden=(8,)), HiPSTopology(2, 4), tx,
                       config=GeoConfig(**fields), **kw)
    with pytest.raises(ValueError) as stacked:
        build()
    with pytest.raises(ValueError) as meshed:
        build(cpu_mesh())
    assert str(meshed.value) == str(stacked.value)


def test_fused_drain_raises_under_a_mesh_as_stacked():
    """The pipeline's drain under the fused apply raises ValueError in
    both packages, stacked or meshed (Queue 3, "The drain under the
    fused apply")."""
    x, _ = _data(6, 16, 8)
    cfg = GeoConfig(num_parties=2, workers_per_party=4, compression=BSC,
                    pipeline_depth=1, fused_optim=True)
    errors = []
    for kw in (dict(device="cpu"), dict(mesh=cpu_mesh())):
        t = Trainer(MLP(hidden=(8,)), HiPSTopology(2, 4),
                    po.fused_optimizer("sgd", learning_rate=0.1),
                    config=cfg, **kw)
        with pytest.raises(ValueError, match="GEOMX_FUSED_OPTIM") as e:
            t.drain_pipeline(t.init_state(seed=0, sample_input=x[:2]))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_sp_and_membership_still_refuse():
    """What stays open refuses through the Queue 1 item's title."""
    with pytest.raises(NotImplementedError, match=ITEM):
        HiPSTopology(2, 4, sp_degree=2).build_mesh(["cpu"] * 16)
    from geomx_tpu_torch.train.step import mesh_refusal
    sync = FSA().bind_topology(HiPSTopology(2, 4)) \
        .bind_membership((True, False))
    with pytest.raises(NotImplementedError, match=ITEM):
        mesh_refusal(sync)
    with pytest.raises(NotImplementedError, match=ITEM):
        mesh_refusal(FSA(), sp_model=True)
    mesh_refusal(_fsa_worker_2bit())  # no longer refused
