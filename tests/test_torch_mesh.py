"""Port parity: the replica axes on a device mesh (geomx_tpu_torch's
``ReplicaMesh`` and ``run_on_mesh`` against the stacked port path and
the JAX package's ``shard_map`` on the conftest 2x4 mesh).

The CPU has one torch device, so the port's meshes here repeat it
(``["cpu"] * 8``), as the conftest forces 8 host devices for JAX.  A
meshed collective gathers the slots' operands, runs the stacked function
on the full stack and hands each slot its block: every result below is
the stacked path's bits, and the JAX comparisons keep the tolerances of
``tests/test_torch_train.py``.  Every rendezvous timeout is short, so a
fault fails a test in seconds instead of hanging the suite.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_train import FILTERS, STAGES

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas as jo
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.topology import HiPSTopology as JaxTopology
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.models import MLP, ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as po
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.parallel import collectives as pc
from geomx_tpu_torch.topology import PlacedTree, ReplicaMesh
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

TIMEOUT_S = 20.0  # no rendezvous of these tests waits longer


def cpu_mesh(P_=2, W_=4, timeout_s=TIMEOUT_S) -> ReplicaMesh:
    return HiPSTopology(P_, W_).build_mesh(["cpu"] * (P_ * W_),
                                           timeout_s=timeout_s)


def tensors_of(tree, path=""):
    """(path, tensor) pairs of a state tree (a dataclass, dicts, lists),
    in a fixed order."""
    if dataclasses.is_dataclass(tree):
        tree = dataclasses.asdict(tree)
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in tensors_of(tree[k], f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, e in enumerate(tree)
                for x in tensors_of(e, f"{path}[{i}]")]
    return []


def assert_bits_equal(a, b, what=""):
    ta, tb = tensors_of(a), tensors_of(b)
    assert a.step == b.step, what
    assert [k for k, _ in ta] == [k for k, _ in tb], what
    for (k, u), (_, v) in zip(ta, tb):
        assert u.shape == v.shape and u.dtype == v.dtype, f"{what} {k}"
        if u.is_floating_point():
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v), f"{what} {k}"


# ---- the topology and the mesh -----------------------------------------------

@pytest.mark.parametrize("n,parties", [(8, None), (8, 4), (6, None), (3, None),
                                       (1, None), (6, 4), (8, 3)])
def test_from_devices_splits_as_jax(n, parties):
    """The same split of the same device count, or the same ValueError."""
    jdev = jax.devices()[:n]
    try:
        want = JaxTopology.from_devices(parties, devices=jdev)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            HiPSTopology.from_devices(parties, devices=["cpu"] * n)
        assert str(got.value) == str(e)
        return
    got = HiPSTopology.from_devices(parties, devices=["cpu"] * n)
    assert (got.num_parties, got.workers_per_party) == \
        (want.num_parties, want.workers_per_party)


@pytest.mark.parametrize("shape,n", [((2, 4), 8), ((4, 2), 8), ((2, 2), 8),
                                     ((2, 4), 6), ((1, 1), 0)])
def test_build_mesh_matches_jax(shape, n):
    """The [P, W] grid takes ``devices[:P * W]`` in the JAX mesh's order;
    too few devices raise the JAX package's ValueError."""
    jdev, tdev = jax.devices()[:n], [torch.device("cpu")] * n
    try:
        jmesh = JaxTopology(*shape).build_mesh(jdev)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            HiPSTopology(*shape).build_mesh(tdev)
        assert str(got.value) == str(e)
        return
    mesh = HiPSTopology(*shape).build_mesh(tdev)
    assert mesh.shape == jmesh.devices.shape == shape
    assert mesh.axis_names == tuple(jmesh.axis_names) == (DC_AXIS,
                                                          WORKER_AXIS)
    order = [[d.id for d in row] for row in jmesh.devices]
    assert order == [[p * shape[1] + w for w in range(shape[1])]
                     for p in range(shape[0])]
    assert [(p, w) for p, w, _ in mesh.slots()] == \
        [(p, w) for p in range(shape[0]) for w in range(shape[1])]


def test_build_mesh_takes_the_cards_and_never_the_cpu(monkeypatch):
    """No devices: ``cuda:0 .. cuda:n-1``, raising with fewer cards than
    slots; an sp mesh lays its ``[P, W, S]`` slots out as the JAX
    package's ``build_mesh`` does on the conftest's virtual devices, sp
    innermost."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="needs 8 devices, only 3"):
        HiPSTopology(2, 4).build_mesh()
    mesh = HiPSTopology(1, 2).build_mesh()
    assert [d for _, _, d in mesh.slots()] == [torch.device("cuda", 0),
                                               torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 1 devices, only 0"):
        HiPSTopology(1, 1).build_mesh()
    for shape in ((1, 2, 2), (2, 2, 2), (1, 1, 4)):
        jmesh = JaxTopology(*shape).build_mesh(jax.devices())
        mesh = HiPSTopology(*shape).build_mesh(["cpu"] * 8)
        assert (mesh.shape + (mesh.sp,)) == jmesh.devices.shape == shape
        assert mesh.axis_names == tuple(jmesh.axis_names)
        ids = [d.id for d in jmesh.devices.reshape(-1)]
        assert [mesh.index(p, w, s) for p, w, s, _ in mesh.slot_coords()] \
            == ids == list(range(mesh.size))
        for p, w, s, _ in mesh.slot_coords():
            assert jmesh.devices[p, w, s].id == mesh.index(p, w, s)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = HiPSTopology(1, 2, sp_degree=2).build_mesh()
    assert [d.index for _, _, _, d in mesh.slot_coords()] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="needs 8 devices, only 4"):
        HiPSTopology(2, 2, sp_degree=2).build_mesh()


def test_place_and_gather_round_trip():
    """``place`` splits every [P, W] leaf of a tree (a dataclass, dicts,
    lists) into independent [1, 1] copies; ``gather`` stacks them back
    bit for bit; other leaves pass through."""
    from geomx_tpu_torch.train.state import TrainState
    mesh = cpu_mesh()
    g = torch.Generator().manual_seed(0)
    st = TrainState(step=3, params={"a": torch.randn(2, 4, 5, generator=g)},
                    opt_state={"count": 7, "mu": [torch.randn(2, 4, 3,
                                                              generator=g)]},
                    model_state={"s": torch.randn(2, 4, generator=g)},
                    sync_state=())
    placed = mesh.place(st)
    assert isinstance(placed, PlacedTree) and len(placed.slots) == 8
    assert mesh.place(placed) is placed
    s12 = placed.slot(1, 2)
    assert s12.step == 3 and s12.opt_state["count"] == 7
    assert s12.params["a"].shape == (1, 1, 5)
    assert torch.equal(s12.params["a"][0, 0], st.params["a"][1, 2])
    s12.params["a"].zero_()  # a copy: the stacked tensor is untouched
    assert st.params["a"][1, 2].abs().sum() > 0
    placed = mesh.place(st)
    assert_bits_equal(mesh.gather(placed), st)
    with pytest.raises(ValueError, match="replica axes"):
        mesh.place({"x": torch.zeros(4, 2)})


# ---- the collectives ---------------------------------------------------------

def _collectives(a, d, w, P_, W_):
    """Every collective of the port on ``a`` ([P, W, 6]), ``d`` ([P, W,
    P, 3]) and ``w`` ([P, W, W, 3]), in a fixed order; inside a mesh
    slot each call meets the other slots (and the index helpers read the
    axis sizes from the slot)."""
    four = torch.cat([a] * 4, -1)
    return (pc.psum(a, WORKER_AXIS), pc.psum(a, DC_AXIS),
            pc.pmean(a, WORKER_AXIS), pc.pmean(a, DC_AXIS),
            pc.hier_psum(a), pc.hier_pmean(a),
            pc.psum_scatter(four, WORKER_AXIS),
            pc.psum_scatter(four, DC_AXIS),
            pc.all_gather(a, DC_AXIS), pc.all_gather(a, WORKER_AXIS),
            pc.all_gather(a, WORKER_AXIS, tiled=True),
            pc.pmax(a, DC_AXIS), pc.pmax(a, WORKER_AXIS),
            pc.all_to_all(d, DC_AXIS), pc.all_to_all(w, WORKER_AXIS),
            pc.party_index(P_, W_), pc.worker_index(P_, W_),
            pc.global_worker_rank(P_, W_))


NAMES = ("psum worker", "psum dc", "pmean worker", "pmean dc", "hier_psum",
         "hier_pmean", "psum_scatter worker", "psum_scatter dc",
         "all_gather dc", "all_gather worker", "all_gather worker tiled",
         "pmax dc", "pmax worker", "all_to_all dc", "all_to_all worker",
         "party_index", "worker_index", "global_worker_rank")


def _jax_collectives(a, d, w, P_, W_):
    """The JAX package's per-device counterparts, in NAMES' order."""
    lax = jax.lax
    four = jnp.concatenate([a] * 4, -1)

    def scatter(x, axis, n):
        return lax.psum_scatter(x.reshape(n, -1), axis, scatter_dimension=0,
                                tiled=True).reshape(-1)
    from geomx_tpu.parallel import collectives as jc
    return (jc.psum_worker(a), jc.psum_dc(a), jc.pmean_worker(a),
            jc.pmean_dc(a), jc.hier_psum(a), jc.hier_pmean(a),
            scatter(four, WORKER_AXIS, W_), scatter(four, DC_AXIS, P_),
            lax.all_gather(a, DC_AXIS), lax.all_gather(a, WORKER_AXIS),
            lax.all_gather(a, WORKER_AXIS, tiled=True),
            lax.pmax(a, DC_AXIS), lax.pmax(a, WORKER_AXIS),
            lax.all_to_all(d, DC_AXIS, 0, 0),
            lax.all_to_all(w, WORKER_AXIS, 0, 0),
            jc.party_index(), jc.worker_index(), jc.global_worker_rank())


@pytest.mark.parametrize("topo_name", ["topo2x4", "topo4x2"])
def test_meshed_collectives_match_stacked_and_jax(request, topo_name):
    """Each collective run one program a slot on ``["cpu"] * 8`` gives,
    gathered, the stacked port function's bits on the same stack (the
    index helpers the stacked ones at the global [P, W]), and the JAX
    package's ``shard_map`` collective on its mesh: integer-valued
    inputs, so every sum is exact in any order."""
    topo = request.getfixturevalue(topo_name)
    P_, W_ = topo.num_parties, topo.workers_per_party
    rng = np.random.RandomState(5)
    a = rng.randint(-50, 50, (P_, W_, 6)).astype(np.float32)
    d = rng.randint(-50, 50, (P_, W_, P_, 3)).astype(np.float32)
    w = rng.randint(-50, 50, (P_, W_, W_, 3)).astype(np.float32)
    ta, td, tw = (torch.from_numpy(v) for v in (a, d, w))

    mesh = cpu_mesh(P_, W_)
    args = [blocks + (1, 1) for blocks in
            zip(*(mesh.place(t).slots for t in (ta, td, tw)))]
    outs = pc.run_on_mesh(_collectives, mesh, args)
    meshed = [mesh.gather(PlacedTree(mesh, [o[i] for o in outs]))
              for i in range(len(NAMES))]
    stacked = _collectives(ta, td, tw, P_, W_)
    spec = P(DC_AXIS, WORKER_AXIS)

    def device(x, y, z):
        out = _jax_collectives(x[0, 0], y[0, 0], z[0, 0], P_, W_)
        return tuple(o[None, None] for o in out)

    ref = jax.jit(shard_map_compat(device, topo.build_mesh(),
                                   in_specs=(spec,) * 3,
                                   out_specs=(spec,) * len(NAMES)))(a, d, w)
    for name, m, s, r in zip(NAMES, meshed, stacked, ref):
        assert m.shape == s.shape, name
        assert torch.equal(m, s), f"{name}: meshed vs stacked"
        np.testing.assert_array_equal(m.numpy(), np.asarray(r),
                                      err_msg=f"{name}: vs JAX")


@pytest.mark.parametrize("fault", ["raises", "absent", "diverges"])
def test_a_failing_slot_fails_run_on_mesh_without_a_hang(fault):
    """A slot that raises before its collective aborts the rendezvous, so
    every waiting slot raises at once and ``run_on_mesh`` re-raises the
    slot's own error; a slot that never comes fails the others after the
    mesh's timeout; slots calling different collectives fail at the
    meeting."""
    mesh = cpu_mesh(timeout_s=2.0 if fault == "absent" else TIMEOUT_S)
    x = mesh.place(torch.arange(8.0).view(2, 4, 1))

    def program(v):
        slot = pc.current_slot()
        if (slot.p, slot.w) == (1, 2):
            if fault == "raises":
                raise KeyError("slot (1, 2) failed")
            if fault == "absent":
                return v
            return pc.pmax(v, WORKER_AXIS)
        return pc.psum(v, WORKER_AXIS)

    want = {"raises": (KeyError, "slot \\(1, 2\\) failed"),
            "absent": (RuntimeError, "waited 2.0 s at a collective"),
            "diverges": (RuntimeError, "diverged at a collective")}[fault]
    t0 = time.perf_counter()
    with pytest.raises(want[0], match=want[1]):
        pc.run_on_mesh(program, mesh, [(s,) for s in x.slots])
    took = time.perf_counter() - t0
    assert took < (5.0 if fault == "absent" else 2.0), took
    # the mesh stays usable: a new launch meets a new rendezvous
    outs = pc.run_on_mesh(lambda v: pc.psum(v, WORKER_AXIS), mesh,
                          [(s,) for s in x.slots])
    assert torch.equal(mesh.gather(PlacedTree(mesh, outs)),
                       pc.psum(torch.arange(8.0).view(2, 4, 1), WORKER_AXIS))
    assert pc.current_slot() is None


def test_slot_counts_and_rendezvous_hold_under_thread_stress():
    """16 slot threads (more than the cores) on a 1 us interpreter switch
    interval: every counted launch lands in the process total and in its
    slot's tally, and 100 rendezvous in a row give exact sums."""
    import sys

    from geomx_tpu_torch.ops import _launches

    def wrapper():
        pass
    wrapper.launches = 0
    mesh = cpu_mesh(4, 4)
    x = mesh.place(torch.ones(4, 4, 2))

    def program(v):
        for _ in range(100):
            _launches.count(wrapper)
            _launches.count(wrapper, 2)
            v = pc.psum(v, WORKER_AXIS) - 3.0
        return v

    interval = sys.getswitchinterval()
    _launches.reset_slots()
    sys.setswitchinterval(1e-6)
    try:
        outs = pc.run_on_mesh(program, mesh, [(s,) for s in x.slots])
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 300
    tallies = _launches.by_slot()
    _launches.reset_slots()
    assert sorted(tallies) == [(p, w) for p in range(4) for w in range(4)]
    assert all(t == {wrapper: 300} for t in tallies.values())
    assert all(torch.equal(o, torch.ones(1, 1, 2)) for o in outs)


# ---- the three paths through the Trainer --------------------------------------

# path -> (GeoConfig fields, JAX optimizer, port optimizer)
MESH_PATHS = {
    "fsa_bsc": (dict(compression="bsc,0.01,select=sampled"),
                lambda: optax.sgd(0.1, momentum=0.9),
                lambda: sgd(0.1, momentum=0.9)),
    "fused_sgd": (dict(compression="bsc,0.01,select=sampled",
                       fused_optim=True),
                  lambda: jo.fused_optimizer("sgd", learning_rate=0.1),
                  lambda: po.fused_optimizer("sgd", learning_rate=0.1)),
    "zero_sgd": (dict(compression="bsc,0.01,select=sampled", zero=True),
                 lambda: optax.sgd(0.1, momentum=0.9),
                 lambda: sgd(0.1, momentum=0.9)),
}


def _data(seed=11, n=192, hw=16):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8)
    y = rng.randint(0, 10, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("path", sorted(MESH_PATHS))
def test_meshed_paths_equal_stacked_and_track_jax(topo2x4, mesh2x4, path):
    """Three fp32 steps of a small ResNet from the JAX Trainer's weights
    on paths 1, 1f and ZeRO: the meshed state (gathered) and loss are the
    stacked port path's bits after every step; losses within rtol 1e-4
    and params within atol 2e-3 of the JAX Trainer on its 2x4 mesh
    (``tests/test_torch_train.py:146,162``)."""
    fields, jtx, ptx = MESH_PATHS[path]
    x, y = _data()
    cfg = dict(num_parties=2, workers_per_party=4, precision="fp32",
               **fields)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo2x4, jtx(), config=JaxConfig(**cfg), mesh=mesh2x4,
                    donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    def port(mesh):
        kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
        t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                    HiPSTopology(2, 4), ptx(), config=GeoConfig(**cfg), **kw)
        params, stats = from_flax(p0, s0)
        return t, t.init_state(params=params, model_state=stats)

    st_t, st = port(None)
    mt, ms = port(cpu_mesh())
    assert isinstance(ms, PlacedTree)
    assert ms.slots[0].params[next(iter(st.params))].shape[:2] == (1, 1)
    plosses = []
    for i, (xb, yb) in enumerate(st_t.make_loader(x, y, 8, seed=0).epoch(0)):
        st, sm = st_t.train_step(st, xb, yb)
        ms, mm = mt.train_step(ms, xb, yb)
        assert float(mm["loss"]) == float(sm["loss"]), i
        assert mm["loss"].shape == () and float(mm["accuracy"]) == \
            float(sm["accuracy"])
        assert_bits_equal(mt.mesh.gather(ms), st, f"step {i + 1}")
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
    # evaluation runs on slot (0, 0)'s copy, as on the stacked state's
    assert mt.evaluate(ms, x[:32], y[:32]) == st_t.evaluate(st, x[:32],
                                                           y[:32])


def _mlp_trainer(mesh=None, **fields):
    cfg = GeoConfig(**{**dict(
        num_parties=2, workers_per_party=4, precision="fp32",
        compression="bsc,0.01,select=sampled,min_sparse_size=256"),
        **fields})
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    return Trainer(MLP(hidden=(32,)), HiPSTopology(2, 4),
                   sgd(0.1, momentum=0.9), config=cfg, **kw)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tensors_of(tree))


def test_zero_slot_holds_one_worker_shard_of_the_optimizer_state():
    """Under ZeRO on the mesh a slot holds worker w's 1/W shard of every
    bucket: its optimizer state is 1/W of the stacked replicated state's
    bytes a replica (up to the lane padding of the bucket), and slot (p,
    w)'s shard is the stacked ZeRO state's (p, w) row."""
    x, y = _data(3, 64, 8)
    mesh = cpu_mesh()
    zt, rt = _mlp_trainer(mesh, zero=True), _mlp_trainer()
    zs, rs = zt.init_state(seed=0, sample_input=x[:2]), \
        rt.init_state(seed=0, sample_input=x[:2])
    stacked_zero = _mlp_trainer(zero=True)
    ss = stacked_zero.init_state(seed=0, sample_input=x[:2])
    for xb, yb in list(rt.make_loader(x, y, 4, seed=0).epoch(0))[:2]:
        zs, _ = zt.train_step(zs, xb, yb)
        ss, _ = stacked_zero.train_step(ss, xb, yb)
    replica = _bytes(rs.opt_state) / 8
    slot = _bytes(zs.slots[0].opt_state)
    n = sum(t.numel() for t in rs.params.values()) / 8
    padded = zt._zero_plan.bucketed.zero_bucketer(
        [rs.params[k] for k in sorted(rs.params)]).bucket_sizes
    assert slot == 4 * sum(padded) / 4
    assert replica == 4 * n
    assert 1 / 4 <= slot / replica < 1 / 4 * (1 + 512 / n)
    for p, w, _ in mesh.slots():
        for (k, a), (_, b) in zip(tensors_of(zs.slot(p, w).opt_state),
                                  tensors_of(ss.opt_state)):
            assert torch.equal(a[0, 0], b[p, w]), (p, w, k)
    assert not torch.equal(
        zs.slot(0, 0).opt_state["trace"][0][0, 0],
        zs.slot(0, 1).opt_state["trace"][0][0, 0])


def test_meshed_fit_checkpoint_reads_back_into_a_stacked_trainer(tmp_path):
    """``fit`` on the mesh (each batch scattered to the slots) gives the
    stacked fit's state; its checkpoint loads bit for bit into a stacked
    trainer, and back into a meshed one through a placed template."""
    x, y = _data(4, 64, 8)
    mt, st = _mlp_trainer(cpu_mesh()), _mlp_trainer()
    ms = mt.init_state(seed=0, sample_input=x[:2])
    ss = st.init_state(seed=0, sample_input=x[:2])
    ms, mrec = mt.fit(ms, mt.make_loader(x, y, 4, seed=0), epochs=1,
                      log_every=1, log_fn=lambda s: None)
    ss, srec = st.fit(ss, st.make_loader(x, y, 4, seed=0), epochs=1,
                      log_every=1, log_fn=lambda s: None)
    assert [r["loss"] for r in mrec] == [r["loss"] for r in srec]
    assert isinstance(ms, PlacedTree)
    assert_bits_equal(mt.mesh.gather(ms), ss, "after fit")
    path = mt.save_checkpoint(str(tmp_path / "mesh.ckpt"), ms)
    loaded = st.load_checkpoint(path, st.init_state(seed=1,
                                                    sample_input=x[:2]))
    assert_bits_equal(loaded, ss, "stacked load")
    back = mt.load_checkpoint(path, mt.init_state(seed=1,
                                                  sample_input=x[:2]))
    assert isinstance(back, PlacedTree)
    assert_bits_equal(mt.mesh.gather(back), ss, "meshed load")


def _decision(kind: str, value):
    from geomx_tpu_torch.control.policy import Decision
    return Decision(step=0, kind=kind, value=value, prev=None, reason="test")


def twin_steps(st, mt, ss, ms, batches, what, meshed_batches=None):
    """Each batch through a stacked and a meshed trainer: the same loss
    and accuracy, and the gathered meshed state the stacked bits after
    every step.  Returns both states and the last metrics."""
    sm = mm = None
    for i, (xb, yb) in enumerate(batches):
        mx, my = (xb, yb) if meshed_batches is None else meshed_batches[i]
        ss, sm = st.train_step(ss, xb, yb)
        ms, mm = mt.train_step(ms, mx, my)
        assert float(mm["loss"]) == float(sm["loss"]), (what, i)
        assert float(mm["accuracy"]) == float(sm["accuracy"]), (what, i)
        assert float(mm["num_live_parties"]) == \
            float(sm["num_live_parties"])
        assert_bits_equal(mt.mesh.gather(ms), ss, f"{what} step {i + 1}")
    return ss, ms, sm, mm


def _sp_parity():
    """A small ring SeqClassifier on [1, 2] x sp 2, meshed and stacked:
    losses within 2e-4 and params within 2e-3 (tests/test_torch_seq.py's
    tolerances: the shards sum in another order)."""
    from geomx_tpu_torch.models import SeqClassifier
    from geomx_tpu_torch.sync import FSA
    mk = dict(vocab=32, max_len=32, dim=16, num_heads=2, num_layers=1,
              num_classes=4)
    topo = HiPSTopology(1, 2, sp_degree=2)
    rng = np.random.RandomState(2)
    tok = rng.randint(0, 32, (2, 1, 2, 2, 32))
    pos = np.broadcast_to(np.arange(32), tok.shape)
    xs = torch.from_numpy(np.stack([tok, pos], -1).astype(np.int32))
    ys = torch.from_numpy(rng.randint(0, 4, (2, 1, 2, 2))).long()

    def trainer(mesh):
        kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
        return Trainer(SeqClassifier(sp_mode="ring", **mk), topo, sgd(0.1),
                       sync=FSA(), single_device_model=SeqClassifier(**mk),
                       **kw)
    st = trainer(None)
    mt = trainer(topo.build_mesh(["cpu"] * 4, timeout_s=TIMEOUT_S))
    ss, ms = st.init_state(seed=0), mt.init_state(seed=0)
    assert len(ms.slots) == 4 and mt.mesh.sp == 2
    for xb, yb in zip(xs, ys):
        ss, sm = st.train_step(ss, xb, yb)
        ms, mm = mt.train_step(ms, xb, yb)
        np.testing.assert_allclose(float(mm["loss"]), float(sm["loss"]),
                                   rtol=2e-4, atol=2e-4)
    got = mt.mesh.gather(ms)
    for k, v in ss.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), v.numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("case", [
    "telemetry", "control", "audit", "flight", "membership", "catchup",
    "device_cache", "scan_epochs", "sp"])
def test_refusals_under_a_mesh(case, monkeypatch, tmp_path):
    """What the mesh refused until "Device mesh: the other paths" closed
    runs there and gives the stacked trainer's bits: the probe dict,
    ratio and depth actuations, the audit signature of a swap (and a
    refused divergence), the flight recorder's records, a membership
    blackout and return, a catch-up, the device-cached batches and the
    scanned epoch; sp within the tolerances of tests/test_torch_seq.py
    (tests/test_torch_mesh_sp.py holds the sp mesh at length)."""
    from geomx_tpu_torch.telemetry.probes import host_probes
    for var in ("GEOMX_TELEMETRY", "GEOMX_CONTROL", "GEOMX_AUDIT",
                "GEOMX_FLIGHT", "GEOMX_CAPSULE"):
        monkeypatch.delenv(var, raising=False)
    if case == "sp":
        _sp_parity()
        return
    fields = {"telemetry": dict(telemetry=True),
              "control": dict(control=True),
              "audit": dict(audit=True),
              "flight": dict(telemetry=True, flight=True,
                             flight_dir=str(tmp_path))}.get(case, {})
    x, y = _data(5, 128, 8)
    st, mt = _mlp_trainer(**fields), _mlp_trainer(cpu_mesh(), **fields)
    ss = st.init_state(seed=0, sample_input=x[:2])
    ms = mt.init_state(seed=0, sample_input=x[:2])
    batches = list(st.make_loader(x, y, 4, seed=0).epoch(0))
    assert len(batches) == 4
    if case == "telemetry":
        ss, ms, sm, mm = twin_steps(st, mt, ss, ms, batches, case)
        assert host_probes(mm["telemetry"]) == host_probes(sm["telemetry"])
    elif case == "control":
        ss, ms, _, _ = twin_steps(st, mt, ss, ms, batches[:1], case)
        for d in (_decision("ratio", 0.005), _decision("depth", 1), None,
                  _decision("depth", 0)):
            if d is not None:
                ss, ms = st.apply_control(ss, d), mt.apply_control(ms, d)
                assert_bits_equal(mt.mesh.gather(ms), ss, f"{d.kind}")
                assert all(torch.equal(s.sync_state["control"]
                                       ["bsc_ratio_scale"],
                                       ss.sync_state["control"]
                                       ["bsc_ratio_scale"])
                           for s in ms.slots)
            ss, ms, _, _ = twin_steps(st, mt, ss, ms, batches[1:2], case)
        assert mt.control_depth() == st.control_depth() == 0
    elif case == "audit":
        from geomx_tpu_torch.analysis import AuditError
        ss, _ = st.fit(ss, st.make_loader(x, y, 4, seed=0), epochs=1,
                       log_fn=lambda s: None)
        ms, _ = mt.fit(ms, mt.make_loader(x, y, 4, seed=0), epochs=1,
                       log_fn=lambda s: None)
        mask = (True, False)
        ss, ms = st.apply_membership(ss, mask), mt.apply_membership(ms, mask)
        assert mt._audit_sigs[None][0] == st._audit_sigs[None][0]
        assert mt._audit_sigs[mask] == st._audit_sigs[mask]
        assert len(mt._audit_sigs[mask][0]) > 0
        ss, ms = st.apply_membership(ss, (True, True)), \
            mt.apply_membership(ms, (True, True))
        for t, state in ((st, ss), (mt, ms)):
            sig, found = t._audit_sigs[None]
            t._audit_sigs[None] = (sig[:-1], found)
            step = t.train_step
            with pytest.raises(AuditError):
                t.apply_membership(state, mask)
            assert t.train_step is step and t._membership is None
    elif case == "flight":
        ss, _ = st.fit(ss, st.make_loader(x, y, 4, seed=0), epochs=1,
                       log_every=1, log_fn=lambda s: None)
        ms, _ = mt.fit(ms, mt.make_loader(x, y, 4, seed=0), epochs=1,
                       log_every=1, log_fn=lambda s: None)
        assert_bits_equal(mt.mesh.gather(ms), ss, "flight")
        got, want = mt._flight.snapshot(), st._flight.snapshot()
        assert len(got) == len(want) == 4 and got == want
    elif case == "membership":
        ss, ms, _, _ = twin_steps(st, mt, ss, ms, batches[:1], case)
        for mask, span in (((True, False), batches[1:3]),
                           ((True, True), batches[3:])):
            ss = st.apply_membership(ss, mask)
            ms = mt.apply_membership(ms, mask)
            assert_bits_equal(mt.mesh.gather(ms), ss, f"swap to {mask}")
            ss, ms, sm, _ = twin_steps(st, mt, ss, ms, span, f"{mask}")
            assert float(sm["num_live_parties"]) == sum(mask)
    elif case == "catchup":
        ss, ms, _, _ = twin_steps(st, mt, ss, ms, batches[:2], case)
        blob = mt.catchup_payload(ms)
        assert blob == st.catchup_payload(ss)
        back = mt.admit_party(blob)
        assert isinstance(back, PlacedTree)
        assert_bits_equal(mt.mesh.gather(back), st.admit_party(blob),
                          "admitted")
        twin_steps(st, mt, st.admit_party(blob), back, batches[2:], case)
    else:  # the device-cached loader, then the scanned epoch
        sl = st.make_loader(x, y, 4, seed=0, augment=True,
                            device_cache=True)
        ml = mt.make_loader(x, y, 4, seed=0, augment=True,
                            device_cache=True)
        if case == "device_cache":
            sb, mb = list(sl.epoch(1)), list(ml.epoch(1))
            for (sx, sy), (mx, my) in zip(sb, mb):
                assert isinstance(mx, PlacedTree)
                assert torch.equal(mt.mesh.gather(mx), sx)
                assert torch.equal(mt.mesh.gather(my), sy)
            twin_steps(st, mt, ss, ms, sb, case, meshed_batches=mb)
        else:
            ss, srec = st.fit(ss, sl, epochs=2, log_every=1,
                              scan_epochs=True, log_fn=lambda s: None)
            ms, mrec = mt.fit(ms, ml, epochs=2, log_every=1,
                              scan_epochs=True, log_fn=lambda s: None)
            assert [(r["loss"], r["train_acc"]) for r in mrec] == \
                [(r["loss"], r["train_acc"]) for r in srec]
            assert_bits_equal(mt.mesh.gather(ms), ss, "scanned epochs")


def test_mesh_arguments_are_checked():
    with pytest.raises(ValueError, match="device or a mesh"):
        _mlp_trainer(cpu_mesh()).__class__(
            MLP(hidden=(8,)), HiPSTopology(2, 4), sgd(0.1), device="cpu",
            mesh=cpu_mesh())
    with pytest.raises(ValueError, match="does not match"):
        Trainer(MLP(hidden=(8,)), HiPSTopology(2, 4), sgd(0.1),
                mesh=cpu_mesh(4, 2))
