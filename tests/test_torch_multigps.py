"""Port parity: MultiGPS, the sharded update of the big leaves
(geomx_tpu_torch vs geomx_tpu on the conftest 2x4 mesh): the reference's
placement, ``MultiGPSPlan``'s shard ops, three Trainer steps of each
MultiGPS path and the composition checks.

Tolerances: ``partition`` and the composition errors exactly; the shard
ops bit for bit on dyadic inputs (signed powers of two that sum without
rounding); the Trainer cases to the other Trainer parity tests' bounds,
losses rtol 1e-4 and params atol 2e-3 (convolution sums differ in order
between the packages).  Under Adam a coordinate whose gradient is within
rounding of zero steps by about the learning rate either way, so there
the coordinates beyond 2e-3 are counted: at most 0.1% of them, each
within two steps' worth (6e-2 over three steps).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from test_torch_sync import on_mesh, port_leaves, powers
from test_torch_train import FILTERS, STAGES

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops import optim_pallas
from geomx_tpu.parallel import multigps as jax_mgps
from geomx_tpu.sync import FSA as JaxFSA
from geomx_tpu.sync import DGTCompressor as JaxDGT
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import WORKER_AXIS
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.compression import BiSparseCompressor, get_compressor
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import optim as port_optim
from geomx_tpu_torch.optim import adam, sgd
from geomx_tpu_torch.parallel import multigps as port_mgps
from geomx_tpu_torch.sync import FSA, DGTCompressor, get_sync_algorithm
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.tree import from_nested

torch.set_num_threads(2)

# a bound that makes the small ResNet's four 3x3 convs of 1,152 to 9,216
# elements big (shards of 288 to 2,304), the other 21 leaves replicated
BOUND = 1000


def test_partition_matches_jax():
    """The reference's placement over a grid of sizes, server counts and
    bounds: the same Placement records."""
    rng = np.random.RandomState(0)
    sizes = [0, 1, 7, 999, 1000, 1001, 4096, 36_864, 1_000_000, 1_000_003] \
        + list(rng.randint(1, 3_000_000, 40))
    for servers in (1, 2, 3, 4, 8):
        for bound in (1, 1000, 1_000_000):
            got = port_mgps.partition(sizes, servers, bound)
            want = jax_mgps.partition(sizes, servers, bound)
            assert [tuple(vars(p).values()) for p in got] == \
                [tuple(vars(p).values()) for p in want]
    assert port_mgps.HASH_PRIME == jax_mgps.HASH_PRIME == 9973
    assert port_mgps.partition(sizes[:4], 4) == \
        [port_mgps.Placement(k, (k * 9973) % 4, False, (0, n))
         for k, n in enumerate(sizes[:4])]


@pytest.mark.parametrize("shape", [(6, 8), (5, 7), (3, 3, 8, 16), (13,)])
def test_plan_shard_ops_match_jax(mesh2x4, shape):
    """``scatter_grad_leaf``, ``shard_param_leaf`` and
    ``unshard_param_leaf`` against the JAX plan in ``shard_map``, bit for
    bit, at sizes that split into W and at sizes whose last shard has a
    zero tail (35 and 13 elements: shards of 9 and 4)."""
    rng = np.random.RandomState(1)
    jplan = jax_mgps.MultiGPSPlan(1, 4)
    pplan = port_mgps.MultiGPSPlan(1, 4)
    n = int(np.prod(shape))
    assert pplan.shard_len(n) == jplan.shard_len(n) == -(-n // 4)
    g = powers(rng, (2, 4) + shape)
    p = np.ascontiguousarray(np.broadcast_to(
        powers(rng, shape, zeros=0.0), (2, 4) + shape))

    def device(g, p):
        widx = lax.axis_index(WORKER_AXIS)
        sc = jplan.scatter_grad_leaf(g, WORKER_AXIS)
        sh = jplan.shard_param_leaf(p, widx)
        return sc, sh, jplan.unshard_param_leaf(sh + sc, p, WORKER_AXIS)

    jsc, jsh, jfull = on_mesh(mesh2x4, device)(g, p)
    tg, tp = torch.from_numpy(g), torch.from_numpy(p)
    psc = pplan.scatter_grad_leaf(tg, WORKER_AXIS)
    psh = pplan.shard_param_leaf(tp)
    pfull = pplan.unshard_param_leaf(psh + psc, tp, WORKER_AXIS)
    for a, b in ((jsc, psc), (jsh, psh), (jfull, pfull)):
        assert b.shape == np.shape(a) and b.is_contiguous()
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    s = pplan.shard_len(n)
    if 4 * s > n:  # the tail of the last shard is zero
        assert not psh[:, 3, n - 3 * s:].any()
        assert not psc[:, 3, n - 3 * s:].any()


def test_plan_mixed_views():
    """``is_big``, ``mixed_example`` and the split/stitch of the layout
    groups, as the JAX plan's."""
    jplan = jax_mgps.MultiGPSPlan(100, 4)
    pplan = port_mgps.MultiGPSPlan(100, 4)
    shapes = {"a": (10, 10), "b": (99,), "c": (3, 3, 4, 4), "d": (7,)}
    tree = {k: torch.ones((2, 4) + s) for k, s in shapes.items()}
    mixed = pplan.mixed_example(tree)
    jmixed = jplan.mixed_example({k: jnp.ones(s) for k, s in shapes.items()})
    for k in shapes:
        assert tuple(mixed[k].shape[2:]) == jmixed[k].shape
        if pplan.is_big(int(np.prod(shapes[k]))):
            assert mixed[k].dtype == torch.float32 and not mixed[k].any()
        else:
            assert mixed[k] is tree[k]
    sizes = [int(np.prod(s)) for s in shapes.values()]
    names = list(shapes)
    big, small = pplan.split_mixed(sizes, names)
    assert (big, small) == jplan.split_mixed(sizes, names) == \
        (["a", "c"], ["b", "d"])
    assert pplan.stitch_mixed(sizes, big, small) == names
    assert not port_mgps.MultiGPSPlan(1, 1).is_big(10 ** 9)


# ---- through the Trainer ------------------------------------------------------

# path -> (GeoConfig overrides, JAX optimizer, port optimizer): the
# counterparts of tests/test_multigps.py:41, :113 and :168
MGPS_PATHS = {
    "fsa": (dict(), lambda: optax.sgd(0.1, momentum=0.9),
            lambda: sgd(0.1, momentum=0.9)),
    "bsc_adam": (dict(compression="bsc,0.01,select=sampled"),
                 lambda: optax.adam(0.01), lambda: adam(0.01)),
    "dc_dgt": (dict(enable_dgt=1, dgt_block_size=256, udp_channel_num=3),
               lambda: optax.sgd(0.05, momentum=0.9),
               lambda: sgd(0.05, momentum=0.9)),
}


def mgps_trainers(path, mesh2x4, topo2x4):
    extra, jtx, ptx = MGPS_PATHS[path]
    cfg = dict(num_parties=2, workers_per_party=4, precision="fp32",
               multi_gps=True, bigarray_bound=BOUND, **extra)
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo2x4, jtx(), config=JaxConfig(**cfg), mesh=mesh2x4,
                    donate=False)
    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 4), ptx(), config=GeoConfig(**cfg),
                 device="cpu")
    return jt, pt


@pytest.mark.parametrize("path", sorted(MGPS_PATHS))
def test_three_multigps_steps_track_jax_trainer(mesh2x4, topo2x4, path):
    """Three fp32 MultiGPS steps of a small ResNet from converted weights:
    losses to rtol 1e-4, params to atol 2e-3 against the JAX Trainer,
    every replica identical; the optimizer state of a big leaf a
    ``ceil(n / W)`` shard, the same in every party, of a small leaf the
    leaf (tests/test_multigps.py:63); the dc tier per leaf (the bucket
    unwrapped) or, for DGT, one schedule a layout group."""
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    jt, pt = mgps_trainers(path, mesh2x4, topo2x4)
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
    assert [np.shape(a) for a in jax.tree.leaves(jst.sync_state)] == \
        [tuple(t.shape) for t in port_leaves(pst.sync_state)
         if isinstance(t, torch.Tensor)]
    dc = pt.sync.dc_compressor
    assert type(dc).__name__ == type(jt.sync.dc_compressor).__name__
    assert isinstance(dc, DGTCompressor if path == "dc_dgt" else
                      (BiSparseCompressor if path == "bsc_adam"
                       else type(get_compressor("none"))))
    if path == "dc_dgt":
        assert set(pst.sync_state["dc_comp"]) == {"sharded", "replicated"}
    plosses = []
    for xb, yb in pt.make_loader(x, y, 8, seed=0).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    print(f"{path}: losses port {plosses} jax {jlosses}")
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    jp = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                  jst.params))
    trace = pst.opt_state.get("trace", pst.opt_state.get("mu"))
    n_big = 0
    flips = 0
    for k, v in pst.params.items():
        diff = np.abs(v[0, 0].numpy() - jp[k])
        if path == "bsc_adam":
            # Adam moves a coordinate by about lr a step whatever its
            # gradient's size, so a gradient within rounding of zero
            # (another order of the convolution sums) may step either
            # way: those coordinates are counted and bounded
            flips += int((diff > 2e-3).sum())
            assert diff.max() <= 2 * 3 * 0.01 + 2e-3, k
        else:
            assert diff.max() <= 2e-3, k
        assert torch.equal(v, v[:1, :1].expand_as(v)), k
        n = v[0, 0].numel()
        if n >= BOUND:
            n_big += 1
            assert trace[k].shape == (2, 4, -(-n // 4)), k
            assert torch.equal(trace[k][0], trace[k][1]), k
        else:
            assert trace[k].shape == v.shape, k
    assert n_big == 4
    n_params = sum(v[0, 0].numel() for v in pst.params.values())
    print(f"{path}: {flips} of {n_params} coordinates beyond 2e-3")
    assert flips <= 0.001 * n_params


def test_multigps_dense_matches_the_replicated_update():
    """Leaf-wise optimizers are exact under the contiguous split
    (tests/test_multigps.py:41): three dense steps as FSA's to 1e-6."""
    rng = np.random.RandomState(12)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    out = []
    for on in (False, True):
        t = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                    HiPSTopology(2, 4), sgd(0.05, momentum=0.9),
                    config=GeoConfig(num_parties=2, workers_per_party=4,
                                     precision="fp32", multi_gps=on,
                                     bigarray_bound=BOUND),
                    device="cpu")
        st = t.init_state(seed=0)
        for xb, yb in t.make_loader(x, y, 8, seed=0).epoch(0):
            st, _ = t.train_step(st, xb, yb)
        out.append(st.params)
    for k in out[0]:
        np.testing.assert_allclose(out[1][k].numpy(), out[0][k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


# ---- the composition checks ---------------------------------------------------

def both_raise(topo2x4, cfg, jsync=None, psync=None, jtx=None, ptx=None):
    with pytest.raises(ValueError) as jexc:
        JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS),
                   topo2x4, jtx or optax.sgd(0.05), sync=jsync,
                   config=JaxConfig(**cfg))
    with pytest.raises(ValueError) as pexc:
        Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4),
                ptx or sgd(0.05), sync=psync, config=GeoConfig(**cfg),
                device="cpu")
    assert str(pexc.value) == str(jexc.value)
    return str(pexc.value)


MGPS = dict(num_parties=2, workers_per_party=4, multi_gps=True,
            bigarray_bound=BOUND)


@pytest.mark.parametrize("over,match", [
    (dict(sync_mode="hfa"), "requires sync_mode=fsa"),
    (dict(sync_mode="mixed"), "requires sync_mode=fsa"),
    (dict(pipeline_depth=1), "GEOMX_PIPELINE_DEPTH"),
    (dict(zero=True), "GEOMX_ZERO does not compose"),
], ids=["hfa", "mixed", "pipelined", "zero"])
def test_invalid_compositions_raise_the_jax_errors(topo2x4, over, match):
    """tests/test_multigps.py:103 and geomx_tpu/train/step.py:167-186,
    and ZeRO with MultiGPS: the same type and message."""
    assert match in both_raise(topo2x4, dict(MGPS, **over))


def test_fused_apply_with_multigps_raises_the_jax_error(topo2x4):
    msg = both_raise(
        topo2x4, dict(MGPS, fused_optim=True),
        jtx=optim_pallas.fused_optimizer("sgd", learning_rate=0.1),
        ptx=port_optim.fused_optimizer("sgd", learning_rate=0.1))
    assert "use GEOMX_ZERO for a sharded fused update" in msg


def test_dgt_worker_compressor_raises_and_others_warn(topo2x4):
    """tests/test_multigps.py:154: DGT as the worker compressor raises;
    another worker compressor warns that the big leaves bypass it."""
    assert "DGT" in both_raise(topo2x4, MGPS, jsync=JaxFSA(
        worker_compressor=JaxDGT()), psync=FSA(
        worker_compressor=DGTCompressor()))
    with pytest.warns(UserWarning, match="BYPASS the worker-tier") as rec:
        Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.05),
                sync=FSA(worker_compressor=get_compressor("fp16")),
                config=GeoConfig(**MGPS), device="cpu")
    assert "(fp16)" in str(rec[0].message)


def test_dead_party_is_refused_before_multigps_sees_it(topo2x4):
    """The JAX package refuses MultiGPS under a degraded membership mask
    (geomx_tpu/train/step.py:156-166) when the step is built, before any
    MultiGPS step runs; so does the port, with the same type and
    message."""
    jfsa = JaxFSA().bind_topology(topo2x4).bind_membership((True, False))
    with pytest.raises(ValueError, match="degraded membership") as jexc:
        JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS),
                   topo2x4, optax.sgd(0.05), sync=jfsa,
                   config=JaxConfig(**MGPS))
    pfsa = FSA().bind_topology(HiPSTopology(2, 4))
    pfsa.bind_membership((True, False))
    with pytest.raises(ValueError, match="degraded membership") as pexc:
        Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.05),
                sync=pfsa, config=GeoConfig(**MGPS), device="cpu")
    assert str(pexc.value) == str(jexc.value)


def test_bucketed_dc_tier_is_unwrapped_as_jax_does():
    """MultiGPS keeps per-leaf dc semantics: the trainer's sync runs the
    inner compressor, in the JAX package's structure; without MultiGPS
    the bucket stays."""
    cfg = dict(MGPS, compression="bsc,0.01")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt = Trainer(ResNet(STAGES, FILTERS), HiPSTopology(2, 4), sgd(0.05),
                     config=GeoConfig(**cfg), device="cpu")
    jsync = jax_sync(JaxConfig(**cfg))
    JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS),
               HiPSTopology_jax(), optax.sgd(0.05), sync=jsync,
               config=JaxConfig(**cfg))
    assert isinstance(pt.sync.dc_compressor, BiSparseCompressor)
    assert type(jsync.dc_compressor).__name__ == "BiSparseCompressor"
    plain = get_sync_algorithm(GeoConfig(**dict(cfg, multi_gps=False)))
    assert type(plain.dc_compressor).__name__ == "BucketedCompressor"


def HiPSTopology_jax():
    from geomx_tpu.topology import HiPSTopology as JaxTopology
    return JaxTopology(2, 4)
