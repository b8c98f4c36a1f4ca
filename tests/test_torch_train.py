"""Port parity: FSA sync with bucketed BSC, the training step, the loader
(geomx_tpu_torch vs geomx_tpu on the conftest 2x4 mesh).

- The FSA + bucketed BSC ``sync_grads`` is bit for bit equal to the JAX
  sync the Trainer builds, output and ``(u, v)`` state, over two steps.
  The gradients are signed powers of two (and zeros), identical across
  the workers of a party, so every worker mean is exact, ``0.9 * u`` is
  exact (XLA contracts ``u * 0.9 + g`` into an FMA on the CPU, the port
  does not), and a coordinate sums at most two party values.
- Three fp32 training steps of a small ResNet from the same weights and
  batches: losses agree to rtol 1e-4.  Convolution sums differ in order
  between the packages, so a coordinate that sits at the BSC boundary
  may be emitted by one and not the other; the test counts those flips
  and bounds them.
- The loader's batches are byte-identical for the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.data.loader import GeoDataLoader as JaxLoader
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu.train.state import replicate_tree as jax_replicate
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.train.state import replicate_tree
from geomx_tpu_torch.tree import from_nested, leaf_names

torch.set_num_threads(2)

STAGES, FILTERS = (1, 1, 1), (8, 16, 32)
SPEC = "bsc,0.01,select=sampled"


def small_flax_params(seed=0):
    model = FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                       dtype=jnp.float32)
    v = jax.jit(lambda r: model.init(r, jnp.zeros((1, 16, 16, 3)),
                                     train=False))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, v["params"])


def dyadic(rng, shape):
    x = np.ldexp(1.0, -rng.randint(0, 12, shape)).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], shape).astype(np.float32)
    x[rng.rand(*shape) < 0.3] = 0.0
    return x


@pytest.mark.parametrize("bucket_bytes", [4 * 1024 * 1024, 16 * 1024])
def test_fsa_bucketed_bsc_sync_bit_equal(topo2x4, mesh2x4, bucket_bytes):
    params = small_flax_params()
    rng = np.random.RandomState(7)
    steps = []
    for _ in range(2):
        # party-specific gradients, identical across a party's workers
        steps.append(jax.tree.map(
            lambda a: np.repeat(np.stack([dyadic(rng, a.shape)
                                          for _ in range(2)])[:, None],
                                4, axis=1), params))

    cfg = dict(num_parties=2, workers_per_party=4, compression=SPEC,
               bucket_bytes=bucket_bytes)
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo2x4)
    jstate = jax_replicate(jsync.init_state(params), topo2x4, mesh2x4)
    spec = P(DC_AXIS, WORKER_AXIS)

    def device_sync(g, st):
        sq = jax.tree.map(lambda a: a[0, 0], (g, st))
        out, st2 = jsync.sync_grads(sq[0], None, sq[1], jnp.int32(0))
        return jax.tree.map(lambda a: a[None, None], (out, st2))

    fn = jax.jit(shard_map_compat(device_sync, mesh2x4,
                                  in_specs=(spec, spec),
                                  out_specs=(spec, spec)))

    topo = HiPSTopology(2, 4)
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(topo)
    pparams = replicate_tree(from_flax(params)[0], topo, "cpu")
    pstate = psync.init_state(pparams)
    for step, grads in enumerate(steps):
        jout, jstate = fn(grads, jstate)
        pgrads = {k: torch.from_numpy(v)
                  for k, v in from_nested(grads).items()}
        pout, pstate = psync.sync_grads(pgrads, pparams, pstate, step)
        ref = from_nested(jax.tree.map(np.asarray, jout))
        assert leaf_names(pout) == leaf_names(ref)
        for k in ref:
            np.testing.assert_array_equal(pout[k].numpy(), ref[k],
                                          err_msg=f"step {step} {k}")
        jdc, pdc = jstate["dc_comp"], pstate["dc_comp"]
        assert len(jdc) == len(pdc) >= 1
        for (ju, jv), (pu, pv) in zip(jdc, pdc):
            np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    # the sync really compressed: most state mass stayed behind
    assert any((np.asarray(v) != 0).any() for _, v in jstate["dc_comp"])


def test_three_fp32_steps_track_jax_trainer(topo2x4, mesh2x4):
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    cfg = dict(num_parties=2, workers_per_party=4, compression=SPEC,
               precision="fp32")

    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo2x4, optax.sgd(0.1, momentum=0.9),
                    config=JaxConfig(**cfg), mesh=mesh2x4, donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(2, 4), sgd(0.1, momentum=0.9),
                 config=GeoConfig(**cfg), device="cpu")
    params, stats = from_flax(p0, s0)
    pst = pt.init_state(params=params, model_state=stats)
    plosses = []
    for xb, yb in pt.make_loader(x, y, 8, seed=0).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))

    assert len(jlosses) == len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    assert plosses[0] == pytest.approx(jlosses[0], rel=1e-6)
    # near-threshold flips: coordinates emitted by one package's BSC and
    # left in the other's error feedback, over the 3 steps
    (ju, _), = jst.sync_state["dc_comp"]
    (pu, _), = pst.sync_state["dc_comp"]
    ju, pu = np.asarray(ju)[:, 0], pu.numpy()[:, 0]
    flips = int(((ju == 0) != (pu == 0)).sum())
    k = pt.sync.dc_compressor.inner.k_for(pu.shape[-1])
    print(f"BSC flips over 3 steps: {flips} of k={k} a step; losses "
          f"port {plosses} jax {jlosses}")
    assert flips <= max(4, 0.05 * 3 * k), (flips, k)
    # params agree to the same scale (fp32 sums + the flips above)
    jparams = from_nested(jax.tree.map(lambda a: np.asarray(a)[0, 0],
                                       jst.params))
    for k_, v in pst.params.items():
        np.testing.assert_allclose(v[0, 0].numpy(), jparams[k_], atol=2e-3,
                                   err_msg=k_)


@pytest.mark.parametrize("augment,split_by_class", [(False, False),
                                                    (True, True)])
def test_loader_batches_byte_identical(topo2x4, augment, split_by_class):
    rng = np.random.RandomState(2)
    x = rng.randint(0, 256, (256, 8, 8, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 256).astype(np.int32)
    kw = dict(split_by_class=split_by_class, seed=3, augment=augment)
    jl = JaxLoader(x, y, topo2x4, 4, **kw)
    pl = GeoDataLoader(x, y, HiPSTopology(2, 4), 4, device="cpu", **kw)
    assert pl.steps_per_epoch == jl.steps_per_epoch
    for epoch in range(2):
        pairs = list(zip(jl.epoch(epoch, prefetch=0), pl.epoch(epoch)))
        assert len(pairs) == jl.steps_per_epoch
        for (jx, jy), (px, py) in pairs:
            np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(py.numpy(), np.asarray(jy))


@pytest.mark.parametrize("topo_name", ["topo2x4", "topo4x2"])
def test_collectives_match_jax_mesh(request, topo_name):
    """The in-process [P, W] backend gives every replica what the JAX
    per-device collective gives that device, on the conftest 2x4 and 4x2
    meshes.  Integer-valued inputs: every sum is exact."""
    from geomx_tpu.parallel import collectives as jc
    from geomx_tpu_torch.parallel import collectives as pc

    topo = request.getfixturevalue(topo_name)
    mesh = topo.build_mesh()
    P_, W_ = topo.num_parties, topo.workers_per_party
    x = np.random.RandomState(5).randint(-50, 50, (P_, W_, 6)) \
        .astype(np.float32)
    spec = P(DC_AXIS, WORKER_AXIS)

    def device(a):
        a = a[0, 0]
        out = (jc.psum_worker(a), jc.psum_dc(a), jc.pmean_worker(a),
               jc.pmean_dc(a), jc.hier_psum(a), jc.hier_pmean(a),
               jc.all_gather_dc(a), jc.party_index(), jc.worker_index(),
               jc.global_worker_rank())
        return tuple(o[None, None] for o in out)

    ref = jax.jit(shard_map_compat(device, mesh, in_specs=(spec,),
                                   out_specs=(spec,) * 10))(x)
    t = torch.from_numpy(x)
    got = (pc.psum_worker(t), pc.psum_dc(t), pc.pmean_worker(t),
           pc.pmean_dc(t), pc.hier_psum(t), pc.hier_pmean(t),
           pc.all_gather_dc(t), pc.party_index(P_, W_),
           pc.worker_index(P_, W_), pc.global_worker_rank(P_, W_))
    for name, a, b in zip(("psum_worker", "psum_dc", "pmean_worker",
                           "pmean_dc", "hier_psum", "hier_pmean",
                           "all_gather_dc", "party_index", "worker_index",
                           "global_worker_rank"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
