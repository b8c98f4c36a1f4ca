"""Port parity: compressed-domain aggregation (geomx_tpu_torch vs
geomx_tpu, on the CPU).

- The plain merge (``ops.merge``) against the JAX ``merge_sorted_pairs``,
  jnp and Pallas interpret, bit for bit: the shapes of
  tests/test_sparseagg.py, all sentinels, every party on one index, a
  segment longer than ``2^rounds``, ``[P, W]`` rows, and the CUDA
  kernel's edges (a segment across its tile, a head at column ``m - 1``,
  ``m`` below its halo); the kernel's head test (a key change) against
  ``rank == 0`` of both packages' ``segment_ranks``.
- ``owner_route`` against JAX bit for bit, overflow included; the top-k
  helper against ``lax.top_k`` on ties and zeros.
- The bucketed ``"bsc,0.01,select=sampled,sparse_agg=1"`` FSA sync on
  2x4 and 4x2 against the JAX sync, over 2 steps, bit for bit: output,
  ``(u, v)`` (``v`` holds the reinjected overflow), with the default
  slack and with ``GEOMX_SPARSE_AGG_SLACK=0.3`` (overflow).  Gradients
  are signed powers of two, identical across a party's workers: worker
  means are exact, and ``0.9 * u`` is exact while ``u`` is a power of two
  (XLA contracts ``u * 0.9 + g`` into an FMA on the CPU, the port does
  not), which holds for two steps.
- The fp16 and 2-bit lattices against JAX on both meshes, bit for bit.
- Three fp32 ``sparse_agg`` Trainer steps of a small ResNet on 4x2
  against the JAX Trainer's losses, rtol 1e-4 (convolution sums differ
  in order between the packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P
from test_torch_train import FILTERS, STAGES, dyadic, small_flax_params

from geomx_tpu.compression import sparseagg as jsa
from geomx_tpu.compression.twobit import TwoBitCompressor as JaxTwoBit
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops.merge_pallas import merge_sorted_pairs as jax_merge
from geomx_tpu.ops.merge_pallas import segment_ranks as jranks
from geomx_tpu.ops.merge_pallas import sort_pairs as jsort
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.sync import get_sync_algorithm as jax_sync
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu.train import Trainer as JaxTrainer
from geomx_tpu.train.state import replicate_tree as jax_replicate
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.compression import TwoBitCompressor
from geomx_tpu_torch.compression import sparseagg as psa
from geomx_tpu_torch.models import ResNet
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import merge as pm
from geomx_tpu_torch.ops.topk import top_k
from geomx_tpu_torch.optim import sgd
from geomx_tpu_torch.sync import get_sync_algorithm
from geomx_tpu_torch.train import Trainer
from geomx_tpu_torch.train.state import replicate_tree
from geomx_tpu_torch.tree import from_nested, leaf_names

torch.set_num_threads(2)

SPEC = P(DC_AXIS, WORKER_AXIS)


def _mesh(request, name):
    topo = request.getfixturevalue(name)
    return topo, topo.build_mesh()


def _on_mesh(mesh, fn, *args, n_out=1):
    """Run ``fn`` on each device's ``[0, 0]`` slice under shard_map."""
    def device(*a):
        out = fn(*(x[0, 0] for x in a))
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o[None, None] for o in out)
    res = jax.jit(shard_map_compat(device, mesh, in_specs=(SPEC,) * len(args),
                                   out_specs=(SPEC,) * n_out))(*args)
    return [np.asarray(r) for r in res]


def _rand_pairs(rng, parties, k, n, sentinel_frac=0.15):
    vals, idx = [], []
    for _ in range(parties):
        ii = rng.choice(n, k, replace=False).astype(np.int32)
        vv = rng.normal(0, 1, k).astype(np.float32)
        drop = rng.random_sample(k) < sentinel_frac
        ii[drop] = -1
        vv[drop] = 0.0
        vals.append(vv)
        idx.append(ii)
    return np.concatenate(vals), np.concatenate(idx)


def _assert_merge_parity(v, i, max_dup):
    ref = jax.jit(lambda a, b: jax_merge(a, b, max_dup))(v, i)
    fus = jax.jit(lambda a, b: jax_merge(a, b, max_dup, fused=True,
                                         interpret=True))(v, i)
    got = pm.merge_sorted_pairs(torch.from_numpy(v), torch.from_numpy(i),
                                max_dup)
    for g, r, f in zip(got, ref, fus):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(f))
    return got


@pytest.mark.parametrize("parties,k,n", [(2, 33, 500), (4, 64, 1024),
                                         (8, 100, 4096), (3, 1, 16)])
def test_merge_plain_matches_jax_and_pallas(rng, parties, k, n):
    v, i = _rand_pairs(rng, parties, k, n)
    mv, mi = _assert_merge_parity(v, i, parties)
    assert mi.dtype == torch.int32 and mv.dtype == torch.float32
    valid = mi >= 0
    assert len(torch.unique(mi[valid])) == int(valid.sum())


@pytest.mark.parametrize("case", ["all_sentinel", "all_duplicate",
                                  "too_long_segment"])
def test_merge_edge_cases_match_jax(case):
    if case == "all_sentinel":
        v, i, dup = np.zeros(8, np.float32), np.full(8, -1, np.int32), 4
    elif case == "all_duplicate":
        v = np.arange(1.0, 9.0, dtype=np.float32)
        i, dup = np.full(8, 7, np.int32), 8
    else:
        # 11 pairs on index 3 under max_duplicates 3 (two rounds): the
        # head's total reaches only the first four
        v = (np.arange(1, 17, dtype=np.float32) / 8.0) ** 2
        i = np.asarray([9] * 3 + [3] * 11 + [-1, 0], np.int32)
        dup = 3
    mv, mi = _assert_merge_parity(v, i, dup)
    if case == "all_sentinel":
        assert not (mi >= 0).any()
    elif case == "all_duplicate":
        assert float(mv[mi == 7].item()) == 36.0
    else:
        s = v[3:14]  # the segment in input order (a stable sort)
        assert mv[mi == 3].item() == (s[0] + s[1]) + (s[2] + s[3])


def _straddle_pairs(rng, m=600):
    """Keys 0, 1, 2, ... with key 252 seven times from position 252 on
    (across the CUDA kernel's 256-position tile) and a unique last key (a
    head at column m - 1), shuffled; max_duplicates 8."""
    i = np.concatenate([np.arange(253), np.full(6, 252),
                        np.arange(253, m - 6)]).astype(np.int32)
    return (rng.normal(0, 1, m).astype(np.float32), rng.permutation(i), 8)


@pytest.mark.parametrize("case", ["random", "straddle_tile", "tiny",
                                  "all_sentinel"])
def test_merge_heads_are_key_changes(rng, case):
    """The CUDA kernel's head test, ``col == 0 | skey[i-1] != skey[i]``, is
    ``rank == 0`` of ``segment_ranks`` in both packages on the same sorted
    pairs (and is the head mask segment_ranks returns)."""
    if case == "random":
        v, i = _rand_pairs(rng, 4, 300, 700)
    elif case == "straddle_tile":
        v, i, _ = _straddle_pairs(rng)
    elif case == "tiny":
        v, i = np.float32([1, 2, 3]), np.int32([4, -1, 4])
    else:
        v, i = np.zeros(9, np.float32), np.full(9, -1, np.int32)
    _, jkey = jax.jit(jsort)(v, i)
    _, pkey = pm.sort_pairs(torch.from_numpy(v), torch.from_numpy(i))
    np.testing.assert_array_equal(pkey.numpy(), np.asarray(jkey))
    skey = np.asarray(jkey)
    heads = np.ones(len(skey), bool)
    heads[1:] = skey[1:] != skey[:-1]
    jrank, jhead = jax.jit(jranks)(jkey)
    prank, phead = pm.segment_ranks(pkey)
    np.testing.assert_array_equal(np.asarray(jrank) == 0, heads)
    np.testing.assert_array_equal(prank.numpy() == 0, heads)
    np.testing.assert_array_equal(phead.numpy(), heads)
    np.testing.assert_array_equal(np.asarray(jhead), heads)


@pytest.mark.parametrize("case", ["straddle_tile", "head_at_m_minus_1",
                                  "m_below_halo"])
def test_merge_plain_matches_pallas_at_kernel_edges(rng, case):
    """merge_sorted_pairs_plain bit for bit against the JAX fused merge
    (Pallas interpret) where the CUDA kernel's tiling has edges: a segment
    across its 256-position tile, a head at column m - 1, and m smaller
    than its halo of 2^rounds - 1 positions."""
    if case == "straddle_tile":
        v, i, dup = _straddle_pairs(rng)
    elif case == "head_at_m_minus_1":
        v, i = _rand_pairs(rng, 2, 300, 5000, sentinel_frac=0.0)
        i[-1] = 5000  # one more index than any other: the last segment
        dup = 2
    else:
        v = rng.normal(0, 1, 5).astype(np.float32)
        i, dup = np.int32([3, 1, 3, 9, 1]), 64
    got = pm.merge_sorted_pairs_plain(torch.from_numpy(v),
                                      torch.from_numpy(i), dup)
    fus = jax.jit(lambda a, b: jax_merge(a, b, dup, fused=True,
                                         interpret=True))(v, i)
    for g, f in zip(got, fus):
        np.testing.assert_array_equal(g.numpy(), np.asarray(f))
    if case != "m_below_halo":  # the jnp tree breaks shape there (ROADMAP)
        _assert_merge_parity(v, i, dup)
    if case == "head_at_m_minus_1":
        assert got[1][-1].item() == 5000
    elif case == "straddle_tile":
        assert got[1][252].item() == 252


def test_merge_rows_are_independent(rng):
    """[P, W, m] rows give each row's 1-D merge."""
    rows = [_rand_pairs(rng, 4, 40, 300) for _ in range(8)]
    v = torch.from_numpy(np.stack([r[0] for r in rows]).reshape(4, 2, -1))
    i = torch.from_numpy(np.stack([r[1] for r in rows]).reshape(4, 2, -1))
    mv, mi = pm.merge_sorted_pairs(v, i, 4)
    assert mv.shape == mi.shape == (4, 2, 160)
    for p in range(4):
        for w in range(2):
            one = pm.merge_sorted_pairs(v[p, w], i[p, w], 4)
            assert torch.equal(mv[p, w], one[0])
            assert torch.equal(mi[p, w], one[1])


def test_owner_route_matches_jax_with_overflow(rng):
    n, P_, k, slots = 1000, 4, 40, 8
    S = jsa.owner_shard_size(n, P_)
    idx = np.concatenate([np.arange(30, dtype=np.int32),
                          np.full(5, -1, np.int32),
                          (S * 3 + np.arange(5)).astype(np.int32)])
    vals = np.arange(k, dtype=np.float32) + 1
    rand = [_rand_pairs(rng, 1, 64, n) for _ in range(3)]
    for v, i, sl in [(vals, idx, slots)] + [(a, b, 19) for a, b in rand]:
        ref = jax.jit(lambda a, b: jsa.owner_route(a, b, n, P_, sl))(v, i)
        got = psa.owner_route(torch.from_numpy(v), torch.from_numpy(i), n,
                              P_, sl)
        for g, r in zip(got, ref):
            assert g.dtype == {np.float32: torch.float32,
                               np.int32: torch.int32}[np.asarray(r).dtype.type]
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the first case overflowed 22 pairs of owner 0
    of = psa.owner_route(torch.from_numpy(vals), torch.from_numpy(idx), n,
                         P_, slots)[3]
    assert int((of < n).sum()) == 22


def test_top_k_matches_lax_on_ties_and_zeros(rng):
    cases = [np.asarray([1, 3, 3, 0, 3, 2, 0, 0], np.float32),
             np.zeros(17, np.float32),
             np.round(rng.normal(0, 2, 300)).astype(np.float32),
             np.abs(rng.normal(0, 1, 1000)).astype(np.float32)]
    assert top_k(torch.from_numpy(cases[0]), 4)[1].tolist() == [1, 2, 4, 5]
    for x in cases:
        for k in (1, 4, len(x) // 2, len(x)):
            rv, ri = jax.jit(lambda a: lax.top_k(a, k))(x)
            gv, gi = top_k(torch.from_numpy(x), k)
            np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
            np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    # rows of a [*B, n] tensor select independently
    x = np.round(rng.normal(0, 2, (2, 3, 50))).astype(np.float32)
    gv, gi = top_k(torch.from_numpy(x), 7)
    rv, ri = jax.jit(lambda a: lax.top_k(a, 7))(x)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


def _party_grads(rng, params, P_, W_, fn):
    """Party-specific gradients, identical across a party's workers."""
    return jax.tree.map(
        lambda a: np.repeat(np.stack([fn(rng, a.shape)
                                      for _ in range(P_)])[:, None], W_,
                            axis=1), params)


@pytest.mark.parametrize("slack", [None, "0.3"])
@pytest.mark.parametrize("topo_name", ["topo2x4", "topo4x2"])
def test_fsa_bucketed_sparse_agg_sync_bit_equal(request, monkeypatch,
                                                topo_name, slack):
    if slack is not None:
        monkeypatch.setenv("GEOMX_SPARSE_AGG_SLACK", slack)
    topo, mesh = _mesh(request, topo_name)
    P_, W_ = topo.num_parties, topo.workers_per_party
    params = small_flax_params()
    rng = np.random.RandomState(13)
    steps = [_party_grads(rng, params, P_, W_, dyadic) for _ in range(2)]
    cfg = dict(num_parties=P_, workers_per_party=W_,
               compression="bsc,0.01,select=sampled,sparse_agg=1")
    jsync = jax_sync(JaxConfig(**cfg)).bind_topology(topo)
    jstate = jax_replicate(jsync.init_state(params), topo, mesh)

    def device_sync(g, st):
        sq = jax.tree.map(lambda a: a[0, 0], (g, st))
        out, st2 = jsync.sync_grads(sq[0], None, sq[1], jnp.int32(0))
        return jax.tree.map(lambda a: a[None, None], (out, st2))

    fn = jax.jit(shard_map_compat(device_sync, mesh, in_specs=(SPEC, SPEC),
                                  out_specs=(SPEC, SPEC)))
    ptopo = HiPSTopology(P_, W_)
    psync = get_sync_algorithm(GeoConfig(**cfg)).bind_topology(ptopo)
    assert psync.dc_compressor.inner.sparse_agg
    pparams = replicate_tree(from_flax(params)[0], ptopo, "cpu")
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
        for (ju, jv), (pu, pv) in zip(jstate["dc_comp"], pstate["dc_comp"]):
            np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    stats = psa.wire_stats(psync.dc_compressor.inner.last_wire)
    assert stats["merged_pairs"] > 0 and stats["kept_pairs"] > 0
    if slack is not None:
        assert stats["overflow_pairs"] > 0
    else:
        assert stats["overflow_pairs"] == 0


@pytest.mark.parametrize("topo_name", ["topo2x4", "topo4x2"])
def test_lattices_match_jax(request, topo_name):
    topo, mesh = _mesh(request, topo_name)
    P_, W_ = topo.num_parties, topo.workers_per_party
    rng = np.random.RandomState(6)
    n = 3001
    g = rng.normal(0, 1, (P_, W_, n)).astype(np.float32)
    g[0, 0, :7] = 0.0
    r = rng.normal(0, 0.3, (P_, W_, n)).astype(np.float32)
    z = np.zeros((P_, W_, 5), np.float32)  # scale 0: the all-zero case
    jtb = JaxTwoBit(0.3, sparse_agg=True)
    ref = _on_mesh(mesh, lambda a, b, c: (
        jsa.lattice_allreduce_fp16(a, DC_AXIS, P_),
        jsa.lattice_allreduce_fp16(a, WORKER_AXIS, W_),
        jsa.lattice_allreduce_fp16(c, DC_AXIS, P_),
        *jtb.allreduce_leaf(a, b, DC_AXIS, P_)), g, r, z, n_out=5)
    ptb = TwoBitCompressor(0.3, sparse_agg=True)
    tg, tr = torch.from_numpy(g), torch.from_numpy(r)
    got = (psa.lattice_allreduce_fp16(tg, DC_AXIS, P_),
           psa.lattice_allreduce_fp16(tg, WORKER_AXIS, W_),
           psa.lattice_allreduce_fp16(torch.from_numpy(z), DC_AXIS, P_),
           *ptb.allreduce_leaf(tg, tr, DC_AXIS, P_))
    for name, a, b in zip(("fp16 dc", "fp16 worker", "fp16 zero",
                           "2bit out", "2bit residual"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert not got[2].any() and got[3].abs().max() > 0


def test_three_sparse_agg_fp32_steps_track_jax_trainer(topo4x2):
    mesh = topo4x2.build_mesh()
    rng = np.random.RandomState(11)
    x = rng.randint(0, 256, (192, 16, 16, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 192).astype(np.int32)
    cfg = dict(num_parties=4, workers_per_party=2,
               compression="bsc,0.01,select=sampled,sparse_agg=1",
               precision="fp32")
    jt = JaxTrainer(FlaxResNet(stage_sizes=STAGES, stage_filters=FILTERS,
                               dtype=jnp.float32),
                    topo4x2, optax.sgd(0.1, momentum=0.9),
                    config=JaxConfig(**cfg), mesh=mesh, donate=False)
    jst = jt.init_state(jax.random.PRNGKey(0), x[:2])
    p0 = jax.tree.map(lambda a: np.asarray(a)[0, 0], jst.params)
    s0 = jax.tree.map(lambda a: np.asarray(a)[0, 0],
                      jst.model_state["batch_stats"])
    jlosses = []
    for xb, yb in jt.make_loader(x, y, 8, seed=0).epoch(0, prefetch=0):
        jst, m = jt.train_step(jst, xb, yb)
        jlosses.append(float(m["loss"]))

    pt = Trainer(ResNet(STAGES, FILTERS, dtype=torch.float32),
                 HiPSTopology(4, 2), sgd(0.1, momentum=0.9),
                 config=GeoConfig(**cfg), device="cpu")
    params, stats = from_flax(p0, s0)
    pst = pt.init_state(params=params, model_state=stats)
    plosses = []
    for xb, yb in pt.make_loader(x, y, 8, seed=0).epoch(0):
        pst, m = pt.train_step(pst, xb, yb)
        plosses.append(float(m["loss"]))
    assert len(jlosses) == len(plosses) == 3
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    for k_, v in pst.params.items():
        assert torch.equal(v, v[:1, :1].expand_as(v)), k_
    assert pt.sync.dc_compressor.inner.last_wire["merged_idx"].shape == \
        (4, 2, 4 * psa.push_slots(pt.sync.dc_compressor.inner.k_for(
            pst.sync_state["dc_comp"][0][0].shape[-1]), 4))
