"""Port parity: the FP16 and MPQ compressors, the exact/approx BSC
selections, the spec grammar and the wire-byte accounting
(geomx_tpu_torch vs geomx_tpu, on the CPU).

- FP16 gather path under ``shard_map`` on the conftest meshes, fp16 and
  bf16: bit for bit at two parties (``0 + a + b`` is exact in any
  order); rtol 1e-6 at four parties with random values, because XLA's
  reduce over the gathered axis need not add the parties in party
  order, which the port does.
- MPQ routes by per-replica size: the small leaf's result is the FP16
  compressor's, the large leaf's the exact BSC's, each equal to the JAX
  MPQ's bit for bit at two parties.
- The exact and approx selections against JAX's ``lax.top_k`` /
  ``lax.approx_max_k`` (which returns ``top_k``'s indices on the CPU):
  values, indices, ``u`` and ``v`` bit for bit; ``u`` holds signed
  powers of two so that ``0.9 * u`` is exact (XLA contracts ``u * 0.9 +
  g`` into an FMA on the CPU, the port does not).
- The grammar and ``wire_bytes`` against ``geomx_tpu.compression``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_bsc import pow2
from test_torch_train import small_flax_params

from geomx_tpu.compression import get_compressor as jax_get_compressor
from geomx_tpu.compression.bisparse import BiSparseCompressor as JaxBSC
from geomx_tpu.compression.bucketing import BucketedCompressor as JaxBucketed
from geomx_tpu.compression.fp16 import FP16Compressor as JaxFP16
from geomx_tpu.compression.mpq import MPQCompressor as JaxMPQ
from geomx_tpu.parallel.collectives import shard_map_compat
from geomx_tpu.topology import DC_AXIS, WORKER_AXIS
from geomx_tpu_torch.compression import (BiSparseCompressor,
                                         BucketedCompressor, FP16Compressor,
                                         MPQCompressor, get_compressor)
from geomx_tpu_torch.models.convert import from_flax

torch.set_num_threads(2)

SPEC = P(DC_AXIS, WORKER_AXIS)


def _mesh_allreduce(mesh, comp, g, state=()):
    """``comp.allreduce_leaf`` of each device's ``[0, 0]`` slice over dc."""
    P_ = mesh.shape[DC_AXIS]

    def device(a, *st):
        out, new = comp.allreduce_leaf(a[0, 0], tuple(s[0, 0] for s in st)
                                       if st else (), DC_AXIS, P_)
        return (out[None, None],) + tuple(s[None, None] for s in new)

    n_out = 1 + len(state)
    res = jax.jit(shard_map_compat(device, mesh,
                                   in_specs=(SPEC,) * (1 + len(state)),
                                   out_specs=(SPEC,) * n_out))(g, *state)
    return [np.asarray(r) for r in res]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("topo_name", ["topo2x4", "topo4x2"])
def test_fp16_gather_path_matches_jax(request, topo_name, bf16):
    topo = request.getfixturevalue(topo_name)
    P_, W_ = topo.num_parties, topo.workers_per_party
    g = np.random.RandomState(3).normal(0, 1, (P_, W_, 700)) \
        .astype(np.float32)
    (ref,) = _mesh_allreduce(topo.build_mesh(),
                             JaxFP16(bf16=bf16, sparse_agg=False), g)
    got, st = FP16Compressor(bf16=bf16, sparse_agg=False).allreduce_leaf(
        torch.from_numpy(g), (), DC_AXIS, P_)
    assert st == () and got.dtype == torch.float32
    if P_ == 2:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    # one party: the 16-bit round trip
    one, _ = FP16Compressor(bf16=bf16).allreduce_leaf(
        torch.from_numpy(g), (), DC_AXIS, 1)
    wire = torch.bfloat16 if bf16 else torch.float16
    assert torch.equal(one, torch.from_numpy(g).to(wire).float())


def test_mpq_routes_by_size_and_matches_jax(topo2x4):
    mesh = topo2x4.build_mesh()
    rng = np.random.RandomState(8)
    jm = JaxMPQ(ratio=0.02, size_lower_bound=3000, approx=False)
    pm = MPQCompressor(ratio=0.02, size_lower_bound=3000, approx=False)
    small = rng.normal(0, 1, (2, 4, 2999)).astype(np.float32)
    large = rng.normal(0, 1, (2, 4, 3000)).astype(np.float32)
    assert isinstance(pm.route(torch.from_numpy(small)), FP16Compressor)
    assert isinstance(pm.route(torch.from_numpy(large)), BiSparseCompressor)
    assert pm.large.select == "exact" and pm.init_leaf_state(
        torch.from_numpy(small)) == ()
    (ref,) = _mesh_allreduce(mesh, jm, small)
    got, _ = pm.allreduce_leaf(torch.from_numpy(small), (), DC_AXIS, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    z = np.zeros_like(large)
    ref_out, ref_u, ref_v = _mesh_allreduce(mesh, jm, large, (z, z))
    st = pm.init_leaf_state(torch.from_numpy(large))
    got, (gu, gv) = pm.allreduce_leaf(torch.from_numpy(large), st, DC_AXIS, 2)
    for a, b in ((got, ref_out), (gu, ref_u), (gv, ref_v)):
        np.testing.assert_array_equal(a.numpy(), b)
    # under bucketing the small ResNet's one bucket routes to fp16
    params = {k: v[None, None]
              for k, v in from_flax(small_flax_params())[0].items()}
    bk = BucketedCompressor(MPQCompressor(0.01))
    assert bk.init_state(params) == [()]


@pytest.mark.parametrize("select", ["exact", "approx"])
@pytest.mark.parametrize("n,ratio", [(5000, 0.01), (1024, 0.05), (10, 0.5)])
def test_exact_and_approx_select_match_jax(rng, select, n, ratio):
    g = np.round(rng.normal(0, 2, n)).astype(np.float32) * 0.25
    u = pow2(rng, n)
    v = rng.normal(0, 0.2, n).astype(np.float32)
    v[: n // 10] = 0.0  # ties among the zeros too
    jc = JaxBSC(ratio, select=select, fused=False, min_sparse_size=1)
    ref = jax.jit(lambda a, b, c: jc.compress(a, b, c))(g, u, v)
    pc = BiSparseCompressor(ratio, select=select, min_sparse_size=1)
    got = pc.compress(*(torch.from_numpy(x) for x in (g, u, v)))
    for name, a, b in zip(("vals", "idx", "u", "v"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert got[1].dtype == torch.int32 and (got[1] >= 0).all()
    # the all-gather path on the replica axes: two parties' pairs summed
    gg = np.stack([g, g[::-1].copy()])[:, None].repeat(4, axis=1)
    uu = np.zeros_like(gg)
    ref_out, _, ref_v = _mesh_allreduce(
        jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                          (DC_AXIS, WORKER_AXIS)), jc, gg, (uu, uu))
    out, (_, pv) = pc.allreduce_leaf(torch.from_numpy(gg),
                                     pc.init_leaf_state(torch.from_numpy(gg)),
                                     DC_AXIS, 2)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(pv.numpy(), ref_v)


SPECS = ["none", "fp16", "fp16,bf16=1", "fp16,sparse_agg=1", "2bit,0.5",
         "2bit,threshold=0.3,sparse_agg=1", "bsc,0.01",
         "bsc,0.02,select=exact", "bsc,0.01,approx=1",
         "bsc,0.01,select=sampled,sparse_agg=1",
         "bsc,0.01,sparse_agg=1,sparse_agg_parties=4",
         "bsc,0.01,min_sparse_size=200000", "mpq", "mpq,0.02,1000",
         "mpq,ratio=0.01,size_lower_bound=100000,bf16=1"]


@pytest.fixture(scope="module")
def small_params():
    params = small_flax_params()
    return params, {k: v[None, None]
                    for k, v in from_flax(params)[0].items()}


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_and_wire_bytes_match_jax(spec, small_params):
    port, ref = get_compressor(spec), jax_get_compressor(spec)
    assert type(port).__name__ == type(ref).__name__
    assert port.name == ref.name
    # the default selection differs on the CPU: JAX "exact", the port
    # "sampled" (the kernel path); compare it where the spec names it
    named = "select=" in spec or "approx=" in spec
    for attr in ("ratio", "select", "min_sparse_size", "threshold",
                 "sparse_agg", "sparse_agg_parties", "size_lower_bound"):
        if hasattr(ref, attr) and (attr != "select" or named):
            assert getattr(port, attr) == getattr(ref, attr), attr
    if hasattr(ref, "wire_dtype"):
        assert str(port.wire_dtype).split(".")[-1] == \
            jnp.dtype(ref.wire_dtype).name
    if spec == "2bit,0.5":
        return  # the JAX CPU default sends the jnp wire, the port the
        # kernel path's (test_twobit_wire_bytes_match_the_jax_kernel_path)
    params, pparams = small_params
    assert port.wire_bytes(pparams) == ref.wire_bytes(params)
    for n in (1000, 272_512):
        assert port.wire_bytes_leaf(torch.zeros(2, 4, n)) == \
            ref.wire_bytes_leaf(jnp.zeros((n,)))
    assert BucketedCompressor(port).wire_bytes(pparams) == \
        JaxBucketed(ref).wire_bytes(params)


def test_twobit_wire_bytes_match_the_jax_kernel_path():
    from geomx_tpu.compression.twobit import TwoBitCompressor as JaxTwoBit
    for n in (1, 2048, 2049, 272_512):
        assert get_compressor("2bit,0.5").wire_bytes_leaf(
            torch.zeros(1, 1, n)) == JaxTwoBit(
                0.5, use_pallas=True, sparse_agg=False).wire_bytes_leaf(
                    jnp.zeros((n,)))


def test_grammar_rejects_what_stays_unported():
    # the port picks its kernels by device: bsc's fused key is unknown
    for bad in ("bsc,0.01,fused=1", "fp16,0.5", "mpq,0.01,10,3",
                "fp16,ratio=1"):
        with pytest.raises(ValueError):
            get_compressor(bad)
    assert jax_get_compressor("bsc,0.01,fused=0").fused is False
