"""Port parity: BSC select/pack, threshold probe and scatter-add
(geomx_tpu_torch vs geomx_tpu).

Select/pack: the port's plain version must equal, bit for bit, both the
Pallas kernel in interpret mode and the jnp sampled path — values,
indices (tie order, sentinels) and residuals — on the cases of
tests/test_bsc_pallas.py.  XLA on the CPU contracts ``u * 0.9 + g`` into
an FMA under ``jit`` while the port rounds after the multiply, so the
momentum buffers ``u`` here are zero or signed powers of two: then
``0.9 * u`` is exact in fp32 and both roundings agree.  ``g`` and ``v``
are arbitrary.

Scatter-add: bit for bit with integer-valued collisions (every sum is
exact in any order) and with random floats at two parties (at most two
addends meet at a coordinate: ``0 + a + b`` is exact in either order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.compression import BiSparseCompressor as JaxBSC
from geomx_tpu.ops.bsc_pallas import (bsc_scatter_add,
                                      sampled_boundary_guv as jax_guv)
from geomx_tpu_torch.compression import BiSparseCompressor
from geomx_tpu_torch.ops import bsc as bsc_ops
from geomx_tpu_torch.ops.sampled_topk import sampled_boundary

torch.set_num_threads(2)


def pow2(rng, n, zero_frac=0.2):
    """Signed powers of two (and zeros): 0.9 * u is exact in fp32."""
    u = np.ldexp(1.0, -rng.randint(0, 10, n)).astype(np.float32)
    u *= rng.choice([-1.0, 1.0], n).astype(np.float32)
    u[rng.rand(n) < zero_frac] = 0.0
    return u


def jax_pair(ratio):
    base = dict(ratio=ratio, select="sampled", min_sparse_size=1)
    return (JaxBSC(fused=False, **base),
            JaxBSC(fused=True, fused_interpret=True, **base))


def assert_select_parity(g, u, v, ratio):
    """Port plain select/pack == jnp path == Pallas interpret, bitwise."""
    cj, cf = jax_pair(ratio)
    k = cj.k_for(len(g))
    ref = jax.jit(lambda a, b, c: cj.compress(a, b, c))(g, u, v)
    fus = jax.jit(lambda a, b, c: cf.compress(a, b, c))(g, u, v)
    tg, tu, tv = (torch.from_numpy(np.asarray(x, np.float32))
                  for x in (g, u, v))
    thr = bsc_ops.sampled_boundary_guv(tg, tu, tv, k)
    port = bsc_ops.select_pack(tg, tu, tv, thr, k)
    comp = BiSparseCompressor(ratio, min_sparse_size=1).compress(tg, tu, tv)
    for name, p, c, a, b in zip(("vals", "idx", "new_u", "new_v"), port,
                                comp, ref, fus):
        np.testing.assert_array_equal(p.numpy(), np.asarray(a), err_msg=name)
        np.testing.assert_array_equal(p.numpy(), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(c.numpy(), p.numpy(), err_msg=name)
    return port


@pytest.mark.parametrize("n,ratio", [
    (5000, 0.01),     # odd size
    (1024, 0.05),     # exactly one TPU kernel block
    (1023, 0.03),     # one element short of a block
    (131072, 0.01),   # many blocks, k spans several runs
    (10, 0.5),        # tiny
])
def test_select_pack_parity_random(rng, n, ratio):
    g = rng.normal(0, 1, n).astype(np.float32)
    u = pow2(rng, n)
    v = rng.normal(0, 0.2, n).astype(np.float32)
    assert_select_parity(g, u, v, ratio)


def test_select_pack_parity_all_sentinel():
    n = 8192
    g = np.zeros(n, np.float32)
    g[7] = 3.0
    g[4096] = -2.0
    z = np.zeros(n, np.float32)
    vals, idx, _, new_v = assert_select_parity(g, z, z, 0.01)
    assert (idx >= 0).sum() >= 2 and vals[idx >= 0].sum() != 0
    # mass conservation: emitted + residual == momentum-corrected grad
    out = np.zeros(n, np.float32)
    keep = idx.numpy() >= 0
    out[idx.numpy()[keep]] += vals.numpy()[keep]
    np.testing.assert_allclose(out + new_v.numpy(), g, atol=1e-6)


def test_select_pack_parity_overflow_past_k():
    n = 4096
    g = np.full(n, -0.75, np.float32)
    z = np.zeros(n, np.float32)
    _, idx, _, _ = assert_select_parity(g, z, z, 0.01)
    k = JaxBSC(0.01, select="sampled").k_for(n)
    np.testing.assert_array_equal(np.sort(idx.numpy()), np.arange(k))


def test_select_pack_parity_all_zero():
    n = 5000
    z = np.zeros(n, np.float32)
    _, idx, _, _ = assert_select_parity(z, z, z, 0.01)
    assert (idx >= 0).sum() == JaxBSC(0.01, select="sampled").k_for(n)


def test_select_pack_mixed_primary_and_ties(rng):
    n = 20000
    g = np.round(rng.normal(0, 2, n)).astype(np.float32) * 0.5
    z = np.zeros(n, np.float32)
    assert_select_parity(g, z, z, 0.02)


def test_select_pack_rows_are_independent(rng):
    """[P, W, n] rows (the replica axes) give each row's 1-D result."""
    n, k = 3000, 30
    g = torch.from_numpy(rng.normal(0, 1, (2, 4, n)).astype(np.float32))
    u = torch.from_numpy(pow2(rng, 8 * n).reshape(2, 4, n))
    v = torch.from_numpy(rng.normal(0, 0.2, (2, 4, n)).astype(np.float32))
    thr = bsc_ops.sampled_boundary_guv(g, u, v, k)
    assert thr.shape == (2, 4)
    out = bsc_ops.select_pack(g, u, v, thr, k)
    for p in range(2):
        for w in range(4):
            one = bsc_ops.select_pack(g[p, w], u[p, w], v[p, w],
                                      thr[p, w], k)
            for a, b in zip(out, one):
                assert torch.equal(a[p, w], b)


def test_threshold_probe_matches_jax(rng):
    """sampled_boundary_guv == JAX's, and == the dense-tensor boundary."""
    n, k = 30000, 300
    g = rng.normal(0, 1, n).astype(np.float32)
    u = pow2(rng, n)
    v = rng.normal(0, 0.2, n).astype(np.float32)
    ref = float(jax.jit(lambda a, b, c: jax_guv(a, b, c, k))(g, u, v))
    tg, tu, tv = (torch.from_numpy(x) for x in (g, u, v))
    got = bsc_ops.sampled_boundary_guv(tg, tu, tv, k)
    dense = sampled_boundary((tv + (tu * 0.9 + tg)).abs(), k)
    assert float(got) == ref == float(dense)


def _decompress_both(vals, idx, n):
    cj, cf = jax_pair(0.01)
    ref = jax.jit(lambda a, b: cj.decompress(a, b, n))(vals, idx)
    fus = jax.jit(lambda a, b: cf.decompress(a, b, n))(vals, idx)
    return np.asarray(ref), np.asarray(fus)


def test_scatter_add_parity_with_collisions():
    """Integer-valued collisions, also inside one run: exact in any
    order.  Tolerance: none."""
    n = 3000
    idx = np.asarray([5, 100, 100, 2999, -1, -1, 7, 5, 0, 2999], np.int32)
    vals = np.asarray([1.0, 2.0, 3.0, -4.0, 9.0, 0.0, 0.5, 0.25, 8.0, 1.0],
                      np.float32)
    ref, fus = _decompress_both(vals, idx, n)
    got = bsc_ops.scatter_add(torch.from_numpy(vals), torch.from_numpy(idx),
                              n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), fus)


@pytest.mark.parametrize("n,m", [(128, 4), (1000, 700), (65536, 2624)])
def test_scatter_add_parity_random_integer_values(rng, n, m):
    idx = rng.randint(-1, n, m).astype(np.int32)
    vals = np.round(rng.normal(0, 8, m)).astype(np.float32)
    ref, fus = _decompress_both(vals, idx, n)
    got = bsc_ops.scatter_add(torch.from_numpy(vals), torch.from_numpy(idx),
                              n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), fus)


def test_scatter_add_two_party_wire_random_floats(rng):
    """The BSC wire at P = 2: two runs of k pairs, indices unique inside
    each run, random float values, sentinel tails.  Tolerance: none."""
    n, k = 272_000, 2720
    runs_v, runs_i = [], []
    for _ in range(2):
        real = rng.randint(k // 2, k)
        ix = np.full(k, -1, np.int32)
        ix[:real] = rng.choice(n, real, replace=False)
        vv = np.zeros(k, np.float32)
        vv[:real] = rng.normal(0, 1, real).astype(np.float32)
        runs_v.append(vv)
        runs_i.append(ix)
    # force collisions between the two parties
    runs_i[1][:100] = runs_i[0][:100]
    vals, idx = np.concatenate(runs_v), np.concatenate(runs_i)
    ref, fus = _decompress_both(vals, idx, n)
    got = bsc_ops.scatter_add(torch.from_numpy(vals), torch.from_numpy(idx),
                              n, run=k)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), fus)


def test_scatter_add_all_sentinel():
    out = bsc_scatter_add(jnp.zeros((64,)), jnp.full((64,), -1, jnp.int32),
                          500, interpret=True)
    got = bsc_ops.scatter_add(torch.zeros(64),
                              torch.full((64,), -1, dtype=torch.int32), 500)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    assert not got.any()


def test_port_compressor_rejects_unported_modes():
    with pytest.raises(NotImplementedError):
        BiSparseCompressor(0.01, select="exact")
    with pytest.raises(NotImplementedError):
        BiSparseCompressor(0.01, sparse_agg=True)
    with pytest.raises(ValueError):
        BiSparseCompressor(0.0)

