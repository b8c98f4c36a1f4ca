"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels
have no CPU mode; the CPU tests cover the plain versions against the JAX
package).  This file imports neither JAX nor the JAX package, so it runs
on a GPU host without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance everywhere: none (bit for bit).  The scatter-add folds each
party's run of pairs in order, so it is bit-equal at any party count;
the optimizer kernels round every op on its own, as the plain versions
do; the 2-bit dequantize sums the parties' parts in party order; the
merge kernel realizes the plain version's combining tree add for add.
"""

import numpy as np
import pytest
import torch

from geomx_tpu_torch.compression import BiSparseCompressor
from geomx_tpu_torch.compression.bucketing import GradientBucketer
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.compression import sparseagg
from geomx_tpu_torch.ops import bsc, bucket, merge, optim, twobit
from geomx_tpu_torch.optim.adam import bias_corrections
from geomx_tpu_torch.parallel.collectives import all_gather_dc, all_to_all


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _resnet20_leaves(dev, expand_workers=False):
    model = get_model("resnet20")
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = []
    for k in model.param_names():
        shape = tuple(model.get_parameter(k).shape)
        if expand_workers:  # a worker-axis sum: stride 0 over the workers
            x = torch.randn((2, 1) + shape, generator=gen, device=dev)
            leaves.append(x.expand((2, 4) + shape))
        else:
            leaves.append(torch.randn((2, 4) + shape, generator=gen,
                                      device=dev))
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_bytes", [4 << 20, 64 << 10])
@pytest.mark.parametrize("expand_workers", [False, True])
def test_flatten_unflatten_match_plain(dev, bucket_bytes, expand_workers):
    leaves = _resnet20_leaves(dev, expand_workers)
    bk = GradientBucketer(leaves, bucket_bytes=bucket_bytes, batch_dims=2)
    rows = [x.flatten(2) for x in leaves]
    got = bucket.flatten(leaves, bk.layout(), bk.bucket_sizes, 2)
    ref = bucket.flatten_plain(rows, bk.layout(), bk.bucket_sizes)
    assert len(got) == len(ref) == bk.num_buckets
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    back = bucket.unflatten(got, bk.layout(), 2)
    for a, b, src in zip(back, bucket.unflatten_plain(ref, bk.layout()),
                         rows):
        assert torch.equal(a, b) and torch.equal(a, src)


@pytest.mark.cuda
def test_unflatten_takes_broadcast_buckets(dev):
    """The uncompressed dc tier's all-reduce returns its sum as a
    broadcast view over the parties; unflatten reads it as the copy."""
    from geomx_tpu_torch.parallel.collectives import psum
    leaves = _resnet20_leaves(dev)
    bk = GradientBucketer(leaves, batch_dims=2)
    buckets = [psum(b, "dc") for b in bucket.flatten(
        leaves, bk.layout(), bk.bucket_sizes, 2)]
    assert not buckets[0].is_contiguous()
    for a, b in zip(bucket.unflatten(buckets, bk.layout(), 2),
                    bucket.unflatten_plain(buckets, bk.layout())):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flatten_table_larger_than_one_launch(dev):
    """More (leaf, row) entries than one launch's parameter table holds:
    the wrapper splits the table and counts every launch."""
    gen = torch.Generator(device=dev).manual_seed(1)
    leaves = [torch.randn(2, 4, 1 + (7 * i) % 300, generator=gen,
                          device=dev) for i in range(200)]
    bk = GradientBucketer(leaves, bucket_bytes=16 << 10, batch_dims=2)
    before = bucket.flatten.launches
    got = bucket.flatten(leaves, bk.layout(), bk.bucket_sizes, 2)
    assert bucket.flatten.launches - before >= 2
    for a, b in zip(got, bucket.flatten_plain(leaves, bk.layout(),
                                              bk.bucket_sizes)):
        assert torch.equal(a, b)


def _rows(dev, n, scale_u=0.1, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(2, 4, n, generator=gen, device=dev)
    u = torch.randn(2, 4, n, generator=gen, device=dev) * scale_u
    v = torch.randn(2, 4, n, generator=gen, device=dev) * 0.2
    return g, u, v


@pytest.mark.cuda
@pytest.mark.parametrize("n,ratio", [(272_512, 0.01), (5000, 0.01),
                                     (1023, 0.03), (10, 0.5),
                                     (131_072, 0.01)])
def test_select_pack_matches_plain(dev, n, ratio):
    g, u, v = _rows(dev, n)
    k = BiSparseCompressor(ratio).k_for(n)
    thr = bsc.sampled_boundary_guv(g, u, v, k)
    got = bsc.select_pack(g, u, v, thr, k)
    ref = bsc.select_pack_plain(g, u, v, thr, k)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_zero", "overflow", "sentinel",
                                  "ties"])
def test_select_pack_edge_cases(dev, case):
    n = 20000
    z = torch.zeros(2, 4, n, device=dev)
    if case == "all_zero":
        g = z.clone()
    elif case == "overflow":
        g = torch.full((2, 4, n), -0.75, device=dev)
    elif case == "sentinel":
        g = z.clone()
        g[..., 7] = 3.0
        g[..., 4096] = -2.0
    else:
        gen = torch.Generator(device=dev).manual_seed(2)
        g = torch.round(torch.randn(2, 4, n, generator=gen,
                                    device=dev) * 2) * 0.5
    k = BiSparseCompressor(0.02).k_for(n)
    thr = bsc.sampled_boundary_guv(g, z, z, k)
    got = bsc.select_pack(g, z, z, thr, k)
    for a, b in zip(got, bsc.select_pack_plain(g, z, z, thr, k)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("parties", [2, 4])
def test_scatter_add_matches_plain(dev, parties):
    n = 272_512
    k = BiSparseCompressor(0.01).k_for(n)
    gen = torch.Generator(device=dev).manual_seed(3)
    shared = torch.randperm(n, generator=gen, device=dev)[:200]
    vals, idx = [], []
    for _ in range(parties):
        # indices unique inside a party's run, 200 shared by every party
        rest = torch.randperm(n, generator=gen, device=dev)
        rest = rest[~torch.isin(rest, shared)][:k - 200]
        ix = torch.cat([shared, rest]).to(torch.int32)
        ix[k - 50:] = -1  # sentinel tail
        idx.append(ix)
        vals.append(torch.randn(k, generator=gen, device=dev))
    v = torch.cat(vals).view(1, -1)
    i = torch.cat(idx).view(1, -1)
    got = bsc.scatter_add(v, i, n, run=k)
    assert torch.equal(got, bsc.scatter_add_plain(v, i, n, run=k))
    assert torch.equal(got, bsc.scatter_add(v, i, n, run=k))


@pytest.mark.cuda
def test_bsc_allreduce_on_replica_axes(dev):
    """The compressor's all-gather path: every replica's dense result
    equals the plain scatter of both parties' pairs."""
    n = 272_512
    comp = BiSparseCompressor(0.01)
    g, u, v = _rows(dev, n)
    out, (nu, nv) = comp.allreduce_leaf(g, (u, v), "dc", 2)
    k = comp.k_for(n)
    thr = bsc.sampled_boundary_guv(g, u, v, k)
    vals, idx, ru, rv = bsc.select_pack_plain(g, u, v, thr, k)
    ref = bsc.scatter_add_plain(
        all_gather_dc(vals).reshape(2, 4, -1),
        all_gather_dc(idx).reshape(2, 4, -1), n, run=k)
    assert torch.equal(out, ref)
    assert torch.equal(nu, ru) and torch.equal(nv, rv)


def _optim_operands(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p, g, m, v = (torch.randn(shape, generator=gen, device=dev) * s
                  for s in (1.0, 1e-2, 1e-2, 1e-2))
    return p, g, m, v.square()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (1000,), (32_768,), (300_000,),
                                   (2, 4, 272_512)])
def test_fused_sgd_momentum_matches_plain(dev, shape):
    p, g, m, _ = _optim_operands(dev, shape, 4)
    kw = dict(lr=0.1, momentum=0.9, cast_dtype=torch.bfloat16)
    before = optim.fused_sgd_momentum.launches
    got = optim.fused_sgd_momentum(p, g, m, **kw)
    assert optim.fused_sgd_momentum.launches == before + 1
    for a, b in zip(got, optim.sgd_momentum_ref(p, g, m, **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (1000,), (32_768,), (300_000,),
                                   (2, 4, 272_512)])
def test_fused_adam_matches_plain(dev, shape):
    p, g, m, v = _optim_operands(dev, shape, 5)
    bc1, bc2 = bias_corrections(0.9, 0.999, 3)
    kw = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8,
              cast_dtype=torch.bfloat16)
    got = optim.fused_adam(p, g, m, v, bc1, bc2, **kw)
    for a, b in zip(got, optim.adam_ref(p, g, m, v, bc1, bc2, **kw)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.5, 0.3])
@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 272_512, 600_000])
def test_quantize_dequantize_2bit_match_plain(dev, n, thr):
    gen = torch.Generator(device=dev).manual_seed(n)
    g = torch.randn(2, 4, n, generator=gen, device=dev) * 0.6
    r = torch.randn(2, 4, n, generator=gen, device=dev) * 0.1
    got = twobit.quantize_2bit(g, r, thr)
    for a, b in zip(got, twobit.quantize_2bit_plain(g, r, thr)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    packed = got[0]
    assert torch.equal(twobit.dequantize_2bit(packed, n, thr),
                       twobit.dequantize_2bit_plain(packed, n, thr))
    wire = all_gather_dc(packed).contiguous()
    assert torch.equal(twobit.dequantize_2bit(wire, n, thr, summed=True),
                       twobit.dequantize_2bit_plain(wire, n, thr,
                                                    summed=True))


@pytest.mark.cuda
def test_quantize_2bit_all_negative_sets_sign_bits(dev):
    g = torch.full((8, 4096), -1.0, device=dev)
    packed, _ = twobit.quantize_2bit(g, torch.zeros_like(g), 0.5)
    assert bool((packed == -0x55555556).all())  # 0xAAAAAAAA as int32
    assert torch.equal(packed, twobit.quantize_2bit_plain(
        g, torch.zeros_like(g), 0.5)[0])


def _party_pairs(gen, parties, k, n, dev, sentinel_frac=0.15):
    vals, idx = [], []
    for _ in range(parties):
        i = torch.randperm(n, generator=gen, device=dev)[:k].to(torch.int32)
        v = torch.randn(k, generator=gen, device=dev)
        drop = torch.rand(k, generator=gen, device=dev) < sentinel_frac
        vals.append(torch.where(drop, 0.0, v))
        idx.append(torch.where(drop, -1, i))
    return torch.cat(vals), torch.cat(idx)


@pytest.mark.cuda
@pytest.mark.parametrize("parties,k,n", [(1, 900, 5000), (2, 1371, 272_512),
                                         (3, 1000, 4000), (4, 1371, 272_512),
                                         (8, 685, 20_000), (64, 50, 300)])
def test_merge_sorted_pairs_matches_plain(dev, parties, k, n):
    gen = torch.Generator(device=dev).manual_seed(parties)
    rows = [_party_pairs(gen, parties, k, n, dev) for _ in range(3)]
    v = torch.stack([r[0] for r in rows])
    i = torch.stack([r[1] for r in rows])
    before = merge.merge_sorted_pairs.launches
    got = merge.merge_sorted_pairs(v, i, parties)
    assert merge.merge_sorted_pairs.launches == before + 1
    ref = merge.merge_sorted_pairs_plain(v, i, parties)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_sentinel", "same_indices",
                                  "too_long_segment", "m1", "m5483"])
def test_merge_sorted_pairs_edge_cases(dev, case):
    gen = torch.Generator(device=dev).manual_seed(7)
    dup = 4
    if case == "all_sentinel":
        v, i = torch.zeros(4000, device=dev), torch.full(
            (4000,), -1, dtype=torch.int32, device=dev)
    elif case == "same_indices":
        same = torch.randperm(50_000, generator=gen, device=dev)[:700]
        v = torch.randn(2800, generator=gen, device=dev)
        i = same.to(torch.int32).repeat(4)
    elif case == "too_long_segment":
        v = torch.randn(40, generator=gen, device=dev)
        i = torch.tensor([5] * 3 + [2] * 29 + [-1] * 4 + [0] * 4,
                         dtype=torch.int32, device=dev)
        dup = 3
    elif case == "m1":
        v = torch.randn(1, generator=gen, device=dev)
        i = torch.tensor([7], dtype=torch.int32, device=dev)
    else:
        v, i = (t[:5483] for t in _party_pairs(gen, 4, 1371, 272_512, dev))
    got = merge.merge_sorted_pairs(v, i, dup)
    for a, b in zip(got, merge.merge_sorted_pairs_plain(v, i, dup)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        merge.merge_sorted_pairs(v, i, 65)


@pytest.mark.cuda
def test_sparse_allreduce_on_replica_axes(dev):
    """The owner-routed merge at path 3's shapes: the card's result equals
    the plain versions' on the same pairs, and every replica agrees."""
    n, P, W = 272_512, 4, 2
    comp = BiSparseCompressor(0.01, sparse_agg=True)
    gen = torch.Generator(device=dev).manual_seed(9)
    g = torch.randn(P, 1, n, generator=gen, device=dev).expand(P, W, n) \
        .contiguous()
    z = torch.zeros_like(g)
    out, (_, nv) = comp.allreduce_leaf(g, (z, z), "dc", P)
    k = comp.k_for(n)
    thr = bsc.sampled_boundary_guv(g, z, z, k)
    vals, idx, _, rv = bsc.select_pack_plain(g, z, z, thr, k)
    slots = sparseagg.push_slots(k, P)
    bv, bi, ofv, ofi = sparseagg.owner_route(vals, idx, n, P, slots)
    mv, mi = merge.merge_sorted_pairs_plain(
        all_to_all(bv, "dc").reshape(P, W, -1),
        all_to_all(bi, "dc").reshape(P, W, -1), P)
    assert torch.equal(comp.last_wire["merged_idx"], mi)
    assert torch.equal(nv, sparseagg.reinject(rv, ofv, ofi))
    assert torch.equal(out, out[:1, :1].expand_as(out))
    # the new state feeds the next step's select kernel
    out2, _ = comp.allreduce_leaf(g, (z, nv), "dc", P)
    assert torch.isfinite(out2).all()


# each configuration's kernel launches in one step of the small ResNet
# (one bucket): the fused apply flattens params and synced grads too
_STEP_LAUNCHES = {
    "flagship": {"fused_flatten": 1, "fused_unflatten": 1,
                 "bsc_select_pack": 1, "bsc_scatter_add": 1},
    "fused_sgd": {"fused_flatten": 3, "fused_unflatten": 2,
                  "bsc_select_pack": 1, "bsc_scatter_add": 1,
                  "fused_sgd_momentum": 1},
    "twobit_adam": {"fused_flatten": 3, "fused_unflatten": 2,
                    "quantize_2bit": 1, "dequantize_2bit": 1,
                    "fused_adam": 1},
    "sparse_agg": {"fused_flatten": 3, "fused_unflatten": 2,
                   "bsc_select_pack": 1, "bsc_scatter_add": 1,
                   "fused_sgd_momentum": 1, "merge_sorted_pairs": 1},
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(_STEP_LAUNCHES))
def test_trainer_step_launches_every_kernel(dev, path):
    from geomx_tpu_torch import GeoConfig, HiPSTopology, ops
    from geomx_tpu_torch.models import ResNet
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    P, W = 2, 4
    if path == "flagship":
        tx, spec = sgd(0.1, momentum=0.9), "bsc,0.01"
    elif path == "fused_sgd":
        tx, spec = optim.fused_optimizer("sgd", learning_rate=0.1), \
            "bsc,0.01"
    elif path == "sparse_agg":
        tx, spec = optim.fused_optimizer("sgd", learning_rate=0.1), \
            "bsc,0.01,select=sampled,sparse_agg=1"
        P, W = 4, 2
    else:
        tx, spec = optim.fused_optimizer("adam", learning_rate=0.01), \
            "2bit,0.5"
    t = Trainer(ResNet((1, 1, 1), (8, 16, 32)), HiPSTopology(P, W), tx,
                config=GeoConfig(num_parties=P, workers_per_party=W,
                                 compression=spec,
                                 fused_optim=path != "flagship"),
                device=dev)
    st = t.init_state(seed=0)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randint(0, 256, (P, W, 8, 16, 16, 3))
                        .astype(np.uint8), device=dev)
    y = torch.as_tensor(rng.randint(0, 10, (P, W, 8)), device=dev)
    ops.reset_launch_counts()
    st, m = t.train_step(st, x, y)
    assert torch.isfinite(m["loss"])
    want = {name: _STEP_LAUNCHES[path].get(name, 0) for name in ops.KERNELS}
    assert ops.launch_counts() == want


# ---- attention: rows 10-13 of the kernel table ------------------------------
# Held at a tolerance, not bit for bit: the kernels sum each row's products
# in another order than the plain versions' matmuls.  fp32: forward 1e-5,
# backward and hop 1e-4 (rtol and atol); bf16 inputs: the bf16 output one
# ulp apart (2e-2), the fp32 gradients to 1e-2.

def _attn(dev, shape, dtype=torch.float32, seed=0, n=3):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for _ in range(n)]


_ATTN_CASES = [((16, 4096, 4, 16), False), ((2, 64, 4, 32), True),
               ((1, 100, 2, 16), True), ((1, 100, 2, 16), False),
               ((1, 16, 1, 8), True), ((2, 128, 4, 64), False),
               ((1, 96, 2, 128), True), ((32, 256, 2, 16), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", _ATTN_CASES)
def test_flash_kernels_match_plain(dev, shape, causal, dtype):
    from geomx_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _attn(dev, shape, dtype, n=4)
    fwd = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    bwd = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    before = fa.flash_attention_with_lse.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    assert fa.flash_attention_with_lse.launches == before + 1
    ref, ref_lse = fa.flash_attention_with_lse_plain(q, k, v, causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), **fwd)
    torch.testing.assert_close(lse, ref_lse, **fwd)
    nolse = fa.flash_attention(q, k, v, causal)
    assert torch.equal(nolse, out)
    delta = fa.attention_delta(ref, g)
    torch.testing.assert_close(fa.flash_dq(q, k, v, g, ref_lse, delta, causal),
                               fa.flash_dq_plain(q, k, v, g, ref_lse, delta,
                                                 causal), **bwd)
    for a, b in zip(fa.flash_dkv(q, k, v, g, ref_lse, delta, causal),
                    fa.flash_dkv_plain(q, k, v, g, ref_lse, delta, causal)):
        torch.testing.assert_close(a, b, **bwd)


@pytest.mark.cuda
def test_flash_kernels_strided_operands_and_empty_keys(dev):
    """q, k, v as the strided slices of a fused projection; no keys at
    all (every row fully masked: zeros, not NaN)."""
    from geomx_tpu_torch.ops import flash_attention as fa
    qkv = _attn(dev, (2, 64, 3, 4, 16), n=1)[0]
    q, k, v = qkv.unbind(2)
    out, lse = fa.flash_attention_with_lse(q, k, v, True)
    ref, _ = fa.flash_attention_with_lse_plain(q, k, v, True)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    out0, lse0 = fa.flash_attention_with_lse(q, k[:, :0], v[:, :0])
    assert torch.equal(out0, torch.zeros_like(out0))
    assert bool((lse0 <= -1e29).all())
    with pytest.raises(ValueError):
        fa.flash_attention(*_attn(dev, (1, 16, 1, 12)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("hops_done", [0, 1])
def test_ring_hop_matches_plain(dev, hops_done, diag, dtype):
    from geomx_tpu_torch.ops import ring_hop
    shape = (32, 128, 4, 16)
    q, k, v = _attn(dev, shape, dtype, seed=hops_done)
    B, L, H, _ = shape
    if hops_done == 0:
        m = torch.full((B, H, L), float("-inf"), device=dev)
        l_acc = torch.zeros((B, H, L), device=dev)
        o = torch.zeros(shape, device=dev)
    else:
        m, o = _attn(dev, (B, H, L), seed=5, n=1)[0], _attn(dev, shape,
                                                             seed=6, n=1)[0]
        l_acc = m.abs() + 0.5
    before = ring_hop.hop.launches
    got = ring_hop.hop(q, k, v, m, l_acc, o, 0.25, diag)
    assert ring_hop.hop.launches == before + 1
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(got, ring_hop.hop_plain(q, k, v, m, l_acc, o, 0.25, diag)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **tol)


# one step's launches of the small SeqClassifier (2 layers) on [2, 1] x sp
# 2: the flash kernels once a layer and replica; the ring hop twice (two
# hops, both shards in one launch); the uncompressed dc tier's bucket
# flatten and unflatten once (two parties: its sum is a broadcast view)
_FLASH = {"flash_attention_fwd": 4, "flash_attention_dq": 4,
          "flash_attention_dkv": 4}
_BUCKET = {"fused_flatten": 1, "fused_unflatten": 1}
_SEQ_LAUNCHES = {None: {**_FLASH, **_BUCKET}, "ulysses": {**_FLASH, **_BUCKET},
                 "ring": {"fused_block": 8, **_BUCKET}}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "ring", "ulysses"])
def test_seq_trainer_step_launches_attention_kernels(dev, mode):
    from geomx_tpu_torch import HiPSTopology, ops
    from geomx_tpu_torch.models import SeqClassifier
    from geomx_tpu_torch.optim import adam
    from geomx_tpu_torch.train import Trainer

    mk = dict(vocab=64, max_len=64, dim=32, num_heads=4, num_layers=2,
              num_classes=4)
    t = Trainer(SeqClassifier(sp_mode=mode, **mk),
                HiPSTopology(2, 1, sp_degree=1 if mode is None else 2),
                adam(1e-3), device=dev,
                single_device_model=SeqClassifier(**mk))
    st = t.init_state(seed=0)
    rng = np.random.RandomState(0)
    tok = rng.randint(4, 64, (2, 1, 4, 64))
    pos = np.broadcast_to(np.arange(64), tok.shape)
    x = torch.as_tensor(np.stack([tok, pos], -1).astype(np.int32), device=dev)
    y = torch.as_tensor(rng.randint(0, 4, (2, 1, 4)), device=dev)
    ops.reset_launch_counts()
    st, m = t.train_step(st, x, y)
    assert torch.isfinite(m["loss"])
    want = {name: _SEQ_LAUNCHES[mode].get(name, 0) for name in ops.KERNELS}
    assert ops.launch_counts() == want
    t.evaluate(st, np.stack([tok[0, 0], pos[0, 0]], -1).astype(np.int32),
               np.zeros(4, np.int64))
    assert ops.variant_launch_counts()["flash_attention_fwd_nolse"] == 2
