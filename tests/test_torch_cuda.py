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

import math

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
    """More leaves than one launch's parameter table holds (200 against
    GX_MAX_COPIES = 128 entries, one a leaf and a tail pad): the wrapper
    splits the table and counts every launch."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("expand_workers", [False, True])
def test_flatten_unflatten_leaves_off_16_byte_alignment(dev, expand_workers):
    """Leaves of 10, 3 and 17 elements among multiples of 4 put their
    neighbours' offsets off 16-byte alignment in the bucket, and rows of
    an odd leaf off it in the leaf: quads whose source and destination
    are not co-aligned go word by word, the partial quads at each row's
    ends too; a stride-0 worker dim reads one row for every worker."""
    gen = torch.Generator(device=dev).manual_seed(3)
    sizes = (16, 10, 64, 3, 8, 17, 256, 12, 1, 40, 4096, 5)
    leaves = []
    for s in sizes:
        if expand_workers:
            x = torch.randn((2, 1, s), generator=gen, device=dev)
            leaves.append(x.expand(2, 4, s))
        else:
            leaves.append(torch.randn((2, 4, s), generator=gen, device=dev))
    bk = GradientBucketer(leaves, bucket_bytes=8 << 10, batch_dims=2)
    offsets = [off for _, off, _ in bk.layout()]
    assert any(off % 4 for off in offsets)
    got = bucket.flatten(leaves, bk.layout(), bk.bucket_sizes, 2)
    ref = bucket.flatten_plain(leaves, bk.layout(), bk.bucket_sizes)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    for a, b, src in zip(bucket.unflatten(got, bk.layout(), 2),
                         bucket.unflatten_plain(ref, bk.layout()), leaves):
        assert torch.equal(a, b) and torch.equal(a, src)


def _rows(dev, n, scale_u=0.1, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(2, 4, n, generator=gen, device=dev)
    u = torch.randn(2, 4, n, generator=gen, device=dev) * scale_u
    v = torch.randn(2, 4, n, generator=gen, device=dev) * 0.2
    return g, u, v


@pytest.mark.cuda
@pytest.mark.parametrize("n,ratio", [(272_512, 0.01), (5000, 0.01),
                                     (1023, 0.03), (10, 0.5),
                                     (131_072, 0.01), (272_513, 0.01)])
def test_select_pack_matches_plain(dev, n, ratio):
    g, u, v = _rows(dev, n)
    k = BiSparseCompressor(ratio).k_for(n)
    thr = bsc.sampled_boundary_guv(g, u, v, k)
    got = bsc.select_pack(g, u, v, thr, k)
    ref = bsc.select_pack_plain(g, u, v, thr, k)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [272_512, 272_513])
def test_select_pack_straddles_k_over_many_tiles(dev, n):
    """Values on a grid of 0.5 put the boundary on a level shared by ~13%
    of each row, spread over all of the row's ~133 tiles: the primaries
    fall short of k and the ties overflow it, so the tie buffer, the
    last tile's move of ties 0 .. k - n_primary - 1 and the zeroing of
    their u' and v' all run (n = 272,513 on the scalar route).  Bit-equal
    to the plain version, the same bits on a second call, one launch a
    call."""
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.round(torch.randn(2, 4, n, generator=gen, device=dev) * 2) * 0.5
    z = torch.zeros_like(g)
    k = BiSparseCompressor(0.1).k_for(n)
    thr = bsc.sampled_boundary_guv(g, z, z, k)
    mag = g.abs()
    primaries = (mag > thr[..., None]).sum(-1)
    ties = (mag == thr[..., None]).sum(-1)
    assert bool((primaries < k).all()) and bool((primaries + ties > k).all())
    before = bsc.select_pack.launches
    got = bsc.select_pack(g, z, z, thr, k)
    assert bsc.select_pack.launches == before + 1
    for a, b in zip(got, bsc.select_pack_plain(g, z, z, thr, k)):
        assert torch.equal(a, b)
    for a, b in zip(got, bsc.select_pack(g, z, z, thr, k)):
        assert torch.equal(a, b)


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


def _scatter_runs(dev, parties, k, n, seed, rows=8):
    """``[2, 4]`` rows of ``parties`` runs of ``k`` pairs in any order:
    indices unique inside a run, 200 shared by every run of the row
    (collisions across parties), none in [65_536, 98_304) (four output
    slices of the kernel's 8,192 floats that no pair touches), a sentinel
    tail of 50 a run, and row 5 all sentinels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.cat([torch.arange(0, 65_536),
                      torch.arange(98_304, n)]).to(dev)
    vals, idx = [], []
    for row in range(rows):
        perm = pick[torch.randperm(len(pick), generator=gen, device=dev)]
        shared, rest = perm[:200], perm[200:]
        for _ in range(parties):
            ix = torch.cat([shared, rest[torch.randperm(
                len(rest), generator=gen, device=dev)[:k - 200]]])
            ix = ix[torch.randperm(k, generator=gen, device=dev)]
            ix[k - 50:] = -1
            if row == 5:
                ix[:] = -1
            idx.append(ix.to(torch.int32))
            vals.append(torch.randn(k, generator=gen, device=dev))
    shape = (2, 4, parties * k)
    return torch.cat(vals).view(shape), torch.cat(idx).view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [272_512, 272_513])
@pytest.mark.parametrize("parties,k", [(2, 2726), (3, 2726), (4, 2726),
                                       (3, 1001), (4, 2727)])
def test_scatter_add_runs_on_replica_rows(dev, parties, k, n):
    """8 rows of P runs; k = 2,726 and odd k put the run starts off 16-byte
    alignment; n = 272,513 writes the output element by element.  One
    launch a call, bit-equal to the plain version, the same bits twice."""
    v, i = _scatter_runs(dev, parties, k, n, seed=parties * k + n)
    before = bsc.scatter_add.launches
    got = bsc.scatter_add(v, i, n, run=k)
    assert bsc.scatter_add.launches == before + 1
    assert torch.equal(got, bsc.scatter_add_plain(v, i, n, run=k))
    assert torch.equal(got, bsc.scatter_add(v, i, n, run=k))
    assert not got[..., 65_536:98_304].any() and not got[1, 1].any()
    assert bool((got[0, 0] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_scatter_add_pairs_off_16_byte_alignment(dev, offset):
    """vals and idx views 4-12 bytes off 16-byte alignment give the plain
    version's bits."""
    v, i = _scatter_runs(dev, 3, 2726, 272_512, seed=offset)
    vb = torch.empty(v.numel() + offset, device=dev)
    ib = torch.empty(i.numel() + offset, dtype=torch.int32, device=dev)
    va = vb[offset:].view(v.shape)
    ia = ib[offset:].view(i.shape)
    va.copy_(v)
    ia.copy_(i)
    assert va.data_ptr() % 16 == 4 * offset and va.is_contiguous()
    got = bsc.scatter_add(va, ia, 272_512, run=2726)
    assert torch.equal(got, bsc.scatter_add_plain(v, i, 272_512, run=2726))


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4093, 4094, 4095, 272_512])
def test_quantize_2bit_replica_rows(dev, n):
    """[2, 4, n]: n % 4 != 0 runs the element-wise branch, n = 272,512 the
    16-byte one.  One launch a call, bit-equal, the same bits twice."""
    gen = torch.Generator(device=dev).manual_seed(n + 1)
    g = torch.randn(2, 4, n, generator=gen, device=dev) * 0.6
    r = torch.randn(2, 4, n, generator=gen, device=dev) * 0.1
    before = twobit.quantize_2bit.launches
    got = twobit.quantize_2bit(g, r, 0.5)
    assert twobit.quantize_2bit.launches == before + 1
    for a, b, c in zip(got, twobit.quantize_2bit_plain(g, r, 0.5),
                       twobit.quantize_2bit(g, r, 0.5)):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    codes = twobit.dequantize_2bit_plain(got[0], n, 0.5)
    assert bool((codes > 0).any()) and bool((codes < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4095, 272_512])
@pytest.mark.parametrize("which", ["inputs", "outputs"])
def test_quantize_2bit_off_16_byte_alignment(dev, n, which):
    """Operands one float off 16-byte alignment, passed to the binding
    directly (the wrapper's .contiguous() keeps such a view as it is, but
    the binding is what the kernel sees): the element-wise branch."""
    from geomx_tpu_torch.ops._build import kernels
    gen = torch.Generator(device=dev).manual_seed(n)

    def rows(scale, off):
        flat = torch.randn(8 * n + 1, generator=gen, device=dev) * scale
        return flat[off:off + 8 * n].view(8, n)

    off_in, off_out = (1, 0) if which == "inputs" else (0, 1)
    g, r = rows(0.6, off_in), rows(0.1, off_in)
    new_r = rows(0.0, off_out)
    words = twobit.num_words(n)
    packed = torch.empty(8 * words + 1, dtype=torch.int32, device=dev)
    packed = packed[off_out:off_out + 8 * words].view(8, words)
    assert (g.data_ptr() % 16 == 4) == (which == "inputs")
    assert (new_r.data_ptr() % 16 == 4) == (which == "outputs")
    kernels().quantize_2bit(g, r, 0.5, packed, new_r)
    want = twobit.quantize_2bit_plain(g, r, 0.5)
    assert torch.equal(packed, want[0]) and torch.equal(new_r, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 2, 3, 8])
@pytest.mark.parametrize("layout", ["aligned", "odd_n", "packed_off_16"])
def test_dequantize_2bit_parts_and_layouts(dev, parts, layout):
    """The summed dequantize over [2, 4] rows of 1-8 parties' parts:
    16-byte quads (n = 272,512), the element-wise branch for n % 4 != 0
    and for packed one word off 16-byte alignment; every code 2 sums to
    -parts * thr.  One launch a call, bit-equal, the same bits twice."""
    n = 272_511 if layout == "odd_n" else 272_512
    gen = torch.Generator(device=dev).manual_seed(parts)
    g = torch.randn(2, 4, parts, n, generator=gen, device=dev) * 0.6
    g[1, 3] = -1.0  # one replica row of code 2 only: every sign bit set
    packed, _ = twobit.quantize_2bit_plain(g, torch.zeros_like(g), 0.5)
    if layout == "packed_off_16":
        off = torch.empty(packed.numel() + 1, dtype=torch.int32,
                          device=dev)[1:].view(packed.shape)
        off.copy_(packed)
        assert off.data_ptr() % 16 == 4
        packed = off
    before = twobit.dequantize_2bit.launches
    got = twobit.dequantize_2bit(packed, n, 0.5, summed=True)
    assert twobit.dequantize_2bit.launches == before + 1
    bits = got.view(torch.int32)
    assert torch.equal(bits, twobit.dequantize_2bit_plain(
        packed, n, 0.5, summed=True).view(torch.int32))
    assert torch.equal(bits, twobit.dequantize_2bit(
        packed, n, 0.5, summed=True).view(torch.int32))
    assert bool((got[1, 3] == -0.5 * parts).all())


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("n", [272_512, 272_511])
def test_dequantize_2bit_keeps_the_sign_of_zero(dev, parts, n):
    """At threshold 0 (which the wrappers refuse, so through the binding)
    a code 2 decodes to -0.0, and any number of -0.0 parts sums to -0.0:
    the kernel's sum starts from the identity of +, not from +0.0."""
    from geomx_tpu_torch.ops._build import kernels
    g = torch.full((8, parts, n), -1.0, device=dev)
    packed, _ = twobit.quantize_2bit_plain(g, torch.zeros_like(g), 0.5)
    out = torch.empty(8, n, device=dev)
    kernels().dequantize_2bit(packed, n, 0.0, out)
    assert bool((out.view(torch.int32) == -0x80000000).all())


@pytest.mark.cuda
def test_quantize_2bit_sign_bits_at_the_bucket(dev):
    """Every code 2 over 8 rows of 272,512: each complete block row's word
    is 0xAAAAAAAA (the sign bit set without a signed overflow); the last
    block row holds 128 elements, code 2 at j = 0 only."""
    n = 272_512
    g = torch.full((2, 4, n), -1.0, device=dev)
    packed, _ = twobit.quantize_2bit(g, torch.zeros_like(g), 0.5)
    full = (n // 2048) * 128
    assert bool((packed[..., :full] == -0x55555556).all())
    assert bool((packed[..., full:] == 2).all())
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


def _tile_straddle(dev, m=600):
    """Sorted keys 0, 1, 2, ... with key 252 seven times from position 252
    on (across the kernel's 256-position tile) and a unique last key (a
    head at column m - 1)."""
    return torch.cat([torch.arange(253), torch.full((6,), 252),
                      torch.arange(253, m - 6)]).to(torch.int32).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_sentinel", "same_indices",
                                  "too_long_segment", "m1", "m5483",
                                  "straddle_tile", "m_below_halo"])
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
    elif case == "straddle_tile":
        i, dup = _tile_straddle(dev), 8
        v = torch.randn(i.numel(), generator=gen, device=dev)
    elif case == "m_below_halo":
        v = torch.randn(5, generator=gen, device=dev)
        i = torch.tensor([3, 1, 3, 9, 1], dtype=torch.int32, device=dev)
        dup = 64
    else:
        v, i = (t[:5483] for t in _party_pairs(gen, 4, 1371, 272_512, dev))
    got = merge.merge_sorted_pairs(v, i, dup)
    for a, b in zip(got, merge.merge_sorted_pairs_plain(v, i, dup)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        merge.merge_sorted_pairs(v, i, 65)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_merge_kernel_finds_heads_without_ranks(dev, rows, monkeypatch):
    """The wrapper builds no ranks on the card; a segment across the
    kernel's tile and a head at column m - 1, at one row and at several,
    bit-equal to the plain version (ranks, then the tree); two calls give
    the same bits."""
    gen = torch.Generator(device=dev).manual_seed(rows)
    i = _tile_straddle(dev).repeat(rows, 1)
    v = torch.randn(i.shape, generator=gen, device=dev)
    monkeypatch.setattr(merge, "segment_ranks", None)  # must not be called
    got = merge.merge_sorted_pairs(v, i, 8)
    again = merge.merge_sorted_pairs(v, i, 8)
    monkeypatch.undo()
    for a, b, c in zip(got, merge.merge_sorted_pairs_plain(v, i, 8), again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert bool((got[1][:, 252] == 252).all())
    assert bool((got[1][:, -1] == 593).all())


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


# ---- the sharded updates: kernels 3-6 on shards -----------------------------
# ZeRO's [2, 4, 68,224] bucket shards (ResNet-20's 272,896-element bucket at
# pad_to 512, W = 4) and MultiGPS's per-leaf shards of ceil(n / 4)
# elements; the operands also as the views the collectives return.

@pytest.mark.cuda
@pytest.mark.parametrize("n", [576, 1_152, 9_216, 68_224])
def test_select_pack_and_scatter_add_on_shards(dev, n):
    g, u, v = _rows(dev, n)
    k = BiSparseCompressor(0.01).k_for(n)
    thr = bsc.sampled_boundary_guv(g, u, v, k)
    got = bsc.select_pack(g, u, v, thr, k)
    for a, b in zip(got, bsc.select_pack_plain(g, u, v, thr, k)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    vals = all_gather_dc(got[0]).reshape(2, 4, -1)
    idx = all_gather_dc(got[1]).reshape(2, 4, -1)
    assert torch.equal(bsc.scatter_add(vals, idx, n, run=k),
                       bsc.scatter_add_plain(vals, idx, n, k))


@pytest.mark.cuda
def test_select_pack_and_scatter_add_on_gathered_views(dev):
    """select/pack copies a broadcast (stride 0 over the workers) or
    transposed g to dense rows; the scatter-add reads the tiled
    all-gather's broadcast view of four workers' pairs: both bit-equal
    to their plain versions on the dense copies."""
    from geomx_tpu_torch.parallel.collectives import all_gather
    n = 68_224
    k = BiSparseCompressor(0.01).k_for(n)
    gen = torch.Generator(device=dev).manual_seed(7)
    _, u, v = _rows(dev, n)
    for g in (torch.randn(2, 1, n, generator=gen, device=dev)
              .expand(2, 4, n),
              torch.randn(4, 2, n, generator=gen, device=dev)
              .transpose(0, 1)):
        assert not g.is_contiguous()
        thr = bsc.sampled_boundary_guv(g, u, v, k)
        got = bsc.select_pack(g, u, v, thr, k)
        for a, b in zip(got, bsc.select_pack_plain(g.contiguous(), u, v,
                                                   thr, k)):
            assert torch.equal(a, b)
    vals = all_gather(got[0], "worker", tiled=True)
    idx = all_gather(got[1], "worker", tiled=True)
    assert vals.stride(1) == 0 and vals.shape == (2, 4, 4 * k)
    assert torch.equal(bsc.scatter_add(vals, idx, n, run=k),
                       bsc.scatter_add_plain(vals.contiguous(),
                                             idx.contiguous(), n, k))


@pytest.mark.cuda
def test_fused_optimizers_over_zero_shards(dev):
    p, g, m, v = _optim_operands(dev, (2, 4, 68_224), 8)
    got = optim.fused_sgd_momentum(p, g, m, lr=0.1, momentum=0.9)
    for a, b in zip(got, optim.sgd_momentum_ref(p, g, m, lr=0.1,
                                                momentum=0.9)):
        assert torch.equal(a, b)
    bc1, bc2 = bias_corrections(0.9, 0.999, 3)
    kw = dict(lr=0.01, b1=0.9, b2=0.999, eps=1e-8)
    got = optim.fused_adam(p, g, m, v, bc1, bc2, **kw)
    for a, b in zip(got, optim.adam_ref(p, g, m, v, bc1, bc2, **kw)):
        assert torch.equal(a, b)


# one step of the small ResNet ((1, 1, 1) stages of 8, 16, 32 filters,
# one 19,968-element bucket at pad_to 512): ZeRO flattens the gradient
# and the params (two flatten launches) and unflattens the gathered
# params; MultiGPS at bound 1000 shards four leaves, two of whose shards
# (1,152 and 2,304 elements) reach BSC's min_sparse_size of 1,024
_SHARDED_STEP_LAUNCHES = {
    "zero_sgd": {"fused_flatten": 2, "fused_unflatten": 1,
                 "bsc_select_pack": 1, "bsc_scatter_add": 1},
    "zero_fused_adam": {"fused_flatten": 2, "fused_unflatten": 1,
                        "bsc_select_pack": 1, "bsc_scatter_add": 1,
                        "fused_adam": 1},
    "multigps_bsc": {"bsc_select_pack": 2, "bsc_scatter_add": 2},
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(_SHARDED_STEP_LAUNCHES))
def test_sharded_trainer_step_launches_every_kernel(dev, path):
    from geomx_tpu_torch import GeoConfig, HiPSTopology, ops
    from geomx_tpu_torch.models import ResNet
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    fields = {"zero_sgd": dict(zero=True),
              "zero_fused_adam": dict(zero=True, fused_optim=True),
              "multigps_bsc": dict(multi_gps=True, bigarray_bound=1000)}
    tx = optim.fused_optimizer("adam", learning_rate=0.01) \
        if path == "zero_fused_adam" else sgd(0.1, momentum=0.9)
    t = Trainer(ResNet((1, 1, 1), (8, 16, 32)), HiPSTopology(2, 4), tx,
                config=GeoConfig(num_parties=2, workers_per_party=4,
                                 compression="bsc,0.01", **fields[path]),
                device=dev)
    st = t.init_state(seed=0)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randint(0, 256, (2, 4, 8, 16, 16, 3))
                        .astype(np.uint8), device=dev)
    y = torch.as_tensor(rng.randint(0, 10, (2, 4, 8)), device=dev)
    ops.reset_launch_counts()
    st, m = t.train_step(st, x, y)
    assert torch.isfinite(m["loss"])
    want = {name: _SHARDED_STEP_LAUNCHES[path].get(name, 0)
            for name in ops.KERNELS}
    assert ops.launch_counts() == want
    for v in st.params.values():
        assert torch.equal(v, v[:1, :1].expand_as(v))


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


# the tile edges of the tensor-core backward (64-row tiles; 32 and 16 rows
# of the streamed operand at head dims 64 and 128): Lq and Lk off the
# tiles and unequal, Lq below one tile, the causal diagonal inside a
# tile, keys no query attends to, the narrowest and widest heads in bf16
_BWD_EDGE_CASES = [((1, 100, 2, 16), 70, False, torch.float32),
                   ((1, 70, 2, 16), 130, True, torch.float32),
                   ((2, 40, 2, 16), 40, True, torch.float32),
                   ((1, 40, 2, 32), 200, True, torch.float32),
                   ((1, 200, 2, 16), 200, True, torch.float32),
                   ((1, 90, 2, 64), 75, True, torch.float32),
                   ((1, 50, 2, 128), 37, False, torch.float32),
                   ((1, 100, 2, 8), 130, True, torch.bfloat16),
                   ((1, 70, 2, 128), 90, True, torch.bfloat16)]


def _bwd_inputs(dev, qshape, lk, causal, dtype, strided=False):
    """q, k, v, dO, lse and delta of one backward case (lse and delta from
    the plain forward); ``strided``: every operand a slice 4 bytes into
    rows of D + 1, so neither base nor row stride is 16-byte aligned."""
    from geomx_tpu_torch.ops import flash_attention as fa
    B, Lq, H, D = qshape
    pad = 1 if strided else 0
    q, g = _attn(dev, (B, Lq, H, D + pad), dtype, seed=1, n=2)
    k, v = _attn(dev, (B, lk, H, D + pad), dtype, seed=2, n=2)
    q, g, k, v = (x[..., pad:] for x in (q, g, k, v))
    ref, lse = fa.flash_attention_with_lse_plain(q, k, v, causal)
    return q, k, v, g, lse, fa.attention_delta(ref, g)


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,lk,causal,dtype", _BWD_EDGE_CASES)
def test_flash_backward_tile_edges(dev, qshape, lk, causal, dtype):
    from geomx_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _bwd_inputs(dev, qshape, lk, causal, dtype)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(fa.flash_dq(*args, causal),
                               fa.flash_dq_plain(*args, causal), **tol)
    for a, b in zip(fa.flash_dkv(*args, causal),
                    fa.flash_dkv_plain(*args, causal)):
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_unaligned_operands(dev, dtype):
    """Operands the tiles cannot reach by 16-byte copies: the same
    results by plain loads."""
    from geomx_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _bwd_inputs(dev, (2, 100, 2, 16), 100, True, dtype, strided=True)
    assert args[0].stride(1) * args[0].element_size() % 16 != 0
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(fa.flash_dq(*args, True),
                               fa.flash_dq_plain(*args, True), **tol)
    for a, b in zip(fa.flash_dkv(*args, True),
                    fa.flash_dkv_plain(*args, True)):
        torch.testing.assert_close(a, b, **tol)
    # no key at all: every row of dq is zero
    q, k, v, g, lse, delta = args
    dq0 = fa.flash_dq(q, k[:, :0], v[:, :0], g, lse, delta, False)
    assert torch.equal(dq0, torch.zeros_like(dq0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((4, 1024, 4, 16), False),
                                          ((1, 200, 2, 64), True),
                                          ((1, 100, 2, 128), False)])
def test_flash_backward_gives_the_same_bits_every_call(dev, shape, causal):
    """No atomics: each gradient element is summed in one fixed order."""
    from geomx_tpu_torch.ops import flash_attention as fa
    args = _bwd_inputs(dev, shape, shape[1], causal, torch.float32)
    dq = fa.flash_dq(*args, causal)
    dk, dv = fa.flash_dkv(*args, causal)
    assert torch.equal(dq, fa.flash_dq(*args, causal))
    dk2, dv2 = fa.flash_dkv(*args, causal)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


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
    # a head dim between the built ones runs zero-padded to the next; past
    # the widest, zero-padded to a multiple of 128 on the wide route
    for D in (12, 136):
        q, k, v = _attn(dev, (1, 16, 1, D))
        torch.testing.assert_close(
            fa.flash_attention(q, k, v),
            fa.flash_attention_with_lse_plain(q, k, v, with_lse=False)[0],
            rtol=1e-5, atol=1e-5)


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


# the tile edges of the tensor-core forward (64-row query groups, two a
# block up to head dim 16; 64-key tiles, 32 and 16 at head dims 64 and
# 128): Lq and Lk off the tiles and unequal, Lk below one tile and zero,
# the causal diagonal inside a tile, the narrowest and widest heads in
# fp32 and bf16
_FWD_EDGE_CASES = [((1, 100, 2, 16), 70, False, torch.float32),
                   ((1, 70, 2, 16), 130, True, torch.float32),
                   ((1, 100, 2, 16), 30, False, torch.float32),
                   ((2, 40, 2, 16), 40, True, torch.float32),
                   ((1, 50, 2, 16), 0, False, torch.float32),
                   ((1, 200, 2, 32), 200, True, torch.float32),
                   ((1, 90, 2, 64), 75, True, torch.float32),
                   ((1, 100, 2, 8), 130, True, torch.float32),
                   ((1, 100, 2, 8), 130, True, torch.bfloat16),
                   ((1, 70, 2, 128), 90, True, torch.float32),
                   ((1, 70, 2, 128), 90, True, torch.bfloat16),
                   ((1, 50, 2, 128), 37, False, torch.float32)]


def _fwd_close(fa, q, k, v, causal):
    """The forward against its plain version; the no-lse variant and a
    second call give the same bits."""
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_with_lse_plain(q, k, v, causal)
    tol = dict(rtol=1e-5, atol=1e-5) if q.dtype == torch.float32 \
        else dict(rtol=2e-2, atol=2e-2)
    assert out.dtype == q.dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **tol)
    assert torch.equal(fa.flash_attention(q, k, v, causal), out)
    out2, lse2 = fa.flash_attention_with_lse(q, k, v, causal)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,lk,causal,dtype", _FWD_EDGE_CASES)
def test_flash_forward_tile_edges(dev, qshape, lk, causal, dtype):
    from geomx_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _bwd_inputs(dev, qshape, lk, causal, dtype)[:3]
    _fwd_close(fa, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 128])
def test_flash_forward_unaligned_operands(dev, D, dtype):
    """Operands the key tiles cannot reach by 16-byte copies: the same
    results by plain loads."""
    from geomx_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _bwd_inputs(dev, (2, 100, 2, D), 100, True, dtype,
                          strided=True)[:3]
    assert k.stride(1) * k.element_size() % 16 != 0
    _fwd_close(fa, q, k, v, True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((4, 1024, 4, 16), False),
                                          ((2, 300, 2, 16), True),
                                          ((1, 200, 2, 64), True)])
def test_flash_forward_gives_the_same_bits_every_call(dev, shape, causal):
    """Each output element is summed by one warpgroup in a fixed order."""
    from geomx_tpu_torch.ops import flash_attention as fa
    q, k, v = _attn(dev, shape, seed=3)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    for _ in range(2):
        o2, l2 = fa.flash_attention_with_lse(q, k, v, causal)
        assert torch.equal(o2, out) and torch.equal(l2, lse)


def _hop_carries(dev, shape, hops_done, seed=5):
    B, L, H, _ = shape
    if hops_done == 0:
        return (torch.full((B, H, L), float("-inf"), device=dev),
                torch.zeros((B, H, L), device=dev),
                torch.zeros(shape, device=dev))
    m, o = _attn(dev, (B, H, L), seed=seed, n=1)[0], \
        _attn(dev, shape, seed=seed + 1, n=1)[0]
    return m, m.abs() + 0.5, o


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("hops_done", [0, 1])
@pytest.mark.parametrize("shape", [(2, 40, 2, 16), (3, 24, 2, 8),
                                   (1, 48, 2, 128)])
def test_ring_hop_below_one_query_group(dev, shape, hops_done, diag, dtype):
    """Lq below the 64 rows of a warpgroup: the carries match the plain
    hop's, and two calls give the same bits."""
    from geomx_tpu_torch.ops import ring_hop
    q, k, v = _attn(dev, shape, dtype, seed=hops_done)
    m, l_acc, o = _hop_carries(dev, shape, hops_done)
    got = ring_hop.hop(q, k, v, m, l_acc, o, 0.25, diag)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    for a, b in zip(got, ring_hop.hop_plain(q, k, v, m, l_acc, o, 0.25, diag)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(got, ring_hop.hop(q, k, v, m, l_acc, o, 0.25, diag)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [24, 40, 100])
def test_attention_kernels_at_unbuilt_head_dims(dev, D, dtype):
    """A head dim the kernels are not built for runs on the next built
    one, zero-padded, with the true dim's scale: the forward, dq, dk/dv
    and the hop (both modes) against their plain versions at the true
    dim, at the tile-edge tolerances; the outputs keep the true dim."""
    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import ring_hop
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = dtype == torch.float32
    n = fa.flash_dq.launches
    q, k, v = _bwd_inputs(dev, (1, 90, 2, D), 75, True, dtype)[:3]
    _fwd_close(fa, q, k, v, True)
    args = _bwd_inputs(dev, (1, 90, 2, D), 75, True, dtype)
    tol = dict(rtol=1e-4, atol=1e-4) if fp32 else dict(rtol=1e-2, atol=1e-2)
    dq = fa.flash_dq(*args, True)
    assert dq.shape == q.shape and fa.flash_dq.launches == n + 1
    torch.testing.assert_close(dq, fa.flash_dq_plain(*args, True), **tol)
    for a, b in zip(fa.flash_dkv(*args, True),
                    fa.flash_dkv_plain(*args, True)):
        assert a.shape == k.shape
        torch.testing.assert_close(a, b, **tol)
    shape = (2, 40, 2, D)
    q, k, v = _attn(dev, shape, dtype, seed=4)
    m, l_acc, o = _hop_carries(dev, shape, 1)
    for diag in (False, True):
        got = ring_hop.hop(q, k, v, m, l_acc, o, 0.2, diag)
        assert got[2].shape == shape
        for a, b in zip(got, ring_hop.hop_plain(q, k, v, m, l_acc, o, 0.2,
                                                diag)):
            torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [136, 256, 384])
def test_attention_kernels_above_head_dim_128(dev, D, dtype):
    """Head dims above 128 run on the wide route: 136 zero-padded to 256,
    each block two 128-wide chunks of its output over scores it computes
    once, its 64 fixed rows resident.  The forward, dq, dk/dv and the hop
    (both modes) against their plain versions at the true dim, at the
    tile-edge tolerances (fp32: 1e-5 forward, 1e-4 backward and hop); two
    calls give the same bits; the outputs keep the true dim."""
    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import ring_hop
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32 = dtype == torch.float32
    q, k, v = _bwd_inputs(dev, (1, 90, 2, D), 75, True, dtype)[:3]
    _fwd_close(fa, q, k, v, True)
    q, k, v = _bwd_inputs(dev, (2, 70, 2, D), 130, False, dtype)[:3]
    _fwd_close(fa, q, k, v, False)
    tol = dict(rtol=1e-4, atol=1e-4) if fp32 else dict(rtol=1e-2, atol=1e-2)
    for causal in (True, False):
        args = _bwd_inputs(dev, (1, 90, 2, D), 75, causal, dtype)
        dq = fa.flash_dq(*args, causal)
        assert dq.shape == args[0].shape
        torch.testing.assert_close(dq, fa.flash_dq_plain(*args, causal),
                                   **tol)
        assert torch.equal(dq, fa.flash_dq(*args, causal))
        dkv = fa.flash_dkv(*args, causal)
        for a, b, c in zip(dkv, fa.flash_dkv_plain(*args, causal),
                           fa.flash_dkv(*args, causal)):
            assert a.shape == args[1].shape and torch.equal(a, c)
            torch.testing.assert_close(a, b, **tol)
    shape = (2, 40, 2, D)
    q, k, v = _attn(dev, shape, dtype, seed=4)
    for hops_done in (0, 1):
        m, l_acc, o = _hop_carries(dev, shape, hops_done)
        for diag in (False, True):
            got = ring_hop.hop(q, k, v, m, l_acc, o, 0.2, diag)
            assert got[2].shape == shape
            for a, b, c in zip(got, ring_hop.hop_plain(q, k, v, m, l_acc, o,
                                                       0.2, diag),
                               ring_hop.hop(q, k, v, m, l_acc, o, 0.2,
                                            diag)):
                assert torch.isfinite(a).all() and torch.equal(a, c)
                torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 384, 640])
def test_wide_backward_long_ragged_lengths(dev, D, dtype, causal, layout):
    """dq and dk/dv on the wide route over many 16-row tiles, off every
    tile and block edge (Lq 333, Lk 301): the streamed tiles pass through
    both stages many times, and the causal start and the ragged last tile
    mask as the plain versions do.  D = 384 fp32 and D = 640 bf16 hold
    more chunks than stay in shared memory.  "fused": q, dO and k, v as
    the strided slices of fused projections.  Against the plain versions
    at fp32 1e-4 (bf16 1e-2); two calls give the same bits."""
    from geomx_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Lq, Lk = 2, 2, 333, 301
    if layout == "fused":
        q, g = _attn(dev, (B, Lq, 2, H, D), dtype, seed=1, n=1)[0].unbind(2)
        k, v = _attn(dev, (B, Lk, 2, H, D), dtype, seed=2, n=1)[0].unbind(2)
    else:
        q, g = _attn(dev, (B, Lq, H, D), dtype, seed=1, n=2)
        k, v = _attn(dev, (B, Lk, H, D), dtype, seed=2, n=2)
    ref, lse = fa.flash_attention_with_lse_plain(q, k, v, causal)
    args = (q, k, v, g, lse, fa.attention_delta(ref, g))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    dq = fa.flash_dq(*args, causal)
    assert dq.shape == q.shape
    torch.testing.assert_close(dq, fa.flash_dq_plain(*args, causal), **tol)
    assert torch.equal(dq, fa.flash_dq(*args, causal))
    for a, b, c in zip(fa.flash_dkv(*args, causal),
                       fa.flash_dkv_plain(*args, causal),
                       fa.flash_dkv(*args, causal)):
        assert a.shape == k.shape and torch.equal(a, c)
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [256, 384, 640])
def test_wide_forward_long_ragged_lengths(dev, D, dtype, causal, layout):
    """The forward (with lse) and the hop (first and later hops, full and
    diagonal) on the wide route over many key tiles, off every tile and
    block edge (Lq 333, Lk 301): the K steps and V^T tiles pass through
    their stages many times, and the causal start and the ragged last
    tile mask as the plain versions do.  D = 640 fp32 holds more of Q
    than stays in shared memory.  "fused": q and k, v as the strided
    slices of fused projections.  Against the plain versions at fp32
    1e-5 forward and 1e-4 hop (bf16 1e-2); two calls give the same
    bits."""
    from geomx_tpu_torch.ops import flash_attention as fa
    from geomx_tpu_torch.ops import ring_hop
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Lq, Lk = 2, 2, 333, 301
    if layout == "fused":
        q = _attn(dev, (B, Lq, 2, H, D), dtype, seed=1, n=1)[0][:, :, 0]
        k, v = _attn(dev, (B, Lk, 2, H, D), dtype, seed=2, n=1)[0].unbind(2)
    else:
        q = _attn(dev, (B, Lq, H, D), dtype, seed=1, n=1)[0]
        k, v = _attn(dev, (B, Lk, H, D), dtype, seed=2, n=2)
    fp32 = dtype == torch.float32
    fwd = dict(rtol=1e-5, atol=1e-5) if fp32 else dict(rtol=1e-2, atol=1e-2)
    hop = dict(rtol=1e-4, atol=1e-4) if fp32 else dict(rtol=1e-2, atol=1e-2)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_with_lse_plain(q, k, v, causal)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **fwd)
    torch.testing.assert_close(lse, ref_lse, **fwd)
    out2, lse2 = fa.flash_attention_with_lse(q, k, v, causal)
    assert torch.equal(out2, out) and torch.equal(lse2, lse)
    for hops_done in (0, 1):
        m, l_acc, o = _hop_carries(dev, q.shape, hops_done)
        for diag in (False, True):
            args = (q, k, v, m, l_acc, o, 0.2, diag, Lq)
            got = ring_hop.hop(*args)
            for a, b, c in zip(got, ring_hop.hop_plain(*args),
                               ring_hop.hop(*args)):
                assert torch.isfinite(a).all() and torch.equal(a, c)
                torch.testing.assert_close(a, b, **hop)


def _seq_trains_on_the_card(dev, mode, mk):
    """One adam step of a SeqClassifier ``mk`` on [2, 1] (x sp 2) on the
    card and on the CPU: the card's runs through the attention kernels of
    its mode, and its loss and parameters match the CPU's to
    chip_smoke.py's reference tolerances for the seq paths (loss rtol
    1e-4, parameters atol 4e-3)."""
    from geomx_tpu_torch import HiPSTopology, ops
    from geomx_tpu_torch.models import SeqClassifier
    from geomx_tpu_torch.optim import adam
    from geomx_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    L = mk["max_len"]
    rng = np.random.RandomState(0)
    tok = rng.randint(4, mk["vocab"], (2, 1, 4, L))
    pos = np.broadcast_to(np.arange(L), tok.shape)
    x = torch.as_tensor(np.stack([tok, pos], -1).astype(np.int32))
    y = torch.as_tensor(rng.randint(0, mk["num_classes"], (2, 1, 4)))
    runs = {}
    for device in (dev, torch.device("cpu")):
        t = Trainer(SeqClassifier(sp_mode=mode, **mk),
                    HiPSTopology(2, 1, sp_degree=1 if mode is None else 2),
                    adam(1e-3), device=device,
                    single_device_model=SeqClassifier(**mk))
        st = t.init_state(seed=0)
        ops.reset_launch_counts()
        st, m = t.train_step(st, x.to(device), y.to(device))
        runs[device.type] = (float(m["loss"]),
                             {k: p.cpu() for k, p in st.params.items()})
        if device.type == "cuda":
            attn = ("fused_block",) if mode == "ring" else (
                "flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv")
            assert all(ops.launch_counts()[n] > 0 for n in attn)
    (loss, params), (ref_loss, ref_params) = runs["cuda"], runs["cpu"]
    assert math.isfinite(loss)
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    assert params.keys() == ref_params.keys()
    for name, p in params.items():
        torch.testing.assert_close(p, ref_params[name], rtol=0, atol=4e-3,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "ring", "ulysses"])
def test_seq_classifier_head_dim_256_trains_on_the_card(dev, mode):
    """Head dim 256 (dim 512, 2 heads, 1 layer, L = 64), which the kernels
    run on the wide route: the twin of the head-dim-24 test below."""
    _seq_trains_on_the_card(dev, mode, dict(
        vocab=64, max_len=64, dim=512, num_heads=2, num_layers=1,
        num_classes=4))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "ring", "ulysses"])
def test_seq_classifier_head_dim_24_trains_on_the_card(dev, mode):
    """Head dim 24 (dim 96, 4 heads, 2 layers, L = 64), which the kernels
    run zero-padded to 32 (see _seq_trains_on_the_card)."""
    _seq_trains_on_the_card(dev, mode, dict(
        vocab=64, max_len=64, dim=96, num_heads=4, num_layers=2,
        num_classes=4))


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


# ---- the data plane on the card: the prefetch stream handoff, the
# device-cached gather and the scanned epoch (bit for bit)

def _images(n=256, hw=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("augment", [False, True])
def test_prefetch_handoff_gives_the_synchronous_batches(dev, augment):
    """The producer thread's copies on the side stream reach the
    consumer's stream before it reads them: the prefetched batches equal
    the synchronous ones, while the consumer keeps the card busy."""
    from geomx_tpu_torch import HiPSTopology
    from geomx_tpu_torch.data import GeoDataLoader

    x, y = _images()
    loader = GeoDataLoader(x, y, HiPSTopology(2, 4), 8, augment=augment,
                           device=dev)
    sync = [(a.clone(), b.clone()) for a, b in loader.epoch(0, prefetch=0)]
    busy = torch.randn(2048, 2048, device=dev)
    got = []
    for xb, yb in loader.epoch(0, prefetch=2):
        busy = busy @ busy / 2048          # work queued ahead of the read
        got.append(((xb.int() + 1).cpu(), yb.cpu()))
    assert len(got) == len(sync) == loader.steps_per_epoch
    for (gx, gy), (sx, sy) in zip(got, sync):
        assert torch.equal(gx, sx.int().cpu() + 1)
        assert torch.equal(gy, sy.cpu())


@pytest.mark.cuda
def test_device_cached_gather_equals_host_batches(dev):
    from geomx_tpu_torch import HiPSTopology
    from geomx_tpu_torch.data import GeoDataLoader

    x, y = _images()
    cached = GeoDataLoader(x, y, HiPSTopology(2, 4), 8, device=dev,
                           device_cache=True)
    host = GeoDataLoader(x, y, HiPSTopology(2, 4), 8, device="cpu")
    for epoch in range(2):
        pairs = list(zip(cached.epoch(epoch), host.host_batches(epoch)))
        assert len(pairs) == cached.steps_per_epoch
        for (xb, yb), (hx, hy) in pairs:
            assert xb.device.type == "cuda"
            assert torch.equal(xb.cpu(), torch.from_numpy(hx))
            assert torch.equal(yb.cpu(), torch.from_numpy(
                hy.astype(np.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("augment", [False, True])
def test_scanned_epoch_equals_the_per_step_loop(dev, augment):
    import dataclasses

    from geomx_tpu_torch import GeoConfig, HiPSTopology
    from geomx_tpu_torch.optim import adam
    from geomx_tpu_torch.train import Trainer

    torch.backends.cudnn.deterministic = True
    try:
        x, y = _images(hw=16)
        states = []
        for scan in (True, False):
            t = Trainer(get_model("cnn"), HiPSTopology(2, 4), adam(0.01),
                        config=GeoConfig(num_parties=2, workers_per_party=4,
                                         compression="bsc,0.01"),
                        device=dev)
            st = t.init_state(seed=0, sample_input=x[:2])
            loader = t.make_loader(x, y, 8, augment=augment,
                                   device_cache=True)
            st, recs = t.fit(st, loader, epochs=2, log_every=1,
                             log_fn=lambda s: None, scan_epochs=scan)
            states.append(st)
            assert st.step == 2 * loader.steps_per_epoch
        a, b = (dataclasses.asdict(s) for s in states)
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k
        for k in a["opt_state"]["mu"]:
            assert torch.equal(a["opt_state"]["mu"][k],
                               b["opt_state"]["mu"][k]), k
    finally:
        torch.backends.cudnn.deterministic = False
    with pytest.raises(ValueError, match="device_cache"):
        t.fit(st, t.make_loader(x, y, 8), scan_epochs=True)


# ---- the serving gateway's captured graphs ----------------------------------

def _seq_gateway(dev, L=256, max_batch=4):
    from geomx_tpu_torch.models import SeqClassifier
    from geomx_tpu_torch.serve.gateway import InferenceGateway, flatten_params
    from geomx_tpu_torch.serve.replica import ServingReplica
    model = SeqClassifier(max_len=L)
    model.reset_parameters(torch.Generator().manual_seed(0))
    named, treedef = flatten_params(model)
    rep = ServingReplica("v1")
    for i, (k, v) in enumerate(named.items()):
        rep.install_base(k, v, order=i)
    gw = InferenceGateway(rep, treedef=treedef, model=model,
                          max_batch=max_batch, warmup_shapes=[(L,)],
                          warmup=True, device=dev)
    gw.warmup()
    return gw, rep, named


@pytest.mark.cuda
def test_gateway_graph_replay_bit_equal_eager_with_kernel_10(dev):
    """Every bucket's captured graph replays the eager forward's bits,
    and holds the no-lse flash forward once a layer."""
    from geomx_tpu_torch import ops
    gw, rep, _ = _seq_gateway(dev)
    assert gw.graph_captures == gw.jit_cache_size() == len(gw.buckets)
    xs = np.random.default_rng(0).integers(0, 256, (4, 256)).astype(
        np.float32)
    for b in gw.buckets:
        fn = gw._forward_fn(b, (256,))
        assert fn.kernel_nodes["flash_attention_fwd_nolse"] == 2
        got = fn(rep.params(), xs[:b]).result().copy()
        want = gw.eager_forward(rep.params(), xs[:b])
        assert got.tobytes() == want.tobytes(), b
    before = ops.variant_launch_counts()["flash_attention_fwd_nolse"]
    fn(rep.params(), xs).result()
    # a replay runs no Python: the wrapper's counter does not move, the
    # graph's launch count does
    assert ops.variant_launch_counts()["flash_attention_fwd_nolse"] == before
    assert gw.graph_launches()["flash_attention_fwd_nolse"] == \
        2 * sum(f.replays for f in gw._jit_cache.values())
    assert gw.graph_captures == len(gw.buckets)


@pytest.mark.cuda
def test_gateway_output_and_weights_across_back_to_back_replays(dev):
    """Batch t's output survives batch t+1's replay of the same graph,
    and a new weight set queued between them reaches t+1 only."""
    gw, rep, named = _seq_gateway(dev)
    xs = np.random.default_rng(1).integers(0, 256, (8, 256)).astype(
        np.float32)
    w0 = rep.params()
    k = next(n for n in named if "head" in n and "kernel" in n)
    idx = np.arange(0, 640, 7, dtype=np.int64)
    assert rep.apply_delta(k, 1, np.full(idx.size, 0.5, np.float32), idx)
    w1 = rep.params()
    fn = gw._forward_fn(4, (256,))
    t0 = fn(w0, xs[:4])
    t1 = fn(w1, xs[4:])
    out0, out1 = t0.result().copy(), t1.result().copy()
    assert out0.tobytes() == gw.eager_forward(w0, xs[:4]).tobytes()
    assert out1.tobytes() == gw.eager_forward(w1, xs[4:]).tobytes()
    assert not np.array_equal(gw.eager_forward(w0, xs[4:]), out1)
