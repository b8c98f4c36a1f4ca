"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (the kernels
have no CPU mode; the CPU tests cover the plain versions against the JAX
package).  This file imports neither JAX nor the JAX package, so it runs
on a GPU host without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance everywhere: none (bit for bit).  The scatter-add folds each
party's run of pairs in order, so it is bit-equal at any party count.
"""

import numpy as np
import pytest
import torch

from geomx_tpu_torch.compression import BiSparseCompressor
from geomx_tpu_torch.compression.bucketing import GradientBucketer
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.ops import bsc, bucket
from geomx_tpu_torch.parallel.collectives import all_gather_dc


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


@pytest.mark.cuda
def test_trainer_step_launches_every_kernel(dev):
    from geomx_tpu_torch import GeoConfig, HiPSTopology, ops
    from geomx_tpu_torch.models import ResNet
    from geomx_tpu_torch.optim import sgd
    from geomx_tpu_torch.train import Trainer

    t = Trainer(ResNet((1, 1, 1), (8, 16, 32)), HiPSTopology(2, 4),
                sgd(0.1, momentum=0.9),
                config=GeoConfig(num_parties=2, workers_per_party=4,
                                 compression="bsc,0.01"), device=dev)
    st = t.init_state(seed=0)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randint(0, 256, (2, 4, 8, 16, 16, 3))
                        .astype(np.uint8), device=dev)
    y = torch.as_tensor(rng.randint(0, 10, (2, 4, 8)), device=dev)
    ops.reset_launch_counts()
    st, m = t.train_step(st, x, y)
    assert torch.isfinite(m["loss"])
    assert all(c == 1 for c in ops.launch_counts().values()), \
        ops.launch_counts()
