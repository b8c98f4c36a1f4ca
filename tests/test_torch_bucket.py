"""Port parity: bucket layout and flatten/unflatten (geomx_tpu_torch vs
geomx_tpu).

The layout (leaf -> bucket, offset; padded bucket sizes) must equal the
JAX ``GradientBucketer``'s on a converted ResNet tree, or a bucket
index names a different coordinate in each package.  Flatten and
unflatten are pure copies: bit-for-bit equal to both the jnp path and
the Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomx_tpu.compression.bucketing import GradientBucketer as JaxBucketer
from geomx_tpu.models.resnet import ResNet as FlaxResNet
from geomx_tpu.ops.bucket_pallas import fused_flatten, fused_unflatten
from geomx_tpu_torch.compression.bucketing import GradientBucketer
from geomx_tpu_torch.models import get_model
from geomx_tpu_torch.models.convert import from_flax
from geomx_tpu_torch.ops import bucket as bucket_ops
from geomx_tpu_torch.tree import leaf_names

torch.set_num_threads(2)


def flax_resnet20_params(seed=0):
    """Flax ResNet-20 params (fp32 compute, random init) as a numpy tree."""
    model = FlaxResNet(stage_sizes=(3, 3, 3), stage_filters=(16, 32, 64),
                       dtype=jnp.float32)
    variables = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def trees():
    """(jax leaves in tree order, port leaves in leaf_names order)."""
    params = flax_resnet20_params()
    jleaves = jax.tree.leaves(params)
    port, _ = from_flax(params)
    return jleaves, [port[k] for k in leaf_names(port)]


def test_port_leaf_order_matches_flax_tree_order(trees):
    jleaves, pleaves = trees
    assert len(jleaves) == len(pleaves) == 65
    for a, b in zip(jleaves, pleaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())
    # the port's own model names its parameters in the same order and
    # flax layouts (HWIO conv kernels, [in, out] dense kernels)
    model = get_model("resnet20")
    shapes = [tuple(model.get_parameter(k).shape)
              for k in model.param_names()]
    assert shapes == [tuple(a.shape) for a in jleaves]


@pytest.mark.parametrize("bucket_bytes,pad_to", [
    (4 * 1024 * 1024, 128),   # the default: one ResNet-20 bucket
    (64 * 1024, 128),         # several buckets, one oversized leaf
    (16 * 1024, 512),         # wide pad
])
def test_layout_matches_jax_bucketer(trees, bucket_bytes, pad_to):
    jleaves, pleaves = trees
    jb = JaxBucketer(jleaves, bucket_bytes=bucket_bytes, pad_to=pad_to,
                     fused=False)
    pb = GradientBucketer(pleaves, bucket_bytes=bucket_bytes, pad_to=pad_to)
    assert pb.assignments == jb.assignments
    assert pb.bucket_fill == jb.bucket_fill
    assert pb.bucket_sizes == jb.bucket_sizes
    assert list(pb.leaf_sizes) == list(jb.leaf_sizes)


@pytest.mark.parametrize("bucket_bytes", [4 * 1024 * 1024, 64 * 1024])
def test_flatten_unflatten_bit_equal_to_jnp_and_pallas(trees, bucket_bytes):
    """Tolerance: none (bit for bit) — the copies are a permutation."""
    jleaves, pleaves = trees
    jb = JaxBucketer(jleaves, bucket_bytes=bucket_bytes, fused=False)
    layout = tuple((b, off, size) for (b, off), size in
                   zip(jb.assignments, jb.leaf_sizes))
    jnp_buckets = jb.flatten([jnp.asarray(x) for x in jleaves])
    pallas_buckets = fused_flatten(
        [jnp.asarray(x).reshape(-1) for x in jleaves], layout,
        tuple(jb.bucket_sizes), interpret=True)
    pb = GradientBucketer(pleaves, bucket_bytes=bucket_bytes)
    port_buckets = pb.flatten(pleaves)
    assert len(port_buckets) == len(jnp_buckets) == len(pallas_buckets)
    for p, j, f in zip(port_buckets, jnp_buckets, pallas_buckets):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        np.testing.assert_array_equal(p.numpy(), np.asarray(f))

    port_leaves = pb.unflatten(port_buckets)
    pallas_leaves = fused_unflatten(pallas_buckets, layout,
                                    tuple(jb.leaf_sizes), interpret=True)
    for p, f, src in zip(port_leaves, pallas_leaves, pleaves):
        assert p.shape == src.shape and p.dtype == src.dtype
        np.testing.assert_array_equal(p.numpy().reshape(-1), np.asarray(f))
        np.testing.assert_array_equal(p.numpy(), src.numpy())


def test_flatten_rows_follow_replica_axes(rng):
    """With [P, W] batch dims (and a stride-0 worker axis, as a worker
    sum arrives), row (p, w) of every bucket is the flatten of replica
    (p, w)'s leaves.  Tolerance: none."""
    shapes = [(3, 3, 2, 4), (5,), (300,), (7, 3), (1,)]
    per_party = [[torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
                  for s in shapes] for _ in range(2)]
    leaves = [torch.stack([per_party[p][i] for p in range(2)])
              .unsqueeze(1).expand((2, 4) + s)
              for i, s in enumerate(shapes)]
    bk = GradientBucketer(leaves, bucket_bytes=1024, batch_dims=2)
    buckets = bk.flatten(leaves)
    for p in range(2):
        single = GradientBucketer(per_party[p], bucket_bytes=1024)
        for b, ref in zip(buckets, single.flatten(per_party[p])):
            for w in range(4):
                np.testing.assert_array_equal(b[p, w].numpy(), ref.numpy())
    back = bk.unflatten(buckets)
    for leaf, out in zip(leaves, back):
        np.testing.assert_array_equal(out.numpy(), leaf.numpy())


def test_flatten_wide_pad_and_bf16_leaf_cast(rng):
    """Non-fp32 leaves cast outside the kernel and come back in their
    dtype; tails wider than 128 zero-fill.  Tolerance: none."""
    leaves = [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for s in (700, 3, 129)]
    leaves[1] = leaves[1].to(torch.bfloat16)
    bk = GradientBucketer(leaves, bucket_bytes=1 << 20, pad_to=512)
    jl = [jnp.asarray(x.float().numpy()) for x in leaves]
    jl[1] = jl[1].astype(jnp.bfloat16)
    jb = JaxBucketer(jl, bucket_bytes=1 << 20, pad_to=512, fused=False)
    for a, b in zip(bk.flatten(leaves), jb.flatten(jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = bk.unflatten(bk.flatten(leaves))
    assert back[1].dtype == torch.bfloat16
    for a, b in zip(back, leaves):
        assert torch.equal(a, b)


def test_flatten_rejects_non_fp32_and_mixed_devices():
    with pytest.raises(TypeError):
        bucket_ops.flatten([torch.zeros(4, dtype=torch.float16)],
                           ((0, 0, 4),), (128,))
    with pytest.raises(ValueError):
        bucket_ops.flatten([torch.zeros(5)], ((0, 0, 4),), (128,))

