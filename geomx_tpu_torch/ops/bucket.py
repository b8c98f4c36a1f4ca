"""Bucket flatten / unflatten (port of geomx_tpu/ops/bucket_pallas.py).

``flatten`` gathers every 1-D fp32 leaf into its static ``(bucket,
offset)`` slot of a few flat fp32 buckets and zero-fills each bucket's
tail pad; ``unflatten`` is the inverse copy.  Both are pure data
movement, so the results are bit-identical to the concatenate/slice
path.  Dtype casts stay outside, as in the JAX package.

Every leaf may carry leading batch dims (the port's ``[P, W]`` replica
axes); row ``r`` of every leaf goes to row ``r`` of every bucket.  The
batch dims may be strided (a worker-axis sum arrives as a stride-0
expanded view); each leaf's own elements must be contiguous.

On CUDA tensors the wrappers launch the hand-written multi-tensor copy
kernel (``csrc/bucket.cu``) and raise if it fails; on CPU tensors they
run the plain PyTorch version beside them.  ``flatten.launches`` and
``unflatten.launches`` count kernel launches.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

Layout = Sequence[Tuple[int, int, int]]  # leaf -> (bucket, offset, size)


def on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    on any other device (there is no silent fallback)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on devices {sorted(kinds)}: expected all on "
                     "the CPU or all on CUDA")


def _rows(leaves: Sequence[torch.Tensor], layout: Layout,
          batch_dims: int) -> List[torch.Tensor]:
    """Each leaf as a ``[*B, n_i]`` view (no copy)."""
    if len(leaves) != len(layout):
        raise ValueError(f"{len(leaves)} leaves for a layout of "
                         f"{len(layout)}")
    out = []
    batch = None
    for i, (leaf, (_, _, size)) in enumerate(zip(leaves, layout)):
        if leaf.dtype != torch.float32:
            raise TypeError(f"leaf {i} is {leaf.dtype}; cast to float32 "
                            "before flattening")
        flat = leaf.flatten(batch_dims) if leaf.dim() > batch_dims \
            else leaf.unsqueeze(-1)
        if flat.shape[-1] != size:
            raise ValueError(f"leaf {i} has {flat.shape[-1]} elements, the "
                             f"layout says {size}")
        if batch is None:
            batch = flat.shape[:-1]
        elif flat.shape[:-1] != batch:
            raise ValueError(f"leaf {i} batch dims {tuple(flat.shape[:-1])} "
                             f"differ from {tuple(batch)}")
        if size > 1 and flat.stride(-1) != 1:
            raise ValueError(f"leaf {i} is not contiguous")
        out.append(flat)
    return out


def flatten_plain(rows: Sequence[torch.Tensor], layout: Layout,
                  bucket_sizes: Sequence[int]) -> List[torch.Tensor]:
    """The concatenate path (``GradientBucketer.flatten``'s jnp twin)."""
    batch = rows[0].shape[:-1]
    pieces: List[List[torch.Tensor]] = [[] for _ in bucket_sizes]
    fill = [0] * len(bucket_sizes)
    for r, (b, off, size) in zip(rows, layout):
        pieces[b].append(r)
        fill[b] = max(fill[b], off + size)
    out = []
    for b, total in enumerate(bucket_sizes):
        ps = list(pieces[b])
        if total > fill[b]:
            ps.append(torch.zeros(batch + (total - fill[b],),
                                  dtype=torch.float32, device=rows[0].device))
        out.append(torch.cat(ps, dim=-1))
    return out


def flatten(leaves: Sequence[torch.Tensor], layout: Layout,
            bucket_sizes: Sequence[int],
            batch_dims: int = 0) -> List[torch.Tensor]:
    """fp32 leaves ``[*B, *shape_i]`` -> buckets ``[*B, N_b]``."""
    rows = _rows(leaves, layout, batch_dims)
    if not on_cuda(rows):
        return flatten_plain(rows, layout, bucket_sizes)
    from geomx_tpu_torch.ops._build import kernels
    batch = tuple(rows[0].shape[:-1])
    out = [torch.empty(batch + (int(n),), dtype=torch.float32,
                       device=rows[0].device) for n in bucket_sizes]
    flatten.launches += kernels().bucket_flatten(
        rows, out, [b for b, _, _ in layout], [off for _, off, _ in layout])
    return out


flatten.launches = 0


def unflatten_plain(buckets: Sequence[torch.Tensor],
                    layout: Layout) -> List[torch.Tensor]:
    """The slice path (``GradientBucketer.unflatten``'s jnp twin)."""
    return [buckets[b][..., off:off + size].clone()
            for b, off, size in layout]


def unflatten(buckets: Sequence[torch.Tensor], layout: Layout,
              batch_dims: int = 0) -> List[torch.Tensor]:
    """Buckets ``[*B, N_b]`` -> new contiguous leaves ``[*B, n_i]``
    (the caller reshapes and casts)."""
    for b in buckets:
        if b.dtype != torch.float32 or b.dim() != batch_dims + 1:
            raise ValueError("buckets must be float32 [*B, N]")
    if not on_cuda(buckets):
        return unflatten_plain(buckets, layout)
    from geomx_tpu_torch.ops._build import kernels
    batch = tuple(buckets[0].shape[:-1])
    out = [torch.empty(batch + (int(size),), dtype=torch.float32,
                       device=buckets[0].device) for _, _, size in layout]
    # an uncompressed all-reduce hands back broadcast views (stride 0 over
    # the reduced replica dim): the kernel reads contiguous buckets
    unflatten.launches += kernels().bucket_unflatten(
        [b.contiguous() for b in buckets], out, [b for b, _, _ in layout],
        [off for _, off, _ in layout])
    return out


unflatten.launches = 0
