"""Bucketed flat-gradient communication (port of
geomx_tpu/compression/bucketing.py).

``GradientBucketer`` lays the gradient tree out in a few contiguous fp32
buckets with a static layout (leaf -> (bucket, offset, size)), and
``BucketedCompressor`` runs the wrapped compressor once per bucket
instead of once per leaf.  The layout is the JAX package's exactly:
leaves in flax's sorted-key order, each in flax's element layout (HWIO
conv kernels, ``[in, out]`` dense kernels), greedy packing up to the
bucket capacity, tails padded to a multiple of 128 — so a bucket index
names the same coordinate in both packages and BSC wire pairs match.

The copies run through ``ops.bucket`` (one CUDA kernel launch a
direction on the card).  ``GEOMX_BUCKET_BYTES`` sets the capacity
(default 4 MiB of fp32); ``GEOMX_BUCKET_BYTES=0`` restores the per-leaf
path.

The ZeRO shard view (``init_shard_state``, ``allreduce_shards``,
``shard_wire_bytes``) runs the inner compressor on each replica's
``1/W`` slice of every bucket; ``ZeroPlan.bind_compressor``
(``train/zero.py``) re-aligns ``pad_to`` so the buckets split into W
shards and clears the cached layouts.
"""

from __future__ import annotations

import math
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from geomx_tpu_torch.compression.base import REPLICA_DIMS, Compressor
from geomx_tpu_torch.ops import bucket as bucket_ops
from geomx_tpu_torch.tree import leaf_names

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024

_LANE_PAD = 128  # the JAX package's lane pad: layouts must agree


class GradientBucketer:
    """Static flat layout of a leaf sequence into contiguous fp32 buckets.

    ``leaves`` are tensors (or anything with ``shape`` and ``dtype``)
    whose first ``batch_dims`` dims are replica axes; the layout is
    computed from the remaining per-replica shape.  Packing is greedy in
    leaf order; a leaf larger than the capacity gets a bucket of its
    own; leaves are never split.
    """

    def __init__(self, leaves: Sequence[Any],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 pad_to: int = _LANE_PAD, batch_dims: int = 0):
        if bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
        self.batch_dims = int(batch_dims)
        self.pad_to = max(1, int(pad_to))
        self.capacity = max(self.pad_to, int(bucket_bytes) // 4)
        self.leaf_shapes = [tuple(leaf.shape[self.batch_dims:])
                            for leaf in leaves]
        self.leaf_dtypes = [leaf.dtype for leaf in leaves]
        self.leaf_sizes = [math.prod(s) for s in self.leaf_shapes]

        # leaf -> (bucket, offset); bucket -> true fill
        self.assignments: List[Tuple[int, int]] = []
        fills: List[int] = []
        for size in self.leaf_sizes:
            if fills and fills[-1] > 0 and fills[-1] + size > self.capacity:
                fills.append(0)
            if not fills:
                fills.append(0)
            self.assignments.append((len(fills) - 1, fills[-1]))
            fills[-1] += size
        self.bucket_fill = fills if self.leaf_sizes else []
        self.bucket_sizes = [-(-f // self.pad_to) * self.pad_to
                             for f in self.bucket_fill]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    def layout(self) -> tuple:
        """leaf -> (bucket, offset, size) triples."""
        return tuple((b, off, size) for (b, off), size in
                     zip(self.assignments, self.leaf_sizes))

    def flatten(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Leaves ``[*B, *shape_i]`` -> fp32 buckets ``[*B, N_b]``
        (zero-padded tails).  A non-fp32 leaf is cast first, outside the
        kernel."""
        flat = [leaf.to(torch.float32) for leaf in leaves]
        with record_function("bucket/flatten"):
            return bucket_ops.flatten(flat, self.layout(), self.bucket_sizes,
                                      self.batch_dims)

    def unflatten(self, buckets: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
        """Buckets -> leaves with their original shapes and dtypes."""
        with record_function("bucket/unflatten"):
            flat = bucket_ops.unflatten(buckets, self.layout(),
                                        self.batch_dims)
        batch = tuple(buckets[0].shape[:self.batch_dims]) if buckets else ()
        return [f.reshape(batch + shape).to(dtype)
                for f, shape, dtype in zip(flat, self.leaf_shapes,
                                           self.leaf_dtypes)]


def _bucket_leaf(n: int) -> torch.Tensor:
    """A shape-only ``[1, 1, n]`` fp32 stand-in for one bucket."""
    return torch.empty((1, 1, int(n)), dtype=torch.float32, device="meta")


def _resolve_bucket_bytes(bucket_bytes: Optional[int]) -> int:
    if bucket_bytes is not None:
        return int(bucket_bytes)
    raw = os.environ.get("GEOMX_BUCKET_BYTES")
    if raw:
        return int(float(raw))
    return DEFAULT_BUCKET_BYTES


class BucketedCompressor(Compressor):
    """Run ``inner`` once per fused bucket instead of once per leaf.

    State is a list of per-bucket inner states on the flat bucket layout
    (each with the ``[P, W]`` replica axes); ``name`` mirrors the inner
    compressor's.
    """

    fuses_tree = True

    def __init__(self, inner: Compressor,
                 bucket_bytes: Optional[int] = None,
                 pad_to: int = _LANE_PAD):
        self.inner = inner
        self.name = inner.name
        self.bucket_bytes = _resolve_bucket_bytes(bucket_bytes)
        if self.bucket_bytes <= 0:
            raise ValueError("BucketedCompressor needs bucket_bytes > 0; "
                             "use the bare inner compressor to disable "
                             "bucketing")
        self.pad_to = pad_to
        self._bucketers: dict = {}

    def _bucketer(self, leaves: Sequence[torch.Tensor]) -> GradientBucketer:
        key = tuple((tuple(leaf.shape[REPLICA_DIMS:]), leaf.dtype)
                    for leaf in leaves)
        bk = self._bucketers.get(key)
        if bk is None:
            bk = GradientBucketer(leaves, self.bucket_bytes, self.pad_to,
                                  batch_dims=REPLICA_DIMS)
            self._bucketers[key] = bk
        return bk

    def init_state(self, grads: dict) -> list:
        leaves = [grads[k] for k in leaf_names(grads)]
        bk = self._bucketer(leaves)
        lead = tuple(leaves[0].shape[:REPLICA_DIMS])
        return [self.inner.init_leaf_state(
            torch.empty(lead + (n,), dtype=torch.float32,
                        device=leaves[0].device))
            for n in bk.bucket_sizes]

    def allreduce_buckets(self, buckets: Sequence[torch.Tensor], state: list,
                          axis_name: str, axis_size: int,
                          bk: GradientBucketer):
        """One compressed collective per flat bucket."""
        if len(state) != bk.num_buckets:
            raise ValueError(
                f"bucketed state has {len(state)} buckets but the gradient "
                f"layout needs {bk.num_buckets} — state was initialized "
                "from a different tree")
        out_buckets, new_states = [], []
        for i, (b, s) in enumerate(zip(buckets, state)):
            # a profiler span per bucket, as the JAX package's trace spans
            with record_function(f"{axis_name}_allreduce/bucket{i}"):
                ob, ns = self.inner.allreduce_leaf(b, s, axis_name,
                                                   axis_size)
            out_buckets.append(ob)
            new_states.append(ns)
        return out_buckets, new_states

    def allreduce(self, grads: dict, state: list, axis_name: str,
                  axis_size: int):
        names = leaf_names(grads)
        if not names:
            return grads, state
        leaves = [grads[k] for k in names]
        bk = self._bucketer(leaves)
        out_buckets, new_states = self.allreduce_buckets(
            bk.flatten(leaves), state, axis_name, axis_size, bk)
        return dict(zip(names, bk.unflatten(out_buckets))), new_states

    def zero_bucketer(self, leaves: Sequence[torch.Tensor]
                      ) -> GradientBucketer:
        """The bucket layout of ``leaves`` (the same cache as the
        all-reduce's), exposed so the fused optimizer apply
        (``train/step.py``) and the ZeRO path (``train/zero.py``) flatten
        params and grads onto the coordinates the dc tier uses."""
        return self._bucketer(leaves)

    # -- the ZeRO shard view (train/zero.py) ---------------------------------
    def init_shard_state(self, grads: dict, num_shards: int) -> list:
        """Per-bucket inner state sized for one contiguous ``1/W`` bucket
        shard, ``[P, W, n / W]`` (the ZeRO form of :meth:`init_state`):
        error-feedback residuals live shard-local, so their memory drops
        by ``W`` as the optimizer's does.  Needs ``pad_to`` a multiple of
        ``num_shards`` times the lane width (``ZeroPlan.bind_compressor``
        sets it)."""
        leaves = [grads[k] for k in leaf_names(grads)]
        bk = self._bucketer(leaves)
        for n in bk.bucket_sizes:
            if n % num_shards:
                raise ValueError(
                    f"bucket of {n} elements does not split into "
                    f"{num_shards} equal shards — the ZeRO path needs "
                    "pad_to to be a multiple of num_shards*lane "
                    "(ZeroPlan.bind_compressor sets this before the "
                    "first trace)")
        lead = tuple(leaves[0].shape[:REPLICA_DIMS])
        return [self.inner.init_leaf_state(
            torch.empty(lead + (n // num_shards,), dtype=torch.float32,
                        device=leaves[0].device))
            for n in bk.bucket_sizes]

    def allreduce_shards(self, shards: Sequence[torch.Tensor], state: list,
                         axis_name: str, axis_size: int,
                         bk: GradientBucketer):
        """One compressed collective per ``1/W`` bucket shard (the ZeRO
        dc tier): each replica compresses and sends only its shard, so
        the per-link payload drops by ``W``."""
        if len(state) != bk.num_buckets:
            raise ValueError(
                f"sharded state has {len(state)} buckets but the layout "
                f"needs {bk.num_buckets} — state was initialized from a "
                "different tree (init_shard_state and allreduce_shards "
                "must see the same pytree structure)")
        out_shards, new_states = [], []
        for i, (b, s) in enumerate(zip(shards, state)):
            with record_function(f"{axis_name}_allreduce/bucket{i}_shard"):
                ob, ns = self.inner.allreduce_leaf(b, s, axis_name,
                                                   axis_size)
            out_shards.append(ob)
            new_states.append(ns)
        return out_shards, new_states

    def shard_wire_bytes(self, grads: dict, num_shards: int) -> int:
        """A replica's dc-tier wire bytes on the ZeRO path: the inner
        compressor's payload for each ``1/W`` bucket shard."""
        names = leaf_names(grads)
        if not names:
            return 0
        bk = self._bucketer([grads[k] for k in names])
        return sum(self.inner.wire_bytes_leaf(_bucket_leaf(n // num_shards))
                   for n in bk.bucket_sizes)

    def wire_bytes(self, grads: dict) -> int:
        """The inner compressor's bytes summed over the bucket sizes of
        ``grads`` (``[P, W]``-replicated leaves)."""
        names = leaf_names(grads)
        if not names:
            return 0
        bk = self._bucketer([grads[k] for k in names])
        return sum(self.inner.wire_bytes_leaf(_bucket_leaf(n))
                   for n in bk.bucket_sizes)

    def wire_bytes_leaf(self, leaf: torch.Tensor) -> int:
        bk = self._bucketer([leaf])
        return self.inner.wire_bytes_leaf(_bucket_leaf(bk.bucket_sizes[0]))

    def allreduce_leaf(self, g: torch.Tensor, state: Any, axis_name: str,
                       axis_size: int):
        bk = self._bucketer([g])
        out, new_state = self.inner.allreduce_leaf(bk.flatten([g])[0], state,
                                                   axis_name, axis_size)
        return bk.unflatten([out])[0], new_state


def maybe_bucketed(comp: Compressor,
                   bucket_bytes: Optional[int] = None) -> Compressor:
    """The dc-tier default: wrap ``comp`` in a BucketedCompressor unless
    bucketing is off (``bucket_bytes=0`` / ``GEOMX_BUCKET_BYTES=0``) or
    ``comp`` already fuses the tree."""
    resolved = _resolve_bucket_bytes(bucket_bytes)
    if resolved <= 0 or getattr(comp, "fuses_tree", False):
        return comp
    return BucketedCompressor(comp, resolved)
