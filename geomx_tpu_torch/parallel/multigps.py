"""MultiGPS: multiple global parameter servers, as a sharded update of
the big leaves (port of geomx_tpu/parallel/multigps.py).

Reference semantics: tensors with at least ``MXNET_KVSTORE_BIGARRAY_BOUND``
elements (default 1e6) are split contiguously across all global
servers' key ranges; smaller tensors are hashed whole to one server by
``(key * 9973) % num_servers`` (src/kvstore/kvstore_dist.h:792-833).
``partition`` reproduces that placement exactly.

The JAX package re-expresses it as a ZeRO-1 update of the big leaves
over the worker axis, and so does the port: a big leaf's gradient is
mean-reduce-scattered over the workers (each slot keeps one contiguous
shard of ``ceil(n / W)`` elements, the last zero-padded), the optimizer
updates that shard (its state allocated shard-shaped), and the shards
are all-gathered back.  Small leaves stay replicated.  The dc tier moves
the shards of the big leaves, so its volume drops by W for them.

Every tensor carries the leading ``[P, W]`` replica axes; slot ``(p,
w)`` of a shard tensor holds worker ``w``'s shard, so the ops take no
worker index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from geomx_tpu_torch.parallel.collectives import all_gather, psum_scatter
from geomx_tpu_torch.train.zero import slice_worker_shards

HASH_PRIME = 9973  # reference kvstore_dist.h:830


@dataclasses.dataclass(frozen=True)
class Placement:
    key: int
    server: int          # owning server for whole tensors; -1 if split
    split: bool          # True -> sharded across all servers
    shard_bounds: Tuple[int, ...]  # len num_servers+1 cumulative bounds


def partition(sizes: Sequence[int], num_servers: int,
              bigarray_bound: int = 1_000_000) -> List[Placement]:
    """Reference-compatible placement of tensor keys onto global servers."""
    out = []
    for key, size in enumerate(sizes):
        if num_servers > 1 and size >= bigarray_bound:
            # contiguous equal split, the remainder to the last server
            per = size // num_servers
            bounds = [i * per for i in range(num_servers)] + [size]
            out.append(Placement(key=key, server=-1, split=True,
                                 shard_bounds=tuple(bounds)))
        else:
            out.append(Placement(key=key,
                                 server=(key * HASH_PRIME) % num_servers,
                                 split=False, shard_bounds=(0, size)))
    return out


def _numel(leaf) -> int:
    """Elements a replica of a ``[P, W, *shape]`` leaf."""
    return math.prod(leaf.shape[2:])


class MultiGPSPlan:
    """The sharded update of the big leaves over the worker axis.

    Used by ``train.step.build_train_step`` and ``Trainer`` when
    ``config.multi_gps`` is set: leaves with at least ``bigarray_bound``
    elements are updated shard-wise, smaller ones replicated.
    Leaf-wise optimizers give the unsharded update's values; one that
    couples a whole tensor would see per-shard statistics, as the
    reference's per-server optimizer does.
    """

    def __init__(self, bigarray_bound: int, workers_per_party: int):
        self.bound = int(bigarray_bound)
        self.W = int(workers_per_party)

    def is_big(self, n: int) -> bool:
        return self.W > 1 and n >= self.bound

    def shard_len(self, n: int) -> int:
        return -(-n // self.W)

    def mixed_example(self, tree: dict) -> dict:
        """The mixed view for state inits: each big ``[P, W, *shape]``
        leaf becomes a zero fp32 ``[P, W, shard_len]`` leaf (the sharded
        update runs an fp32 master copy whatever the param dtype), small
        leaves stay as they are."""
        out = {}
        for k, leaf in tree.items():
            n = _numel(leaf)
            out[k] = torch.zeros(tuple(leaf.shape[:2]) + (self.shard_len(n),),
                                 dtype=torch.float32, device=leaf.device) \
                if self.is_big(n) else leaf
        return out

    # ---- composition with tree-fusing dc compressors -----------------------

    def split_mixed(self, orig_sizes: Sequence[int], mixed_leaves):
        """Partition mixed-tree leaves into (sharded, replicated) groups
        by the original leaf sizes: a tree-fusing dc compressor (DGT)
        then runs one schedule a group, so the replicated group's
        decisions depend on replicated content only and stay equal
        across a party's workers."""
        big, small = [], []
        for n0, leaf in zip(orig_sizes, mixed_leaves):
            (big if self.is_big(n0) else small).append(leaf)
        return big, small

    def stitch_mixed(self, orig_sizes: Sequence[int], big, small):
        """Inverse of :meth:`split_mixed` (original leaf order)."""
        big, small = list(big), list(small)
        out, bi, si = [], 0, 0
        for n0 in orig_sizes:
            if self.is_big(n0):
                out.append(big[bi])
                bi += 1
            else:
                out.append(small[si])
                si += 1
        return out

    # ---- the shard ops on [P, W, ...] tensors -------------------------------

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        """``[P, W, *shape]`` -> fp32 ``[P, W, W * shard_len]``, the tail
        zero."""
        n = _numel(x)
        s = self.shard_len(n)
        flat = x.reshape(tuple(x.shape[:2]) + (n,)).to(torch.float32)
        return torch.nn.functional.pad(flat, (0, s * self.W - n))

    def scatter_grad_leaf(self, g: torch.Tensor,
                          axis_name: str) -> torch.Tensor:
        """Worker-tier reduce of a big leaf: the mean psum_scatter, each
        slot keeping its contiguous shard (one global server's key
        range)."""
        return psum_scatter(self._padded(g), axis_name) / self.W

    def shard_param_leaf(self, p: torch.Tensor) -> torch.Tensor:
        """Each slot's contiguous parameter shard (zero-padded tail) as
        the fp32 master copy the sharded optimizer runs on."""
        return slice_worker_shards(self._padded(p), self.W)

    def unshard_param_leaf(self, new_shard: torch.Tensor,
                           like: torch.Tensor,
                           axis_name: str) -> torch.Tensor:
        """all_gather the updated shards back into the full tensor."""
        full = all_gather(new_shard, axis_name, tiled=True)[..., :_numel(like)]
        return full.reshape(like.shape).to(like.dtype).contiguous()
