"""The dc tier's flat bucket layout, recomputed from the leaf shapes.

The rule GeoMX states for its bucketed all-reduce: leaves in sorted-key
order (each key split on ``.``), each flattened in its own element order,
packed greedily into buckets of at most ``bucket_bytes / 4`` float32
elements (a leaf larger than that takes a bucket of its own; no leaf is
split), and each bucket's tail zero-padded to a multiple of 128.  A
Bi-Sparse selection runs once a bucket, so the reference has to cut the
gradient the same way to select the same pairs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

PAD = 128


def leaf_order(names) -> List[str]:
    return sorted(names, key=lambda name: name.split("."))


class Layout:
    """leaf name -> (bucket, offset, size, shape)."""

    def __init__(self, shapes: Dict[str, Sequence[int]],
                 bucket_bytes: int = 4 * 1024 * 1024, pad: int = PAD):
        capacity = max(pad, int(bucket_bytes) // 4)
        self.names = leaf_order(shapes)
        self.slots: Dict[str, Tuple[int, int, int, tuple]] = {}
        fills: List[int] = []
        for name in self.names:
            shape = tuple(int(d) for d in shapes[name])
            size = math.prod(shape)
            if not fills or (fills[-1] > 0 and fills[-1] + size > capacity):
                fills.append(0)
            self.slots[name] = (len(fills) - 1, fills[-1], size, shape)
            fills[-1] += size
        self.fills = fills
        self.bucket_sizes = [-(-f // pad) * pad for f in fills]

    def flatten(self, leaves: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Leaves (any leading dims ``lead``, the same for all) -> fp32
        buckets ``[*lead, n]``."""
        first = leaves[self.names[0]]
        lead = tuple(first.shape[:first.dim() - len(self.slots[
            self.names[0]][3])])
        out = [torch.zeros(lead + (n,), dtype=torch.float32,
                           device=first.device) for n in self.bucket_sizes]
        for name in self.names:
            b, off, size, _ = self.slots[name]
            out[b][..., off:off + size] = \
                leaves[name].reshape(lead + (size,)).float()
        return out

    def unflatten(self, buckets: Sequence[torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Buckets ``[*lead, n]`` -> leaves ``[*lead, *shape]`` (views)."""
        lead = tuple(buckets[0].shape[:-1])
        return {name: buckets[b][..., off:off + size].reshape(lead + shape)
                for name, (b, off, size, shape) in self.slots.items()}
