"""Data-sharding samplers (copy of geomx_tpu/data/samplers.py).

- ``SplitSampler``: contiguous 1/num_parts slice of the dataset per
  worker;
- ``ClassSplitSampler``: slices a *class-sorted* index list, giving each
  worker a class-skewed (non-iid) shard.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class SplitSampler:
    """Contiguous shard: indices [part_len*i, part_len*(i+1))."""

    def __init__(self, length: int, num_parts: int = 1, part_index: int = 0):
        if not (0 <= part_index < num_parts):
            raise ValueError(
                f"Invalid slice id ({part_index}), a slice id smaller than "
                f"num_workers ({num_parts}) is required.")
        self.part_len = length // num_parts
        self.start = self.part_len * part_index
        self.end = self.start + self.part_len

    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.end)

    def __iter__(self):
        return iter(range(self.start, self.end))

    def __len__(self):
        return self.part_len


class ClassSplitSampler:
    """Contiguous shard of a class-sorted index list (non-iid)."""

    def __init__(self, class_list: Sequence[int], length: int,
                 num_parts: int = 1, part_index: int = 0):
        if not (0 <= part_index < num_parts):
            raise ValueError(
                f"Invalid slice id ({part_index}), a slice id smaller than "
                f"num_workers ({num_parts}) is required.")
        self.class_list = np.asarray(class_list)
        self.part_len = length // num_parts
        self.start = self.part_len * part_index
        self.end = self.start + self.part_len

    def indices(self) -> np.ndarray:
        return self.class_list[self.start:self.end]

    def __iter__(self):
        return iter(self.class_list[self.start:self.end].tolist())

    def __len__(self):
        return self.part_len


def class_sorted_indices(labels: np.ndarray) -> np.ndarray:
    """Index list sorted by class label (stable sort)."""
    return np.argsort(labels, kind="stable")
