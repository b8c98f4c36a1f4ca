"""Datasets, samplers, the HiPS batch loader and the needle token task."""

from geomx_tpu_torch.data.datasets import load_dataset
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.data.needle import make_needle_data, with_positions
from geomx_tpu_torch.data.samplers import (ClassSplitSampler, SplitSampler,
                                           class_sorted_indices)

__all__ = ["load_dataset", "GeoDataLoader", "SplitSampler",
           "ClassSplitSampler", "class_sorted_indices", "make_needle_data",
           "with_positions"]
