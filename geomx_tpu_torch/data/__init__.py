"""Datasets, samplers and the HiPS batch loader."""

from geomx_tpu_torch.data.datasets import load_dataset
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.data.samplers import (ClassSplitSampler, SplitSampler,
                                           class_sorted_indices)

__all__ = ["load_dataset", "GeoDataLoader", "SplitSampler",
           "ClassSplitSampler", "class_sorted_indices"]
