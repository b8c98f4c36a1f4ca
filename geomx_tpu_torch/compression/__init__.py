"""Gradient compressors of the port's main path."""

from geomx_tpu_torch.compression.base import (Compressor, NoCompressor,
                                              get_compressor)
from geomx_tpu_torch.compression.bisparse import BiSparseCompressor
from geomx_tpu_torch.compression.bucketing import (BucketedCompressor,
                                                   GradientBucketer,
                                                   maybe_bucketed)

__all__ = ["Compressor", "NoCompressor", "BiSparseCompressor",
           "BucketedCompressor", "GradientBucketer", "get_compressor",
           "maybe_bucketed"]
