"""Gradient compressors of the port."""

from geomx_tpu_torch.compression.base import (Compressor, NoCompressor,
                                              get_compressor)
from geomx_tpu_torch.compression.bisparse import BiSparseCompressor
from geomx_tpu_torch.compression.bucketing import (BucketedCompressor,
                                                   GradientBucketer,
                                                   maybe_bucketed)
from geomx_tpu_torch.compression.fp16 import FP16Compressor
from geomx_tpu_torch.compression.mpq import MPQCompressor
from geomx_tpu_torch.compression.twobit import TwoBitCompressor

__all__ = ["Compressor", "NoCompressor", "BiSparseCompressor",
           "BucketedCompressor", "FP16Compressor", "GradientBucketer",
           "MPQCompressor", "get_compressor", "TwoBitCompressor",
           "maybe_bucketed"]
