"""Datasets, samplers, the HiPS batch loader, RecordIO and the needle
token task."""

from geomx_tpu_torch.data.datasets import DATASETS, load_dataset
from geomx_tpu_torch.data.loader import GeoDataLoader
from geomx_tpu_torch.data.needle import make_needle_data, with_positions
from geomx_tpu_torch.data.record_iter import ImageRecordIter, PrefetchIter
from geomx_tpu_torch.data.recordio import (RecordIOReader, RecordIOWriter,
                                           pack_labelled, recordio_reader,
                                           recordio_writer, unpack_labelled)
from geomx_tpu_torch.data.samplers import (ClassSplitSampler, SplitSampler,
                                           class_sorted_indices)

__all__ = ["load_dataset", "DATASETS", "GeoDataLoader", "SplitSampler",
           "ClassSplitSampler", "class_sorted_indices", "make_needle_data",
           "with_positions", "RecordIOReader", "RecordIOWriter",
           "recordio_reader", "recordio_writer", "pack_labelled",
           "unpack_labelled", "ImageRecordIter", "PrefetchIter"]
