from . import caches, collate, dataset, sampler, wav
from .dataset import FilePathDataset, get_frame_count, get_time_bin
from .collate import collate_batch
from .sampler import DynamicBatchSampler, BatchSizeTable

__all__ = [
    "caches",
    "collate",
    "dataset",
    "sampler",
    "wav",
    "FilePathDataset",
    "get_frame_count",
    "get_time_bin",
    "collate_batch",
    "DynamicBatchSampler",
    "BatchSizeTable",
]
