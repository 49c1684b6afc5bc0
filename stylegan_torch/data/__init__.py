"""Data pipeline: datasets, transforms, the threaded prefetching loader and
the pinned host-to-card prefetch."""

from .datasets import (ClassFolderDataset, FlatDirectoryImageDataset,
                       FoldersDistributedDataset, SyntheticDataset,
                       make_dataset)
from .loader import DataLoader, PinnedRing, device_prefetch, get_data_loader

__all__ = [
    "ClassFolderDataset", "FlatDirectoryImageDataset",
    "FoldersDistributedDataset", "SyntheticDataset", "make_dataset",
    "DataLoader", "PinnedRing", "device_prefetch", "get_data_loader",
]
