"""Data layer: COCO decode (PIL or the native rasteriser), device-resident
and streamed pipelines, augmentation, synthetic fixtures."""

from .augment import d4_augment, flip_augment  # noqa: F401
from .coco import CocoSegmentationSource, load_split, rasterize_polygons  # noqa: F401
from .pipeline import (  # noqa: F401
    DeviceDataset,
    epoch_batch_indices,
    fold_seed,
    num_batches,
    subset_fraction_indices,
)
from .streaming import (  # noqa: F401
    HostDataset,
    batch_iterator,
    chunk_batches,
    prefetch_to_device,
)
from .synthetic import make_blobs, write_synthetic_coco  # noqa: F401

__all__ = [
    "CocoSegmentationSource",
    "load_split",
    "d4_augment",
    "flip_augment",
    "rasterize_polygons",
    "DeviceDataset",
    "epoch_batch_indices",
    "fold_seed",
    "num_batches",
    "subset_fraction_indices",
    "make_blobs",
    "HostDataset",
    "batch_iterator",
    "chunk_batches",
    "prefetch_to_device",
    "write_synthetic_coco",
]
