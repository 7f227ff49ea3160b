"""Data layer: COCO decode, device-resident pipeline, synthetic fixtures."""

from .coco import CocoSegmentationSource, rasterize_polygons  # noqa: F401
from .pipeline import (  # noqa: F401
    DeviceDataset,
    epoch_batch_indices,
    fold_seed,
    num_batches,
    subset_fraction_indices,
)
from .synthetic import make_blobs, write_synthetic_coco  # noqa: F401

__all__ = [
    "CocoSegmentationSource",
    "rasterize_polygons",
    "DeviceDataset",
    "epoch_batch_indices",
    "fold_seed",
    "num_batches",
    "subset_fraction_indices",
    "make_blobs",
    "write_synthetic_coco",
]
