"""Device-resident input pipeline.

Counterpart of ``physics_informed_image_segmentation_tpu/data/pipeline.py``.
A split is decoded once on the host and moved to the device once; every
epoch then gathers its batches on the device from an ``(idx, valid)``
plan.  A ragged final batch is padded to full size with a per-sample
validity mask, and losses and metrics mask the padding out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = [
    "DeviceDataset",
    "fold_seed",
    "num_batches",
    "epoch_batch_indices",
    "subset_fraction_indices",
]


@dataclass(frozen=True)
class DeviceDataset:
    """A split resident on one device.

    images: (N, H, W, 1) float32 in [0, 1]
    masks:  (N, H, W, 1) float32 in {0, 1}
    """

    images: torch.Tensor
    masks: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.images.shape[0])

    @property
    def device(self) -> torch.device:
        return self.images.device

    @classmethod
    def from_numpy(cls, images: np.ndarray, masks: np.ndarray, device) -> "DeviceDataset":
        return cls(
            torch.as_tensor(np.asarray(images, np.float32), device=device),
            torch.as_tensor(np.asarray(masks, np.float32), device=device),
        )

    def to(self, device) -> "DeviceDataset":
        """This split on ``device`` (no copy where it is there already)."""
        return DeviceDataset(self.images.to(device), self.masks.to(device))

    def select(self, indices) -> "DeviceDataset":
        idx = torch.as_tensor(np.asarray(indices), dtype=torch.long, device=self.device)
        return DeviceDataset(self.images[idx], self.masks[idx])


def fold_seed(*keys: int) -> int:
    """One 32-bit seed from integer keys (NumPy's ``SeedSequence``): the
    seed of one named random stream of a run, as ``jax.random.fold_in``
    derives keys in the JAX package."""
    return int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1)[0])


def num_batches(n: int, batch_size: int) -> int:
    """Ceil-div batch count: the ragged final batch is kept."""
    return -(-n // batch_size)


def epoch_batch_indices(
    n: int,
    batch_size: int,
    *,
    shuffle: bool,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-epoch batching plan: ``(idx, valid)`` of shape (nb, B).

    ``idx`` indexes into the dataset (padding slots repeat index 0);
    ``valid`` is 1.0 for real samples, 0.0 for padding.  The shuffle is
    ``torch.randperm`` drawn from ``generator`` (a CPU generator).
    """
    nb = num_batches(n, batch_size)
    if shuffle:
        order = torch.randperm(n, generator=generator)
    else:
        order = torch.arange(n)
    pad = nb * batch_size - n
    valid = torch.cat([torch.ones(n), torch.zeros(pad)])
    order = torch.cat([order, torch.zeros(pad, dtype=order.dtype)])
    return (
        order.reshape(nb, batch_size).to(device),
        valid.reshape(nb, batch_size).to(device),
    )


def subset_fraction_indices(
    n: int, fraction: float, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Low-label subset: ``int(n * fraction)`` indices without replacement,
    from the global NumPy RNG when ``rng`` is None (``np.random.choice``
    after ``np.random.seed(seed)``)."""
    subset_size = int(n * fraction)
    if rng is None:
        return np.random.choice(n, subset_size, replace=False)
    return rng.choice(n, subset_size, replace=False)
