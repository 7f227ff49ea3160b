"""Augmentation on the device: the square's eight symmetries and flips.

Counterpart of ``physics_informed_image_segmentation_tpu/data/augment.py``.
The dihedral group D4 (quarter turns, then a left-right flip) is exact for
segmentation: no interpolation, masks stay binary.  One code is drawn per
sample from an explicit ``torch.Generator`` and the same code transforms
the sample's image and mask.  A batch is transformed by one gather through
per-code index tables, with no host sync and no loop over samples.

:func:`d4_apply` and :func:`d4_invert` are the port's one D4 table, shared
with test-time augmentation in :mod:`..serve`.

Usage (codes drawn from the train state's dropout generator)::

    train_fn = make_train_epoch_fn(cfg, augment=d4_augment)
"""

from __future__ import annotations

import functools

import torch

__all__ = ["d4_apply", "d4_invert", "d4_augment", "flip_augment"]


def d4_apply(x: torch.Tensor, code: int) -> torch.Tensor:
    """Apply dihedral symmetry ``code`` (0-3 rot90, 4-7 rot90+flip) to NHWC."""
    k, flip = code % 4, code >= 4
    xt = torch.rot90(x, k, dims=(1, 2))
    return xt.flip(2) if flip else xt


def d4_invert(x: torch.Tensor, code: int) -> torch.Tensor:
    """The inverse of :func:`d4_apply` for the same code."""
    k, flip = code % 4, code >= 4
    if flip:
        x = x.flip(2)
    return torch.rot90(x, -k, dims=(1, 2))


@functools.lru_cache(maxsize=None)
def _d4_tables(size: int, device: torch.device) -> torch.Tensor:
    """(8, size²) int64: for each code, the source pixel of every output
    pixel of a (size, size) image, made by :func:`d4_apply` itself."""
    grid = torch.arange(size * size, device=device).reshape(1, size, size, 1)
    return torch.stack([d4_apply(grid, c).reshape(-1) for c in range(8)])


def _gather_pixels(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) with pixel p of sample b taken from ``index[b, p]``."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    return torch.gather(flat, 1, index.unsqueeze(-1).expand(b, h * w, c)).reshape(b, h, w, c)


def d4_augment(generator: torch.Generator, image: torch.Tensor, mask: torch.Tensor):
    """A random D4 symmetry per sample, the same for image and mask.

    image, mask: (B, H, W, C) with H == W, on ``generator``'s device.
    """
    b, h, w = image.shape[:3]
    if h != w:
        raise ValueError(f"d4_augment needs square images; got {h}x{w} (use flip_augment)")
    codes = torch.randint(0, 8, (b,), generator=generator, device=generator.device)
    index = _d4_tables(h, image.device)[codes.to(image.device)]
    return _gather_pixels(image, index), _gather_pixels(mask, index)


def flip_augment(generator: torch.Generator, image: torch.Tensor, mask: torch.Tensor):
    """Random left-right and up-down flips per sample (any H, W), the same
    for image and mask: a left-right flip with probability 1/2, then an
    up-down flip with probability 1/2, drawn as two bits of one code."""
    b, h, w = image.shape[:3]
    codes = torch.randint(0, 4, (b,), generator=generator, device=generator.device)
    codes = codes.to(image.device)
    rows = torch.arange(h, device=image.device)
    cols = torch.arange(w, device=image.device)
    lr = (codes % 2).reshape(b, 1, 1).bool()
    ud = (codes // 2).reshape(b, 1, 1).bool()
    src_r = torch.where(ud, h - 1 - rows.reshape(1, h, 1), rows.reshape(1, h, 1))
    src_c = torch.where(lr, w - 1 - cols.reshape(1, 1, w), cols.reshape(1, 1, w))
    index = (src_r * w + src_c).reshape(b, h * w)
    return _gather_pixels(image, index), _gather_pixels(mask, index)
