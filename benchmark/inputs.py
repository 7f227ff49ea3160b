"""Inputs made from the seed: blob images with their masks, and the weights.

Both are made on the device by a ``torch.Generator`` seeded from ``--seed``,
in a few large calls, and handed alike to the program and to the
reference.  The same seed gives the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.unet import init_params, param_shapes

__all__ = ["generator", "blobs", "weights", "derive"]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a run."""
    return torch.Generator(device=device).manual_seed(derive(seed, stream))


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed``."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def blobs(n: int, size: int, gen: torch.Generator, device,
          max_blobs: int = 12) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` (size x size) cell-like images in [0, 1] and their binary masks,
    each (n, size, size, 1) float32: up to ``max_blobs`` discs of radius
    size/32 to size/8 with a soft halo, plus noise, min-max normalised per
    image.  Made 2^24 pixels at a time to bound the temporaries."""
    imgs, masks = [], []
    chunk = max(1, 2 ** 24 // (size * size))
    ax = torch.arange(size, device=device, dtype=torch.float32)
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        cy, cx = (torch.rand((2, m, max_blobs, 1, 1), generator=gen, device=device) * size)
        r = (torch.rand((m, max_blobs, 1, 1), generator=gen, device=device) * 3 + 1) * size / 32
        on = torch.rand((m, max_blobs, 1, 1), generator=gen, device=device) < 0.7
        noise = torch.rand((m, size, size), generator=gen, device=device)
        mask = torch.zeros((m, size, size), device=device)
        glow = torch.zeros((m, size, size), device=device)
        for j in range(max_blobs):
            d2 = (ax[None, :, None] - cy[:, j]) ** 2 + (ax[None, None, :] - cx[:, j]) ** 2
            inside = (d2 <= r[:, j] ** 2) & on[:, j]
            mask = torch.maximum(mask, inside.float())
            glow += on[:, j] * torch.exp(-d2 / (2 * r[:, j] ** 2))
        img = 0.5 * mask + 0.3 * glow + 0.2 * noise
        lo = img.amin((1, 2), keepdim=True)
        hi = img.amax((1, 2), keepdim=True)
        imgs.append(((img - lo) / (hi - lo + 1e-8))[..., None])
        masks.append(mask[..., None])
    return torch.cat(imgs), torch.cat(masks)


def weights(model_cfg: dict, gen: torch.Generator, device) -> dict:
    """The U-Net's float32 parameters by reference name (``init_params``)."""
    shapes = param_shapes(model_cfg["base_channels"], model_cfg["in_channels"],
                          model_cfg["out_channels"], model_cfg["dropout"])
    return init_params(shapes, gen, device)
