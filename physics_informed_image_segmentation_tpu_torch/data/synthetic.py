"""Synthetic cell-like fixtures: in-memory blobs and on-disk COCO datasets.

Counterpart of ``physics_informed_image_segmentation_tpu/data/synthetic.py``
(same RNG call sequence, so the same seed gives the same arrays/files).
``make_blobs`` needs NumPy only; ``write_synthetic_coco`` imports PIL
when called.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["make_blobs", "write_synthetic_coco"]


def make_blobs(
    n: int,
    height: int = 128,
    width: int = 128,
    max_cells: int = 5,
    noise: float = 0.15,
    seed: int = 0,
    r_range: tuple[float, float] = (0.05, 0.18),
) -> tuple[np.ndarray, np.ndarray]:
    """Random soft-disk 'cells' on a noisy background.

    Returns (images, masks) of shape (n, H, W, 1) float32; images in
    [0, 1] (per-image min-max normalised), masks binary.
    """
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    images = np.zeros((n, height, width), np.float32)
    masks = np.zeros((n, height, width), np.float32)
    for i in range(n):
        k = int(rng.integers(1, max_cells + 1))
        img = rng.normal(0.2, noise, size=(height, width)).astype(np.float32)
        msk = np.zeros((height, width), np.float32)
        for _ in range(k):
            cy = rng.uniform(0.15, 0.85) * height
            cx = rng.uniform(0.15, 0.85) * width
            r = rng.uniform(*r_range) * min(height, width)
            d2 = (y - cy) ** 2 + (x - cx) ** 2
            inside = d2 <= r * r
            img += 0.7 * np.exp(-d2 / (2 * (0.7 * r) ** 2))
            msk = np.maximum(msk, inside.astype(np.float32))
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        images[i], masks[i] = img, msk
    return images[..., None], masks[..., None]


def _circle_polygon(cy: float, cx: float, r: float, k: int = 24) -> list[float]:
    theta = np.linspace(0, 2 * np.pi, k, endpoint=False)
    xs = cx + r * np.cos(theta)
    ys = cy + r * np.sin(theta)
    return np.stack([xs, ys], axis=1).flatten().tolist()


def write_synthetic_coco(
    root: Path,
    n: int = 8,
    height: int = 96,
    width: int = 112,
    seed: int = 0,
    missing_files: int = 0,
    r_range: tuple[float, float] = (0.06, 0.15),
    *,
    cells_range: tuple[int, int] = (1, 3),
    fg_range: tuple[float, float] = (200.0, 200.0),
    blur_sigma: float = 0.0,
) -> tuple[Path, Path]:
    """Write a synthetic COCO dataset; returns (image_dir, annotation_json).

    ``missing_files`` extra images are referenced in the JSON but not
    written to disk (the loader's skip-and-warn path).  ``cells_range``
    cells per image (inclusive), per-cell foreground intensity from
    ``fg_range`` and an optional Gaussian blur harden the task.
    """
    from PIL import Image

    root = Path(root)
    image_dir = root / "images"
    image_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    images_meta, annotations = [], []
    ann_id = 1
    for i in range(n + missing_files):
        fname = f"cell_{i:03d}.png"
        images_meta.append({"id": i + 1, "file_name": fname, "height": height, "width": width})
        k = int(rng.integers(cells_range[0], cells_range[1] + 1))
        img = rng.normal(80, 20, size=(height, width)).clip(0, 255)
        for _ in range(k):
            cy = rng.uniform(0.2, 0.8) * height
            cx = rng.uniform(0.2, 0.8) * width
            r = rng.uniform(
                max(4.0, r_range[0] * min(height, width)),
                r_range[1] * min(height, width),
            )
            fg = fg_range[0] if fg_range[0] == fg_range[1] else float(rng.uniform(*fg_range))
            yy, xx = np.mgrid[0:height, 0:width]
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = fg
            annotations.append(
                {"id": ann_id, "image_id": i + 1, "segmentation": [_circle_polygon(cy, cx, r)]}
            )
            ann_id += 1
        if blur_sigma > 0:
            from scipy.ndimage import gaussian_filter

            img = gaussian_filter(img, sigma=blur_sigma)
        if i < n:  # the rest are deliberately missing from disk
            Image.fromarray(img.astype(np.uint8)).save(image_dir / fname)

    ann_path = root / "annotations.json"
    with open(ann_path, "w") as f:
        json.dump({"images": images_meta, "annotations": annotations}, f)
    return image_dir, ann_path
