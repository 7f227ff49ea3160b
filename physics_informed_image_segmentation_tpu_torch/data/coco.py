"""Host-side COCO-JSON → (image, mask) decoding (PIL, imported on use).

Counterpart of ``physics_informed_image_segmentation_tpu/data/coco.py``
with the PIL rasteriser:

* index ``images`` by id, group ``annotations`` by ``image_id``,
* keep only annotated images that exist on disk (warn + skip missing),
* per item: PIL grayscale ("L") load, bilinear resize, per-image min-max
  normalisation with +1e-8,
* mask rasterised from polygon lists (>= 6 coords) with PIL
  ``ImageDraw.polygon(outline=1, fill=1)`` at the original resolution,
  then NEAREST-resized and re-binarised (> 0).

The whole split is decoded into dense ``(N, H, W, 1)`` float32 arrays
once.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["CocoSegmentationSource", "rasterize_polygons"]


def rasterize_polygons(
    annotations: Sequence[dict],
    original_size: tuple[int, int],
    target_size: tuple[int, int],
) -> np.ndarray:
    """COCO polygon annotations → binary mask at ``target_size`` (H, W)."""
    from PIL import Image, ImageDraw

    H, W = original_size
    mask_img = Image.new("L", (W, H), 0)
    draw = ImageDraw.Draw(mask_img)
    for ann in annotations:
        segmentation = ann.get("segmentation", [])
        if isinstance(segmentation, list):
            for poly in segmentation:
                if len(poly) >= 6:
                    pts = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
                    draw.polygon(pts.flatten().tolist(), outline=1, fill=1)
    mask = np.array(mask_img, dtype=np.float32)

    th, tw = target_size
    resized = Image.fromarray(mask.astype(np.uint8)).resize((tw, th), resample=Image.NEAREST)
    return (np.array(resized, dtype=np.float32) > 0).astype(np.float32)


def _decode_image(path: Path, target_size: tuple[int, int]) -> np.ndarray:
    """Grayscale decode, bilinear resize, min-max normalise (per image)."""
    from PIL import Image

    th, tw = target_size
    image = Image.open(path).convert("L")
    image = image.resize((tw, th), resample=Image.BILINEAR)
    arr = np.array(image, dtype=np.float32)
    return (arr - arr.min()) / (arr.max() - arr.min() + 1e-8)


@dataclass
class CocoSegmentationSource:
    """Eagerly-decoded COCO segmentation split.

    Attributes after construction:
      images: (N, H, W, 1) float32 in [0, 1]
      masks:  (N, H, W, 1) float32 in {0, 1}
      image_ids: list of kept COCO image ids (annotated + on disk)
    """

    image_dir: Path
    annotation_file: Path
    image_size: tuple[int, int] = (128, 128)
    images: np.ndarray = field(init=False)
    masks: np.ndarray = field(init=False)
    image_ids: list = field(init=False)

    def __post_init__(self):
        self.image_dir = Path(self.image_dir).resolve()
        with open(Path(self.annotation_file).resolve()) as f:
            coco = json.load(f)

        images_dict = {img["id"]: img for img in coco["images"]}
        anns_by_image: dict = {}
        for ann in coco["annotations"]:
            anns_by_image.setdefault(ann["image_id"], []).append(ann)

        self.image_ids = []
        missing = []
        for img_id in images_dict:
            if img_id in anns_by_image:
                path = self.image_dir / images_dict[img_id]["file_name"]
                if path.exists():
                    self.image_ids.append(img_id)
                else:
                    missing.append(images_dict[img_id]["file_name"])
        if missing:
            print(
                f"Warning: {len(missing)} image(s) referenced in annotations "
                "but not found on disk:"
            )
            for fname in missing[:10]:
                print(f"  - {fname}")
            if len(missing) > 10:
                print(f"  ... and {len(missing) - 10} more")
            print(f"These images will be skipped. Dataset size: {len(self.image_ids)}")

        imgs, msks = [], []
        for img_id in self.image_ids:
            info = images_dict[img_id]
            imgs.append(_decode_image(self.image_dir / info["file_name"], self.image_size))
            msks.append(
                rasterize_polygons(
                    anns_by_image[img_id],
                    original_size=(info["height"], info["width"]),
                    target_size=self.image_size,
                )
            )
        h, w = self.image_size
        empty = np.zeros((0, h, w, 1), np.float32)
        self.images = np.stack(imgs)[..., None] if imgs else empty
        self.masks = np.stack(msks)[..., None] if msks else empty

    def __len__(self) -> int:
        return len(self.image_ids)
