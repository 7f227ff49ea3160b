"""Quickstart: an end-to-end run on generated synthetic data, on the card.

Counterpart of the JAX repo's ``examples/quickstart_synthetic.py``.  It
writes a synthetic COCO dataset in the reference's directory layout
(24 / 8 / 8 images of 128x128), trains the two-stage pipeline through
``train()`` (15 + 5 epochs, batch 8, lr 3e-4, seed 0; Stage II through the
physics kernel), prints the best validation Dice of each stage and the
Stage II test Dice, and writes 4 predicted masks through
``Predictor.predict_files``.

    python -m physics_informed_image_segmentation_tpu_torch.examples.quickstart_synthetic [workdir]
    python -m physics_informed_image_segmentation_tpu_torch.examples.quickstart_synthetic run --device cpu

Each split's dataset is drawn from a seed that is a fixed function of the
split's name (:func:`split_seed`, CRC-32), so every run draws the same data.
The JAX example seeds from ``hash(split)``, which Python salts per process
unless ``PYTHONHASHSEED`` is set: two of its runs draw different datasets.

On the GPU by default, raising without one; ``--device cpu`` runs the plain
versions on the host (slow at these sizes; :func:`main` takes smaller ones).
"""

from __future__ import annotations

import argparse
import sys
import zlib
from pathlib import Path

import numpy as np

from ..data import write_synthetic_coco
from ..serve import Predictor
from ..train import train
from ..utils.device import resolve_device

__all__ = ["split_seed", "main"]


def split_seed(split: str) -> int:
    """The dataset seed of a split: the same in every process."""
    return zlib.crc32(split.encode()) % 1000


def main(workdir="quickstart_run", device=None, *, n_train: int = 24, n_val: int = 8,
         n_test: int = 8, size: int = 128, stage1_epochs: int = 15, stage2_epochs: int = 5,
         base_channels: int = 64, n_masks: int = 4) -> dict:
    """Write the dataset under ``workdir``, train, evaluate and predict;
    returns the two Dice lines' values and the masks' paths."""
    dev = resolve_device(device)
    workdir = Path(workdir).resolve()
    print(f"Working directory: {workdir}")

    img_root = workdir / "images"
    ann_dir = img_root / "annotation"
    ann_dir.mkdir(parents=True, exist_ok=True)
    for split, n in (("training", n_train), ("validation", n_val), ("testing", n_test)):
        image_dir, ann_path = write_synthetic_coco(
            workdir / f"_gen_{split}", n=n, height=size, width=size,
            seed=split_seed(split), r_range=(0.15, 0.3),
        )
        dest = img_root / split
        dest.mkdir(parents=True, exist_ok=True)
        for f in image_dir.iterdir():
            (dest / f.name).write_bytes(f.read_bytes())
        (ann_dir / f"{split}_annotation.json").write_text(ann_path.read_text())
    print("Synthetic COCO dataset written.")

    res = train(
        stage1_epochs=stage1_epochs,
        stage2_epochs=stage2_epochs,
        batch_size=8,
        learning_rate=3e-4,
        data_root=workdir,
        seed=0,
        base_channels=base_channels,
        device=dev,
    )
    dice = {"stage1_val": res["stage1"]["best"]["val"]["dice_score"],
            "stage2_val": res["stage2"]["best"]["val"]["dice_score"],
            "stage2_test": float(np.nanmean(res["test_metrics_stage2"]["dice_scores"]))}
    print(f"\nBest val Dice — Stage I: {dice['stage1_val']:.4f}, "
          f"Stage II: {dice['stage2_val']:.4f}")
    print(f"Test Dice (Stage II): {dice['stage2_test']:.4f}")

    predictor = Predictor(res["pde_model"], base_channels=base_channels, device=dev)
    test_images = sorted((img_root / "testing").iterdir())[:n_masks]
    masks = predictor.predict_files(test_images, threshold=0.5)
    out_dir = workdir / "predictions"
    out_dir.mkdir(exist_ok=True)
    from PIL import Image

    written = []
    for path, mask in zip(test_images, masks):
        written.append(out_dir / f"{path.stem}_mask.png")
        Image.fromarray((mask[..., 0] * 255).astype(np.uint8)).save(written[-1])
    print(f"Wrote {len(written)} predicted masks to {out_dir}")
    return {"dice": dice, "masks": written}


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="quickstart_run")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    main(args.workdir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
