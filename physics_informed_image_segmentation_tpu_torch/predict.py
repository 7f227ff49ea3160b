"""Inference CLI: predict segmentation masks for a directory of images.

Takes the flags of the repository's ``predict.py``, plus ``--device`` and
``--base-channels``.  Usage:

    python -m physics_informed_image_segmentation_tpu_torch.predict \\
        --model models/unet_pde_regularized.pth \\
        --input-dir images/testing --output-dir predictions
"""

import argparse
from pathlib import Path

import numpy as np

from .serve import Predictor


def main(argv=None):
    parser = argparse.ArgumentParser(description="Predict segmentation masks (PyTorch/CUDA)")
    parser.add_argument(
        "--model", type=str, required=True,
        help="Checkpoint path (.pth state dict from this package or the reference)",
    )
    parser.add_argument("--input-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default="predictions")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument(
        "--threshold", type=float, default=0.5,
        help="Binarization threshold; pass -1 to save probability maps",
    )
    parser.add_argument("--image-size", type=int, nargs=2, default=[128, 128])
    parser.add_argument(
        "--precision", type=str, default="bf16", choices=["bf16", "f32"]
    )
    parser.add_argument(
        "--base-channels", type=int, default=64,
        help="U-Net base channel count of the checkpoint (default: 64)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to predict on (default: cuda; 'cpu' runs on the host)",
    )
    args = parser.parse_args(argv)

    from PIL import Image

    input_dir = Path(args.input_dir)
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    exts = {".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp"}
    paths = sorted(p for p in input_dir.iterdir() if p.suffix.lower() in exts)
    if not paths:
        print(f"No images found in {input_dir}")
        return
    print(f"Predicting {len(paths)} images with {args.model} ...")

    predictor = Predictor(
        args.model,
        batch_size=args.batch_size,
        image_size=tuple(args.image_size),
        precision=args.precision,
        base_channels=args.base_channels,
        device=args.device,
    )
    threshold = None if args.threshold < 0 else args.threshold
    out = predictor.predict_files(paths, threshold=threshold)

    for path, pred in zip(paths, out):
        arr = (pred[..., 0] * 255).astype(np.uint8)
        Image.fromarray(arr).save(output_dir / f"{path.stem}_mask.png")
    print(f"Wrote {len(paths)} masks to {output_dir}")


if __name__ == "__main__":
    main()
