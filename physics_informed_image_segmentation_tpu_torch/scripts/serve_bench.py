"""Serving rate on the card: ``Predictor.predict_device`` with and without TTA.

Counterpart of the JAX repo's ``scripts/serve_bench.py``.  A base-64 bf16
``Predictor`` (random weights from a seed, written to a ``.pth`` and read
back as a user's checkpoint is) at batch 128 runs ``predict_device`` over
1,024 card-resident ``make_blobs`` images, plain and with TTA (the 8 D4
views of a chunk as one 1,024-image batch; 512 images).  Each size is 2
warm-up and 3 timed calls, each ending in a synchronisation.  Two sizes
split the rate into a per-image device rate and a fixed cost a call:

    per_image = (t_big - t_small) / (n_big - n_small)
    fixed     = t_small - n_small * per_image

The split is unstable when the host sets the pace, so each line also
gives both raw times.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.serve_bench
    python -m physics_informed_image_segmentation_tpu_torch.scripts.serve_bench plain

It runs on the GPU and raises without one; ``--device cpu`` (with small
``--images``, ``--batch-size`` and ``--base-channels``) checks the control
flow on the host's clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..data import make_blobs
from ..models import UNet
from ..serve import Predictor
from ..train.checkpoint import save_params
from ..utils.device import resolve_device
from ..utils.measure import device_facts
from ..utils.profiling import sync

__all__ = ["N_IMAGES", "BATCH", "REPEATS", "split_rate", "run_serve", "main"]

N_IMAGES = 1024
BATCH = 128
WARMUP, REPEATS = 2, 3
SIZE, BASE_CHANNELS = 128, 64
MODES = ("plain", "tta")


def split_rate(n_small: int, t_small: float, n_big: int, t_big: float) -> tuple[float, float]:
    """(seconds per image, fixed seconds a call) from the times of two
    sizes, on the line t = fixed + n * per_image."""
    if n_big <= n_small:
        raise ValueError("the second size must be larger")
    per_image = (t_big - t_small) / (n_big - n_small)
    return per_image, t_small - n_small * per_image


def run_serve(modes=MODES, device=None, *, n_images: int = N_IMAGES, batch_size: int = BATCH,
              base_channels: int = BASE_CHANNELS, precision: str = "bf16",
              size: int = SIZE, warmup: int = WARMUP,
              repeats: int = REPEATS) -> list:
    """Time each mode at two sizes; returns one line per mode."""
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(f"unknown modes {unknown}; of {MODES}")
    dev = resolve_device(device)
    facts = device_facts(dev)
    model = UNet(base_channels=base_channels, generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_params(model, Path(tmp) / "serve_bench.pth")
        pred = Predictor(ckpt, batch_size=batch_size, image_size=(size, size),
                         precision=precision, base_channels=base_channels, device=dev)
    images, _ = make_blobs(n_images, size, size, seed=0)
    x_dev = torch.as_tensor(images, device=dev)  # one upload, stays on the device

    def timed(tta: bool, n: int) -> float:
        xs = x_dev[:n]
        for _ in range(warmup):
            pred.predict_device(xs, tta=tta)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = pred.predict_device(xs, tta=tta)
        sync(dev)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("serve_bench: a prediction is not finite")
        return (time.perf_counter() - t0) / repeats

    lines = []
    for mode in modes:
        tta = mode == "tta"
        n_big = n_images // 2 if tta else n_images
        t_small, t_big = timed(tta, batch_size), timed(tta, n_big)
        per_image, fixed = split_rate(batch_size, t_small, n_big, t_big)
        lines.append({
            "mode": mode, "batch_size": batch_size, "base_channels": base_channels,
            "precision": precision, "image_size": size,
            "device_rate_img_per_s": 1.0 / per_image if per_image > 0 else None,
            "us_per_image": per_image * 1e6, "fixed_ms_per_call": fixed * 1e3,
            "seconds_a_call": {str(batch_size): t_small, str(n_big): t_big},
            "img_per_s_a_call": {str(batch_size): batch_size / t_small, str(n_big): n_big / t_big},
            "device_kind": facts["device_kind"], "card": facts["card"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="*", help=f"of {MODES} (default: both)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--images", type=int, default=N_IMAGES)
    ap.add_argument("--batch-size", type=int, default=BATCH)
    ap.add_argument("--base-channels", type=int, default=BASE_CHANNELS)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--precision", default="bf16")
    args = ap.parse_args(argv)
    for line in run_serve(args.modes or MODES, args.device, n_images=args.images,
                          batch_size=args.batch_size, base_channels=args.base_channels,
                          precision=args.precision, size=args.size):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
