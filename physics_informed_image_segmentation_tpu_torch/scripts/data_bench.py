"""Input-pipeline rates on the host: decode and the streamed feed.

Counterpart of the JAX repo's ``scripts/data_bench.py``.  It writes 200
synthetic COCO images (``write_synthetic_coco``) to a temporary directory,
decodes the split once with each raster backend (``"pil"``, ``"native"``)
and reports images/s, then streams the decoded split for 20 shuffled
epochs through ``batch_iterator`` → ``prefetch_to_device`` (batch 8, two
batches ahead; on the card, pinned memory and a side stream) and reports
the images/s the feed sustains, counting the valid samples of every batch
on the device it lands on.  Both are host rates.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.data_bench
    python -m physics_informed_image_segmentation_tpu_torch.scripts.data_bench --device cpu

Without ``--device cpu`` it feeds the GPU and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from ..data import CocoSegmentationSource, HostDataset, batch_iterator, prefetch_to_device
from ..data import write_synthetic_coco
from ..utils.device import resolve_device
from ..utils.measure import device_facts

__all__ = ["N", "BATCH", "EPOCHS", "run_data", "main"]

N, BATCH, EPOCHS = 200, 8, 20
BACKENDS = ("pil", "native")


def run_data(device=None, *, n: int = N, epochs: int = EPOCHS) -> list:
    """One line per raster backend, then the feed's line."""
    dev = resolve_device(device)
    facts = device_facts(dev)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        img_dir, ann = write_synthetic_coco(Path(tmp), n=n)
        for backend in BACKENDS:
            t0 = time.perf_counter()
            src = CocoSegmentationSource(img_dir, ann, raster_backend=backend)
            dt = time.perf_counter() - t0
            if len(src.images) != n:
                raise RuntimeError(f"data_bench: decoded {len(src.images)} of {n} images")
            lines.append({"stage": "decode", "raster_backend": backend, "images": n,
                          "img_per_s": n / dt, "seconds": dt, "card": facts["card"]})
    host = HostDataset(n=n, images=src.images, masks=src.masks)

    def feed(epoch: int) -> int:
        count = 0
        for _, _, v in prefetch_to_device(
                batch_iterator(host, BATCH, shuffle=True, epoch=epoch), device=dev):
            count += int(v.sum())
        return count

    feed(0)  # warm-up: the pinned pool and the copy stream
    t0 = time.perf_counter()
    count = sum(feed(e) for e in range(epochs))
    dt = time.perf_counter() - t0
    lines.append({"stage": "stream", "device": dev.type, "batch_size": BATCH,
                  "prefetch": 2, "epochs": epochs, "images": count, "img_per_s": count / dt,
                  "device_kind": facts["device_kind"], "card": facts["card"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--images", type=int, default=N)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    args = ap.parse_args(argv)
    for line in run_data(args.device, n=args.images, epochs=args.epochs):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
