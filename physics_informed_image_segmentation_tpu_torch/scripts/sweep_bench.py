"""The batched sensitivity sweep against serial runs, on the card.

Counterpart of the JAX repo's ``scripts/sweep_bench.py``.  The 16 members
of S1 + S2 + S3 (``experiments/studies.py`` ``ALL_STUDIES``: a-sweep 5,
D-sweep 6, eps-sweep 5) train Stage II from one U-Net (base 64, bf16,
weights from a seed) on 200 / 50 ``make_blobs`` images, 8 epochs, batch 8,
lr 1e-4, patience 10, seed 42, two ways with the same data, epochs,
early stopping and grids:

  batched   one ``run_batched_sweep`` of all members (one vmapped stack,
            K1 once a member each way)
  serial    one ``run_batched_sweep`` of each member alone, in turn

Each is timed twice, cold (the first call in the process: cuDNN's
algorithm choice and the first kernel loads) and warm, host clock around
calls that end in a host read of the results.  Each line gives the peak of
``torch.cuda.max_memory_allocated`` above the start of its mode.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.sweep_bench
    python -m physics_informed_image_segmentation_tpu_torch.scripts.sweep_bench --members 3 --epochs 1

It runs on the GPU and raises without one; ``--device cpu`` (with small
sizes) checks the control flow on the host's clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..data import DeviceDataset, make_blobs
from ..experiments.studies import ALL_STUDIES
from ..experiments.sweep import run_batched_sweep, sweep_scalars_from_variants
from ..models import UNet
from ..utils.device import resolve_device
from ..utils.measure import build_kernels, device_facts

__all__ = ["N_TRAIN", "N_VAL", "EPOCHS", "sweep_data", "run_sweep_bench", "main"]

N_TRAIN, N_VAL = 200, 50
EPOCHS = 8
BATCH = 8
SIZE, BASE_CHANNELS, LEARNING_RATE = 128, 64, 1e-4


def sweep_data(dev, n_train: int, n_val: int, size: int):
    """The training and validation splits, resident on ``dev``."""
    tr = DeviceDataset.from_numpy(*make_blobs(n_train, size, size, seed=0), dev)
    va = DeviceDataset.from_numpy(*make_blobs(n_val, size, size, seed=1), dev)
    return tr, va


def run_sweep_bench(device=None, *, members: int = 16, epochs: int = EPOCHS,
                    n_train: int = N_TRAIN, n_val: int = N_VAL, size: int = SIZE,
                    base_channels: int = BASE_CHANNELS, precision: str = "bf16") -> list:
    """Returns the batched line, the serial line and each member's results
    (``best_val_dice`` and ``stop_epoch`` of the batched and serial runs)."""
    dev = resolve_device(device)
    build_kernels(dev)
    facts = device_facts(dev)
    variants = (ALL_STUDIES["S1"]() + ALL_STUDIES["S2"]() + ALL_STUDIES["S3"]())[:members]
    scalars = sweep_scalars_from_variants(variants)
    tr, va = sweep_data(dev, n_train, n_val, size)
    model = UNet(base_channels=base_channels, generator=torch.Generator().manual_seed(0))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    kw = dict(num_epochs=epochs, batch_size=BATCH, learning_rate=LEARNING_RATE,
              early_stopping_patience=10, seed=42, precision=precision, device=dev)

    def batched():
        out = run_batched_sweep(model, params, scalars, tr, va, **kw)
        return out["best_val_dice"], out["stop_epoch"]

    def serial():
        outs = [run_batched_sweep(model, params, {k: v[m:m + 1] for k, v in scalars.items()},
                                  tr, va, **kw) for m in range(len(variants))]
        return (np.concatenate([o["best_val_dice"] for o in outs]),
                np.concatenate([o["stop_epoch"] for o in outs]))

    lines, results = [], {}
    for mode, fn in (("batched", batched), ("serial", serial)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        walls, dice = [], []
        for _ in range(2):  # cold, warm
            t0 = time.perf_counter()
            best, stop = fn()  # host arrays: the call has synchronised
            walls.append(time.perf_counter() - t0)
            dice.append(float(np.sum(best)))
        if not np.isfinite(dice).all():
            raise RuntimeError(f"sweep_bench: {mode} best validation Dice not finite")
        results[mode] = {"best_val_dice": best.tolist(), "stop_epoch": stop.tolist()}
        line = {"mode": mode, "members": len(variants), "epochs": epochs, "train": n_train,
                "val": n_val, "batch_size": BATCH, "base_channels": base_channels,
                "precision": precision, "cold_s": walls[0], "warm_s": walls[1],
                "sum_best_val_dice": dice}
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            line.update(peak_bytes=peak, peak_above_start_bytes=peak - start)
        line.update(device_kind=facts["device_kind"], card=facts["card"])
        lines.append(line)
    lines.append({"members_results": results, "batched_over_serial_warm":
                  lines[0]["warm_s"] / lines[1]["warm_s"], "card": facts["card"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--members", type=int, default=16, help="the first N of the 16 members")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--train", type=int, default=N_TRAIN, help="training images")
    ap.add_argument("--val", type=int, default=N_VAL, help="validation images")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--base-channels", type=int, default=BASE_CHANNELS)
    ap.add_argument("--precision", default="bf16")
    args = ap.parse_args(argv)
    for line in run_sweep_bench(args.device, members=args.members, epochs=args.epochs,
                                n_train=args.train, n_val=args.val, size=args.size,
                                base_channels=args.base_channels, precision=args.precision):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
