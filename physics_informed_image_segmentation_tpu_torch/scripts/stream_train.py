"""Streamed against resident training on the card, at the bench's workload.

Counterpart of the JAX repo's ``scripts/stream_train_tpu.py``: 512
``make_blobs`` images of 128x128, the U-Net at ``base_channels=64`` under
bf16 autocast, the Stage II objective (K1 on the card), on-device metrics,
``create_train_state(model, 1e-4)`` with the default ``"adamw"``, batch 8.
Three rows:

    resident         make_train_epochs_fn over the card-resident split,
                     4 epochs a call (the headline bench's path)
    stream-step      batch_iterator -> prefetch_to_device(size=4) ->
                     make_train_step_fn, one call a batch
    stream-chunk-16  batch_iterator -> chunk_batches(16) ->
                     prefetch_to_device(size=2) -> make_train_chunk_fn

Each row keeps one train state, made once and carried from its warm-up
through its timed rounds, with the JAX script's epochs: warm-up / timed
4 / 4, 1 / 2 and 1 / 4.  The rows run in turns inside one process, in one
order and then the reverse, ``--rounds`` times (default 3); ``value`` is the
median round's img/s and every round is printed (one call on this card is
not a result: the step is host-bound).  A timed round starts and ends
behind a synchronisation; the kernels are built before any warm-up.  Only
real samples count: a streamed row counts the ``valid`` entries of the
batches it was fed (the padding of a ragged last batch, and the padding
batches of a last chunk, never count), the resident row the ``valid``
entries of its plans.  Each line also gives K1's launches a real step
(1 / 1 expected on the card) and the row's peak
``torch.cuda.max_memory_allocated`` over its timed rounds (the other rows'
states stay allocated meanwhile).

The JAX script trains the resident row with ``param_carry_dtype=bfloat16``;
the port's counterpart is bf16 autocast over float32 master weights, which
computes the same values, and which every row here uses.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.stream_train
    python -m physics_informed_image_segmentation_tpu_torch.scripts.stream_train resident

On the GPU by default, raising without one; ``--device cpu`` with small
``--images``, ``--size`` and ``--base-channels`` checks the control flow on
the host's clock.  Prints one JSON line a row, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..data import DeviceDataset, epoch_batch_indices, make_blobs
from ..data.streaming import HostDataset, batch_iterator, chunk_batches, prefetch_to_device
from ..models import UNet
from ..train import LossConfig, create_train_state, make_train_chunk_fn, make_train_epochs_fn
from ..train import make_train_step_fn
from ..utils.device import resolve_device, set_precision
from ..utils.measure import STAGE2, build_kernels, device_facts, launch_counts
from ..utils.profiling import sync

__all__ = ["N_IMAGES", "IMAGE_SIZE", "BATCH", "CHUNK_K", "ROWS", "EPOCHS", "ROUNDS", "counting",
           "make_rows", "run_rows", "main"]

N_IMAGES, IMAGE_SIZE, BATCH = 512, 128, 8
BASE_CHANNELS = 64
LEARNING_RATE = 1e-4
CHUNK_K = 16
ROWS = ("resident", "stream-step", f"stream-chunk-{CHUNK_K}")
EPOCHS = {"resident": (4, 4), "stream-step": (1, 2), f"stream-chunk-{CHUNK_K}": (1, 4)}
PREFETCH = {"stream-step": 4, f"stream-chunk-{CHUNK_K}": 2}
ROUNDS = 3


def counting(it: Iterator, acc: list) -> Iterator:
    """Pass ``(x, y, valid)`` batches through, adding their real samples to
    ``acc[0]`` and their number to ``acc[1]`` on the host."""
    for x, y, v in it:
        acc[0] += int(np.sum(v))
        acc[1] += 1
        yield x, y, v


def make_rows(rows, device, *, n_images: int = N_IMAGES, size: int = IMAGE_SIZE,
              base_channels: int = BASE_CHANNELS, precision: str = "bf16",
              seed: int = 0) -> dict:
    """``{row: run(n_epochs) -> (samples, real steps)}`` for ``rows``, each
    over its own train state (a U-Net initialised from ``seed``)."""
    dev = resolve_device(device)
    precision = set_precision(precision)
    images, masks = make_blobs(n_images, size, size, seed=seed)
    host = HostDataset(n=n_images, images=images, masks=masks)
    cfg = LossConfig(**STAGE2)

    def fresh_state():
        model = UNet(base_channels=base_channels,
                     generator=torch.Generator().manual_seed(seed)).to(dev)
        return create_train_state(model, LEARNING_RATE, dropout_seed=seed)

    def resident() -> Callable:
        data = DeviceDataset.from_numpy(images, masks, dev)
        epochs_fn = make_train_epochs_fn(cfg, compute_metrics=True, precision=precision)
        st = [fresh_state()]
        plans = {}  # the stacked plans of each epoch count, made before any timed call
        for n_ep in set(EPOCHS["resident"]):
            made = [epoch_batch_indices(n_images, BATCH, shuffle=True, device=dev,
                                        generator=torch.Generator().manual_seed(e))
                    for e in range(n_ep)]
            plans[n_ep] = (torch.stack([p[0] for p in made]), torch.stack([p[1] for p in made]))

        def run(n_ep: int):
            idx, valid = plans[n_ep]
            st[0], res = epochs_fn(st[0], data.images, data.masks, idx, valid)
            if not np.isfinite(res["loss"]).all():
                raise RuntimeError(f"stream_train resident: a loss is not finite: {res['loss']}")
            return int(valid.sum()), int(idx.shape[0] * idx.shape[1])
        return run

    def streamed(name: str) -> Callable:
        chunked = name != "stream-step"
        fn = (make_train_chunk_fn if chunked else make_train_step_fn)(
            cfg, compute_metrics=True, precision=precision)
        st = [fresh_state()]

        def run(n_ep: int):
            acc = [0, 0]
            for e in range(n_ep):
                it = counting(batch_iterator(host, BATCH, shuffle=True, seed=e), acc)
                if chunked:
                    it = chunk_batches(it, CHUNK_K)
                for item in prefetch_to_device(it, size=PREFETCH[name], device=dev):
                    st[0], out = fn(st[0], *item)
            loss = out["loss"] if not chunked else out["loss"][out["n"] > 0]
            if not bool(torch.isfinite(loss).all()):
                raise RuntimeError(f"stream_train {name}: a loss is not finite")
            return acc[0], acc[1]
        return run

    return {row: resident() if row == "resident" else streamed(row) for row in rows}


def run_rows(rows=ROWS, device=None, *, rounds: int = ROUNDS, n_images: int = N_IMAGES,
             size: int = IMAGE_SIZE, base_channels: int = BASE_CHANNELS,
             precision: str = "bf16") -> list:
    """Build, warm up, then time the rows in turns; returns one line a row."""
    unknown = [r for r in rows if r not in ROWS]
    if unknown or not rows:
        raise ValueError(f"unknown rows {unknown}; of {ROWS}")
    if rounds < 1:
        raise ValueError("need rounds >= 1")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    build_s = build_kernels(dev)
    facts = device_facts(dev)
    runs = make_rows(rows, dev, n_images=n_images, size=size, base_channels=base_channels,
                     precision=precision)
    for row in rows:
        runs[row](EPOCHS[row][0])
    sync(dev)
    timed = {row: {"rates": [], "seconds": [], "images": [], "steps": 0, "peak": 0,
                   "launches": {"physics_sums_fwd": 0, "physics_sums_bwd": 0}} for row in rows}
    for r in range(rounds):
        for row in (rows if r % 2 == 0 else rows[::-1]):
            t = timed[row]
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            n_img, steps = runs[row](EPOCHS[row][1])
            sync(dev)
            seconds = time.perf_counter() - t0
            after = launch_counts()
            for k in t["launches"]:
                t["launches"][k] += after[k] - before[k]
            if on_card:
                t["peak"] = max(t["peak"], torch.cuda.max_memory_allocated(dev))
            t["rates"].append(n_img / seconds)
            t["seconds"].append(seconds)
            t["images"].append(n_img)
            t["steps"] += steps
    lines = []
    for row in rows:
        t = timed[row]
        lines.append({
            "row": row, "metric": "train_images_per_sec", "value": statistics.median(t["rates"]),
            "unit": "images/sec", "rounds": t["rates"], "min": min(t["rates"]),
            "max": max(t["rates"]), "seconds": t["seconds"], "images_a_round": t["images"],
            "warmup_epochs": EPOCHS[row][0], "timed_epochs": EPOCHS[row][1],
            "prefetch": PREFETCH.get(row), "chunk_k": CHUNK_K if row == ROWS[2] else None,
            "k1_launches_per_step": {k: v / t["steps"] for k, v in t["launches"].items()},
            "max_memory_allocated_bytes": t["peak"] if on_card else None,
            "images": n_images, "batch_size": BATCH, "image_size": size,
            "base_channels": base_channels, "precision": precision, "build_s": build_s,
            **facts})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help=f"of {ROWS} (default: all, in turns)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--images", type=int, default=N_IMAGES)
    ap.add_argument("--size", type=int, default=IMAGE_SIZE)
    ap.add_argument("--base-channels", type=int, default=BASE_CHANNELS)
    ap.add_argument("--precision", default="bf16")
    args = ap.parse_args(argv)
    for line in run_rows(tuple(args.rows) or ROWS, args.device, rounds=args.rounds,
                         n_images=args.images, size=args.size,
                         base_channels=args.base_channels, precision=args.precision):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
