"""The component ladder of the headline bench's train step, on the card.

Counterpart of the JAX repo's ``scripts/floor_bench.py``.  Five programs at
the bench's shape (the U-Net at base 64, batch 8, 128x128, bf16 autocast,
dropout on), each adding one component to the one before:

  fwd      the forward pass (no gradient kept)
  fwdbwd   + the gradient of sum(pred) with respect to the parameters,
           no loss: the convolutions' floor
  loss     + the Stage II objective (``train/objective.py``, K1 on the
           card) forward and backward
  opt      + the optimizer step: ``make_train_step_fn(compute_metrics=False)``
  full     + the on-device Dice/IoU/Boundary-F1: the engine's
           ``make_train_step_fn`` step itself, the step the bench times

A timed call runs ``--steps`` steps (64) on resident batches and ends in a
synchronisation; each rung is 2 warm-up and 5 timed calls, and its figure
is the median call's ms a step.  One line per rung, then a line of the
rungs with each rung's delta over the one before: where the step's time
goes by component on this card.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.floor_bench
    python -m physics_informed_image_segmentation_tpu_torch.scripts.floor_bench fwdbwd full
    python -m physics_informed_image_segmentation_tpu_torch.scripts.floor_bench --optimizer pallas_adamw

It runs on the GPU and raises without one; ``--device cpu`` (with small
``--base-channels``/``--size``) checks the control flow on the host's clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import bench
from ..data import make_blobs
from ..models import UNet
from ..train import LossConfig, create_train_state, make_train_step_fn
from ..train.engine import forward_nhwc
from ..train.objective import make_loss_and_components
from ..utils.device import resolve_device, set_precision
from ..utils.measure import build_kernels, device_facts, launch_counts
from ..utils.profiling import sync

__all__ = ["RUNGS", "STEPS", "loss_and_grads", "make_rung", "run_ladder", "main"]

RUNGS = ("fwd", "fwdbwd", "loss", "opt", "full")
STEPS = 64
WARMUP, TIMED = 2, 5
DROPOUT = 0.2  # on, as in the bench


def loss_and_grads(state, loss_fn, x, y, valid, precision):
    """The ``loss`` rung's work: the Stage II objective on the training
    forward and its gradient with respect to the parameters."""
    state.model.train()
    pred = forward_nhwc(state.model, x, precision, state.dropout_generator)
    total, _ = loss_fn(pred, y, valid.reshape(-1, 1, 1, 1))
    return total.detach(), torch.autograd.grad(total, state.optimizer.params)


def make_rung(name: str, cfg: LossConfig, precision: str):
    """``step(state, x, y, valid) -> loss-like device scalar`` of rung ``name``."""
    if name == "fwd":
        @torch.no_grad()
        def step(state, x, y, valid):
            state.model.train()
            return forward_nhwc(state.model, x, precision, state.dropout_generator).sum()
    elif name == "fwdbwd":
        def step(state, x, y, valid):
            state.model.train()
            val = forward_nhwc(state.model, x, precision, state.dropout_generator).sum()
            torch.autograd.grad(val, state.optimizer.params)
            return val.detach()
    elif name == "loss":
        loss_fn = make_loss_and_components(cfg)

        def step(state, x, y, valid):
            return loss_and_grads(state, loss_fn, x, y, valid, precision)[0]
    elif name in ("opt", "full"):
        train_step = make_train_step_fn(cfg, compute_metrics=name == "full", precision=precision)

        def step(state, x, y, valid):
            return train_step(state, x, y, valid)[1]["loss"]
    else:
        raise ValueError(f"unknown rung {name!r}; one of {RUNGS}")
    return step


def run_ladder(rungs=RUNGS, device=None, *, steps: int = STEPS, warmup: int = WARMUP,
               timed: int = TIMED, size: int = bench.IMAGE_SIZE,
               base_channels: int = bench.BASE_CHANNELS, precision: str = "bf16",
               optimizer: str = "adamw") -> list:
    """Time each rung; returns one line per rung and the summary line."""
    unknown = [r for r in rungs if r not in RUNGS]
    if unknown:
        raise ValueError(f"unknown rungs {unknown}; of {RUNGS}")
    dev = resolve_device(device)
    precision = set_precision(precision)
    build_kernels(dev)
    facts = device_facts(dev)
    batch_size = bench.BATCH_SIZE
    images, masks = make_blobs(steps * batch_size, size, size, seed=0)
    xs = torch.as_tensor(images, device=dev).reshape(steps, batch_size, size, size, 1)
    ys = torch.as_tensor(masks, device=dev).reshape(steps, batch_size, size, size, 1)
    valid = torch.ones(batch_size, device=dev)
    cfg = LossConfig(**bench.STAGE2)
    lines, ms = [], {}
    for name in rungs:
        model = UNet(base_channels=base_channels, dropout=DROPOUT,
                     generator=torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, bench.LEARNING_RATE, optimizer=optimizer)
        step = make_rung(name, cfg, precision)

        def call():
            sync(dev)
            t0 = time.perf_counter()
            acc = step(state, xs[0], ys[0], valid)
            for i in range(1, steps):
                acc = acc + step(state, xs[i], ys[i], valid)
            value = float(acc)  # the synchronisation
            seconds = time.perf_counter() - t0
            if not np.isfinite(value):
                raise RuntimeError(f"floor_bench: rung {name} summed to {value}")
            return seconds

        for _ in range(warmup):
            call()
        before = launch_counts()
        sec = statistics.median(call() for _ in range(timed))
        after = launch_counts()
        ms[name] = sec / steps * 1e3
        lines.append({"rung": name, "ms_per_step": ms[name],
                      "img_per_s": steps * batch_size / sec,
                      "launches_per_step": {k: (after[k] - before[k]) / (timed * steps)
                                            for k in after},
                      "optimizer": optimizer, "device_kind": facts["device_kind"],
                      "card": facts["card"]})
        del state, model
    prev, deltas = 0.0, {}
    for name, v in ms.items():
        deltas[name] = v - prev
        prev = v
    lines.append({"floor_ms_per_step": ms, "delta_ms": deltas, "steps": steps,
                  "batch_size": batch_size, "image_size": size, "base_channels": base_channels,
                  "precision": precision, "device_kind": facts["device_kind"],
                  "card": facts["card"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rungs", nargs="*", help=f"rungs to time, of {RUNGS} (default: all)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=STEPS, help="steps a timed call")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--timed", type=int, default=TIMED)
    ap.add_argument("--size", type=int, default=bench.IMAGE_SIZE)
    ap.add_argument("--base-channels", type=int, default=bench.BASE_CHANNELS)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--optimizer", default="adamw")
    args = ap.parse_args(argv)
    for line in run_ladder(args.rungs or RUNGS, args.device, steps=args.steps,
                           warmup=args.warmup, timed=args.timed, size=args.size,
                           base_channels=args.base_channels, precision=args.precision,
                           optimizer=args.optimizer):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
