"""The full train step on one card at a megapixel field, remat on and off.

Counterpart of the JAX repo's ``scripts/megapixel_tpu.py``: the engine's
``make_train_step_fn`` (``compute_metrics=False``; the Stage II objective
with D = 5, K1 on the card at the whole (1, H, H) field; AdamW) with the
U-Net at base 64 under bf16 autocast, batch 1, at H x H (1024 by
default), first with ``UNet(remat=True)`` (each block's activations
recomputed in the backward pass), then without.  Both start from the
same weights, dropout seed and ``make_blobs`` image, after one untimed
step of each, remat off first (``warm_up_ms``: the cold start of the
process falls on remat off's warm-up step and on neither variant's
timed steps).  For each it prints
the peak of ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats`` over the first and the timed steps (the
counterpart of XLA's memory analysis), the first step's ms, ms a step over
the timed steps, Mpix/s trained, every step's loss and K1's launches.  A
size that does not fit prints ``torch.cuda.OutOfMemoryError`` as its
result, as the JAX script prints a failed compile; nothing else is caught.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.megapixel_bench [H] [steps]

K1 serves any field size, so there is no backend argument.  It runs on the
GPU and raises without one; ``--device cpu`` (with a small H and
``--base-channels``) checks the control flow on the host's clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..data import make_blobs
from ..models import UNet
from ..train import LossConfig, create_train_state, make_train_step_fn
from ..utils.device import resolve_device, set_precision
from ..utils.measure import build_kernels, device_facts, launch_counts
from ..utils.profiling import sync

__all__ = ["run_megapixel", "main"]

SIZE, STEPS = 1024, 10
BASE_CHANNELS, LEARNING_RATE = 64, 1e-4
CFG = dict(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0)


def _setup(dev, size: int, remat: bool, base_channels: int, precision: str):
    """A fresh train state, the step and the batch; the same weights,
    dropout seed and image whatever ``remat`` is."""
    model = UNet(base_channels=base_channels, remat=remat,
                 generator=torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, LEARNING_RATE)
    step = make_train_step_fn(LossConfig(**CFG), compute_metrics=False, precision=precision)
    images, masks = make_blobs(1, size, size, seed=1)
    batch = (torch.as_tensor(images, device=dev), torch.as_tensor(masks, device=dev),
             torch.ones(1, device=dev))
    return state, step, batch


def _warm_up(dev, size: int, base_channels: int, precision: str) -> dict:
    """One untimed step of each variant at the size, remat off first, so
    that what is cold in the process (the CUDA context, module loads,
    cuDNN's first choice of algorithm at these shapes) lands on neither
    variant's timed steps: remat off's warm-up step carries the cold start,
    remat on's what is its own on top of it.  ms of each."""
    out = {}
    for remat in (False, True):
        state, step, batch = _setup(dev, size, remat, base_channels, precision)
        sync(dev)
        t0 = time.perf_counter()
        float(step(state, *batch)[1]["loss"])
        out[f"remat_{'on' if remat else 'off'}"] = (time.perf_counter() - t0) * 1e3
        del state
    return out


def _one(dev, size: int, steps: int, remat: bool, base_channels: int, precision: str) -> dict:
    state, step, batch = _setup(dev, size, remat, base_channels, precision)
    losses = []
    before = launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    state, out = step(state, *batch)
    losses.append(float(out["loss"]))
    first = time.perf_counter() - t0
    outs = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out = step(state, *batch)
        outs.append(out["loss"])
    sync(dev)
    dt = (time.perf_counter() - t0) / steps
    losses += [float(o) for o in outs]
    after = launch_counts()
    return {"first_step_ms": first * 1e3, "ms_per_step": dt * 1e3,
            "mpix_per_s": size * size / 1e6 / dt, "losses": losses,
            "k1_launches": {k: after[k] - before[k] for k in ("physics_sums_fwd",
                                                               "physics_sums_bwd")}}


def run_megapixel(size: int = SIZE, steps: int = STEPS, device=None, *,
                  base_channels: int = BASE_CHANNELS, precision: str = "bf16") -> list:
    """One line for ``remat=True``, one for ``remat=False``, after one
    untimed step of each."""
    if steps < 1:
        raise ValueError("steps must be at least 1")
    dev = resolve_device(device)
    precision = set_precision(precision)
    build_kernels(dev)
    facts = device_facts(dev)
    on_card = dev.type == "cuda"
    before = launch_counts()
    try:
        warm_up_ms = _warm_up(dev, size, base_channels, precision)
    except torch.cuda.OutOfMemoryError:  # the variants report it below
        warm_up_ms = None
    after = launch_counts()
    warm_up_k1 = {k: after[k] - before[k] for k in ("physics_sums_fwd", "physics_sums_bwd")}
    lines = []
    for remat in (True, False):
        line = {"image": size, "base_channels": base_channels, "precision": precision,
                "batch": 1, "remat": remat, "steps": steps, "warm_up_ms": warm_up_ms,
                "warm_up_k1_launches": warm_up_k1}
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        try:
            line.update(_one(dev, size, steps, remat, base_channels, precision))
        except torch.cuda.OutOfMemoryError as e:  # a size that does not fit is a result
            line["error"] = f"OutOfMemoryError: {str(e)[:200]}"
        if on_card:
            line["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            line["peak_above_start_bytes"] = line["peak_bytes"] - start
        line.update(device_kind=facts["device_kind"], card=facts["card"])
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("size", nargs="?", type=int, default=SIZE, help="H = W (default 1024)")
    ap.add_argument("steps", nargs="?", type=int, default=STEPS, help="timed steps (default 10)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--base-channels", type=int, default=BASE_CHANNELS)
    ap.add_argument("--precision", default="bf16")
    args = ap.parse_args(argv)
    for line in run_megapixel(args.size, args.steps, args.device,
                              base_channels=args.base_channels, precision=args.precision):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
