"""Megapixel training: the U-Net train step with image height sharded over ranks.

Counterpart of ``scripts/megapixel_demo.py``.  Runs real steps of
:func:`.sharding.make_sharded_train_step` with ``spatial=True,
halo_physics=True`` — one-row conv halos, the halo-padded physics kernel
K3 — on ``make_blobs`` images, and prints per rank the measured peak of
device memory (``torch.cuda.max_memory_allocated``; XLA's compile-time
``memory_analysis`` has no counterpart here), the time per step and the
card's name and power limit.

    torchrun --nproc-per-node N -m physics_informed_image_segmentation_tpu_torch.parallel.megapixel [H] [base_channels]
    python -m physics_informed_image_segmentation_tpu_torch.parallel.megapixel [H] [base_channels]

Alone it runs as a world of one.  H = W = 1024 and base_channels 64 by
default; bf16, one image, 3 steps, every rank on the ``space`` axis.  It
runs on the GPU (NCCL) unless given ``--device cpu`` (gloo).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from ..data import make_blobs
from ..models import UNet
from ..train.engine import create_train_state
from ..train.objective import LossConfig
from ..utils.device import set_precision
from .mesh import initialize_distributed, make_mesh
from .sharding import make_sharded_train_step, shard_train_state

__all__ = ["run", "main"]

# the Stage II objective of the port's train() defaults, D = 5 as in the
# JAX package's demo
STAGE2 = LossConfig(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0)
STEPS = 3


def card_line() -> str:
    """``name, power.limit`` of the card, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run(h: int = 1024, base_channels: int = 64) -> dict:
    """``STEPS`` bf16 steps of the halo train step on one H×H image, its
    rows sharded over every rank; call
    :func:`.mesh.initialize_distributed` first.  Weights and data come
    from seed 0.

    Returns this rank's losses, the first step's and the later steps' mean
    milliseconds, and its peak of device memory (None on the CPU).
    """
    mesh = make_mesh(data=1, space=dist.get_world_size())
    dev = mesh.device
    precision = set_precision("bf16")
    model = UNet(base_channels=base_channels, generator=torch.Generator().manual_seed(0))
    state = shard_train_state(create_train_state(model.to(dev), 1e-4), mesh)
    images, masks = make_blobs(1, h, h, seed=0)
    x, y = torch.as_tensor(images, device=dev), torch.as_tensor(masks, device=dev)
    step = make_sharded_train_step(STAGE2, mesh, spatial=True, halo_physics=True,
                                   precision=precision)

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        losses.append(float(loss))  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    later = times[1:]
    return {
        "rank": dist.get_rank(), "world": dist.get_world_size(), "mesh": mesh.shape,
        "image": [h, h], "base_channels": base_channels, "precision": precision,
        "losses": losses, "first_step_ms": times[0],
        "ms_per_step": sum(later) / len(later) if later else None,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("height", nargs="?", type=int, default=1024)
    ap.add_argument("base_channels", nargs="?", type=int, default=64)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    initialize_distributed(device=args.device)
    try:
        res = run(args.height, args.base_channels)
        if res["device"] != "cpu":
            res["card"] = card_line()
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
