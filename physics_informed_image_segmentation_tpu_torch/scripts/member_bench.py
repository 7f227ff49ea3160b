"""Members-scaling probe of the batched sweep engine, on the card.

Counterpart of the JAX repo's ``scripts/member_bench.py``.  For each
member count M, M identical S2-shaped members (pde_weight 1e-3, no phase
field, D 5, a 0.5, eps 0.05; patience large enough that no member stops)
train with ``run_batched_sweep`` (base 64, bf16, 200 / 50 ``make_blobs``
images, batch 8, a validation pass every epoch) at two epoch budgets, E_LO
= 4 and E_HI = 12.  Each (M, E) is one warm-up call and the median of 3
timed calls (host clock around calls ending in a host read).  A call's
fixed cost is the same at both budgets, so the aggregate rate of the
work itself is taken from the difference:

    img/s ≈ M * n_train * (E_HI - E_LO) / (wall_HI - wall_LO)

One line per M, with the rate against M = first's rate a member and the
peak of ``torch.cuda.max_memory_allocated`` above the start.

    python -m physics_informed_image_segmentation_tpu_torch.scripts.member_bench          # M in 1 4 16
    python -m physics_informed_image_segmentation_tpu_torch.scripts.member_bench 1 8

It runs on the GPU and raises without one; ``--device cpu`` (with small
sizes) checks the control flow on the host's clock.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..experiments.sweep import run_batched_sweep
from ..models import UNet
from ..utils.device import resolve_device
from ..utils.measure import build_kernels, device_facts
from .sweep_bench import BASE_CHANNELS, BATCH, LEARNING_RATE, N_TRAIN, N_VAL, SIZE, sweep_data

__all__ = ["E_LO", "E_HI", "REPEATS", "run_members", "main"]

E_LO, E_HI = 4, 12
REPEATS = 3


def run_members(counts=(1, 4, 16), device=None, *, e_lo: int = E_LO, e_hi: int = E_HI,
                repeats: int = REPEATS, n_train: int = N_TRAIN, n_val: int = N_VAL,
                size: int = SIZE, base_channels: int = BASE_CHANNELS,
                precision: str = "bf16") -> list:
    """One line per member count."""
    if e_hi <= e_lo:
        raise ValueError("e_hi must exceed e_lo")
    dev = resolve_device(device)
    build_kernels(dev)
    facts = device_facts(dev)
    tr, va = sweep_data(dev, n_train, n_val, size)
    model = UNet(base_channels=base_channels, generator=torch.Generator().manual_seed(0))
    params = {k: v.clone() for k, v in model.state_dict().items()}

    def cell(m: int, epochs: int) -> float:
        scalars = {"pde_weight": np.full(m, 1e-3), "phase_field_weight": np.zeros(m),
                   "diffusion_coeff": np.full(m, 5.0), "reaction_threshold": np.full(m, 0.5),
                   "epsilon": np.full(m, 0.05)}

        def once() -> float:
            t0 = time.perf_counter()
            out = run_batched_sweep(model, params, scalars, tr, va, num_epochs=epochs,
                                    batch_size=BATCH, learning_rate=LEARNING_RATE,
                                    early_stopping_patience=10_000, seed=42,
                                    precision=precision, device=dev)
            if not np.isfinite(out["best_val_dice"]).all():
                raise RuntimeError("member_bench: best validation Dice not finite")
            return time.perf_counter() - t0

        once()  # warm-up
        return statistics.median(once() for _ in range(repeats))

    lines, base_rate = [], None
    for m in counts:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        lo, hi = cell(m, e_lo), cell(m, e_hi)
        d_sec = hi - lo
        rate = m * n_train * (e_hi - e_lo) / d_sec if d_sec > 0 else None
        if base_rate is None and rate:
            base_rate = rate / m
        line = {"members": m, "wall_lo_s": lo, "wall_hi_s": hi, "epochs_lo": e_lo,
                "epochs_hi": e_hi, "aggregate_img_per_s": rate,
                "vs_single_member_rate": rate / base_rate if rate and base_rate else None,
                "fixed_s_a_call": lo - d_sec * e_lo / (e_hi - e_lo),
                "train": n_train, "val": n_val, "base_channels": base_channels,
                "precision": precision}
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            line.update(peak_bytes=peak, peak_above_start_bytes=peak - start)
        line.update(device_kind=facts["device_kind"], card=facts["card"])
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("counts", nargs="*", type=int, help="member counts (default: 1 4 16)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--epochs-lo", type=int, default=E_LO)
    ap.add_argument("--epochs-hi", type=int, default=E_HI)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--train", type=int, default=N_TRAIN)
    ap.add_argument("--val", type=int, default=N_VAL)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--base-channels", type=int, default=BASE_CHANNELS)
    ap.add_argument("--precision", default="bf16")
    args = ap.parse_args(argv)
    for line in run_members(args.counts or (1, 4, 16), args.device, e_lo=args.epochs_lo,
                            e_hi=args.epochs_hi, repeats=args.repeats, n_train=args.train,
                            n_val=args.val, size=args.size, base_channels=args.base_channels,
                            precision=args.precision):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
