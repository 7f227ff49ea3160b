"""Headline benchmark of the port: train images/sec/chip with an MFU share.

Counterpart of the JAX repo's root ``bench.py``, with its workload: 512
``make_blobs`` images of 128x128 resident on the card, the U-Net at
``base_channels=64`` under bf16 autocast, the Stage II objective
(``pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0,
reaction_threshold=0.5, epsilon=0.05``; K1 on the card), AdamW at lr 1e-4,
and on-device Dice/IoU/Boundary-F1 every step, trained by
``make_train_epochs_fn`` over 5 stacked shuffled plans (batch 8, 64 steps
an epoch) a call.

Two warm-up calls, then ``--rounds`` timed calls, each started and ended
behind ``torch.cuda.synchronize()``.  One call's time is not a result on
this host-bound step, so ``value`` is the median over the rounds, and the
line gives every round's value with the min and max.  The kernels are
built, and checked against their plain versions (``kernel_check``, the
counterpart of the JAX bench's ``pallas_smoke``), before the warm-up: no
build falls inside a timed call.  A failed build, launch or check ends the
run with the exception and no line.

    python -m physics_informed_image_segmentation_tpu_torch.bench
    python -m physics_informed_image_segmentation_tpu_torch.bench --optimizer pallas_adamw
    python -m physics_informed_image_segmentation_tpu_torch.bench --device cpu \\
        --base-channels 4 --size 32 --images 16 --precision f32 --dropout 0

Prints ONE JSON line: ``metric`` ``"train_images_per_sec_per_chip"``,
``value`` (median img/s), ``rounds`` (img/s of each timed call), ``min``,
``max``, ``step_time_ms`` (of the median call), ``flops_per_step``
(:func:`analytic_flops_per_step`: the U-Net's convolutions, x3 for forward,
input gradient and weight gradient), ``device_kind``,
``peak_flops_assumed`` (bf16 dense peak of that card from
``utils.measure.PEAK_FLOPS``, null for a card not in the table), ``mfu``
(flops_per_step / step time / peak), ``physics_backend`` ("cuda" when K1
ran on the timed steps), ``launches_per_step`` of the kernels over the
timed calls, ``optimizer``, ``kernel_check`` and ``card`` (``nvidia-smi``'s
name and power limit).  It runs on the GPU and raises without one;
``--device cpu`` runs the plain versions on the host's clock, a check of
the control flow with ``mfu`` null, not a measurement.  The JAX bench's
modelled A100 and TPU keys are left out: no line here carries a number
that was not measured on this card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .data import DeviceDataset, epoch_batch_indices, fold_seed, make_blobs
from .models import UNet
from .ops import padded_physics_kernel as K3
from .ops import physics_kernel as K1
from .train import LossConfig, create_train_state, make_train_epoch_fn, make_train_epochs_fn
from .train.engine import TrainState
from .utils.device import resolve_device, set_precision
from .utils.measure import STAGE2, build_kernels, device_facts, launch_counts
from .utils.profiling import sync

__all__ = ["BATCH_SIZE", "IMAGE_SIZE", "N_IMAGES", "BASE_CHANNELS", "LEARNING_RATE",
           "WARMUP_CALLS", "TIMED_EPOCHS", "ROUNDS", "STAGE2", "analytic_flops_per_step",
           "kernel_check", "Workload", "make_workload", "timed_call", "run_bench",
           "add_workload_args", "main"]

BATCH_SIZE = 8
IMAGE_SIZE = 128
N_IMAGES = 512
BASE_CHANNELS = 64
LEARNING_RATE = 1e-4
WARMUP_CALLS = 2
TIMED_EPOCHS = 5
ROUNDS = 5

# kernel against plain version, the bars of the repo's kernel tests
SUM_RTOL = 1e-5
GRAD_ATOL_REL, GRAD_RTOL = 1e-6, 1e-5


def analytic_flops_per_step(b: int = BATCH_SIZE, s: int = IMAGE_SIZE, c: int = 64) -> float:
    """Training-step FLOPs of the U-Net: conv MACs x2, x3 for training
    (forward + input-grad + weight-grad conv each ~equal cost).  The JAX
    bench's count, kept here as the port's own copy: it counts the same
    work whatever computes it."""
    # (cin, cout, spatial) for every 3x3 conv in the reference topology
    convs = []
    plan = [(1, c), (c, c)], [(c, 2 * c), (2 * c, 2 * c)], \
        [(2 * c, 4 * c), (4 * c, 4 * c)], [(4 * c, 8 * c), (8 * c, 8 * c)]
    sp = s
    for level in plan:
        for cin, cout in level:
            convs.append((cin, cout, sp, 9))
        sp //= 2
    convs += [(8 * c, 8 * c, sp, 9), (8 * c, 8 * c, sp, 9)]  # bottleneck @ s/16
    dec_plan = [
        (8 * c, 8 * c, s // 8), (16 * c, 8 * c, s // 8),   # up4 + dec4 conv1
        (8 * c, 8 * c, s // 8),
        (8 * c, 4 * c, s // 4), (8 * c, 4 * c, s // 4), (4 * c, 4 * c, s // 4),
        (4 * c, 2 * c, s // 2), (4 * c, 2 * c, s // 2), (2 * c, 2 * c, s // 2),
        (2 * c, c, s), (2 * c, c, s), (c, c, s),
    ]
    # upsample k2s2: each output pixel gets one cin x cout matmul (tap 1
    # at output resolution); decoder convs = 9 taps
    taps = [1, 9, 9] * 4
    for (cin, cout, spx), k in zip(dec_plan, taps):
        convs.append((cin, cout, spx, k))
    convs.append((c, 1, s, 1))  # 1x1 output conv
    fwd = sum(2.0 * b * spx * spx * cin * cout * k for cin, cout, spx, k in convs)
    return 3.0 * fwd


def _grad_close(k: torch.Tensor, p: torch.Tensor) -> bool:
    tol = GRAD_ATOL_REL * p.abs().max() + GRAD_RTOL * p.abs()
    return bool(torch.all((k - p).abs() <= tol))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"kernel_check: {msg}")


def kernel_check(device="cuda", k1_plain: Optional[Callable] = None,
                 k3_plain: Optional[Callable] = None, shape=(4, IMAGE_SIZE, IMAGE_SIZE),
                 seed: int = 0) -> dict:
    """K1 and K3, forward and backward, against their plain versions on
    the card ``device`` at the JAX bench's (4, 128, 128) case; returns the largest
    differences and raises ``RuntimeError`` on a mismatch (sums rtol 1e-5;
    gradients atol 1e-6·max|g| + rtol 1e-5).  ``k1_plain`` / ``k3_plain``
    replace the plain versions (default: ``fused_physics_sums_reference``,
    ``padded_physics_sums_reference``)."""
    k1_plain = k1_plain or K1.fused_physics_sums_reference
    k3_plain = k3_plain or K3.padded_physics_sums_reference
    d, a, eps = STAGE2["diffusion_coeff"], STAGE2["reaction_threshold"], STAGE2["epsilon"]
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    u = torch.tensor(rng.uniform(0.1, 0.9, shape).astype(np.float32), device=dev)
    t = torch.tensor((rng.uniform(size=shape) > 0.5).astype(np.float32), device=dev)
    m = torch.ones((shape[0], 1), device=dev)
    cot1 = torch.tensor(rng.normal(size=(shape[0], 6)).astype(np.float32), device=dev)
    cot3 = torch.tensor(rng.normal(size=(shape[0], 2)).astype(np.float32), device=dev)
    p = F.pad(u[:, None], (1, 1, 1, 1), mode="reflect")[:, 0].contiguous()

    def k1(fn):
        uu, tt = u.clone().requires_grad_(True), t.clone().requires_grad_(True)
        sums = fn(uu, tt, m, d, a, eps, True)
        return (sums.detach(), *torch.autograd.grad(sums, (uu, tt), cot1))

    def k3(fn):
        pp = p.clone().requires_grad_(True)
        sums = fn(pp, d, a, eps, True)
        return sums.detach(), torch.autograd.grad(sums, pp, cot3)[0]

    errors = {}
    for label, kernel, plain in (("k1", k1(K1.FusedPhysicsSums.apply), k1(k1_plain)),
                                 ("k3", k3(K3.PaddedPhysicsSums.apply), k3(k3_plain))):
        sync(dev)
        (sk, *gk), (sp, *gp) = kernel, plain
        _check(bool(torch.all((sk - sp).abs() <= SUM_RTOL * sp.abs())),
               f"{label} sums differ from the plain version beyond rtol {SUM_RTOL} "
               f"(max |d| {float((sk - sp).abs().max()):.3e})")
        for i, (g1, g2) in enumerate(zip(gk, gp)):
            _check(bool(torch.isfinite(g1).all()) and _grad_close(g1, g2),
                   f"{label} gradient {i} differs from the plain version "
                   f"(max |d| {float((g1 - g2).abs().max()):.3e})")
        errors[f"{label}_sums"] = float((sk - sp).abs().max())
        errors[f"{label}_grad"] = max(float((g1 - g2).abs().max()) for g1, g2 in zip(gk, gp))
    return errors


@dataclass
class Workload:
    """The bench's training program on one device: a train state, the
    resident split, the stacked (E, nb, B) plans and the function that
    trains them in one call (E epochs of ``make_train_epochs_fn``, or, with
    ``calls="epoch"``, E calls of ``make_train_epoch_fn``)."""

    state: TrainState
    data: DeviceDataset
    idx: torch.Tensor
    valid: torch.Tensor
    train_fn: Callable
    calls: str = "epochs"

    @property
    def steps_per_call(self) -> int:
        return int(self.idx.shape[0] * self.idx.shape[1])

    @property
    def images_per_call(self) -> int:
        return int(self.idx.shape[0]) * self.data.n

    def call(self) -> dict:
        """Train the E epochs; returns per-epoch metrics (host arrays)."""
        d = self.data
        if self.calls == "epochs":
            self.state, res = self.train_fn(self.state, d.images, d.masks, self.idx, self.valid)
            return res
        rows = []
        for e in range(self.idx.shape[0]):
            self.state, r = self.train_fn(self.state, d.images, d.masks, self.idx[e],
                                          self.valid[e])
            rows.append(r)
        return {k: np.array([r[k] for r in rows]) for k in rows[0]}


def make_workload(device, *, n_images: int = N_IMAGES, size: int = IMAGE_SIZE,
                  batch_size: int = BATCH_SIZE, base_channels: int = BASE_CHANNELS,
                  epochs: int = TIMED_EPOCHS, precision: str = "bf16", dropout: float = 0.2,
                  optimizer: str = "adamw", flat: bool = False, calls: str = "epochs",
                  seed: int = 0) -> Workload:
    """The bench's workload on ``device``: ``make_blobs(n_images, size,
    size, seed)``, a U-Net initialised from ``seed``, AdamW at lr 1e-4,
    the Stage II objective with metrics, and E plans shuffled from
    ``fold_seed(seed, e)``."""
    if calls not in ("epochs", "epoch"):
        raise ValueError(f"calls must be 'epochs' or 'epoch'; got {calls!r}")
    dev = resolve_device(device)
    precision = set_precision(precision)
    images, masks = make_blobs(n_images, size, size, seed=seed)
    data = DeviceDataset.from_numpy(images, masks, dev)
    model = UNet(base_channels=base_channels, dropout=dropout,
                 generator=torch.Generator().manual_seed(seed)).to(dev)
    state = create_train_state(model, LEARNING_RATE, optimizer=optimizer, dropout_seed=seed,
                               flat=flat)
    plans = [epoch_batch_indices(n_images, batch_size, shuffle=True, device=dev,
                                 generator=torch.Generator().manual_seed(fold_seed(seed, e)))
             for e in range(epochs)]
    idx = torch.stack([p[0] for p in plans])
    valid = torch.stack([p[1] for p in plans])
    make = make_train_epochs_fn if calls == "epochs" else make_train_epoch_fn
    fn = make(LossConfig(**STAGE2), compute_metrics=True, precision=precision)
    return Workload(state, data, idx, valid, fn, calls)


def timed_call(workload: Workload, device: torch.device) -> tuple[float, dict]:
    """Seconds of one call of the workload between two synchronisations,
    and its metrics; the losses must be finite."""
    sync(device)
    t0 = time.perf_counter()
    res = workload.call()
    sync(device)
    seconds = time.perf_counter() - t0
    if not np.isfinite(res["loss"]).all():
        raise RuntimeError(f"bench: a loss is not finite: {res['loss']}")
    return seconds, res


def run_bench(device=None, *, rounds: int = ROUNDS, warmup: int = WARMUP_CALLS,
              epochs: int = TIMED_EPOCHS, n_images: int = N_IMAGES, size: int = IMAGE_SIZE,
              base_channels: int = BASE_CHANNELS, precision: str = "bf16",
              dropout: float = 0.2, optimizer: str = "adamw") -> dict:
    """Build, check, warm up and time the workload; returns the line."""
    if rounds < 1 or warmup < 0 or epochs < 1:
        raise ValueError("need rounds >= 1, warmup >= 0 and epochs >= 1")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    build_s = build_kernels(dev)
    checked = kernel_check(dev) if on_card else None
    facts = device_facts(dev)
    wl = make_workload(dev, n_images=n_images, size=size, base_channels=base_channels,
                       epochs=epochs, precision=precision, dropout=dropout,
                       optimizer=optimizer)
    for _ in range(warmup):
        timed_call(wl, dev)
    before = launch_counts()
    seconds, res = [], None
    for _ in range(rounds):
        s, res = timed_call(wl, dev)
        seconds.append(s)
    after = launch_counts()
    steps = rounds * wl.steps_per_call
    per_step = {k: (after[k] - before[k]) / steps for k in after}
    rates = [wl.images_per_call / s for s in seconds]
    median_s = statistics.median(seconds)
    step_s = median_s / wl.steps_per_call
    flops = analytic_flops_per_step(BATCH_SIZE, size, base_channels)
    peak = facts["peak_flops_assumed"]
    return {
        "metric": "train_images_per_sec_per_chip",
        "value": wl.images_per_call / median_s,
        "unit": "images/sec/chip",
        "rounds": rates,
        "min": min(rates),
        "max": max(rates),
        "step_time_ms": step_s * 1e3,
        "timed_epochs": epochs,
        "warmup_calls": warmup,
        "images": n_images,
        "batch_size": BATCH_SIZE,
        "image_size": size,
        "base_channels": base_channels,
        "precision": precision,
        "flops_per_step": flops,
        "mfu": flops / step_s / peak if peak else None,
        "physics_backend": "cuda" if per_step["physics_sums_fwd"] > 0 else "torch",
        "optimizer": optimizer,
        "launches_per_step": per_step,
        "final_loss": float(res["loss"][-1]),
        "kernel_check": "pass" if on_card else "not run: no kernel on the cpu",
        "kernel_check_max_abs_err": checked,
        "build_s": build_s,
        **facts,
    }


def add_workload_args(ap: argparse.ArgumentParser) -> None:
    """The workload's options, shared by the bench scripts."""
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--images", type=int, default=N_IMAGES, help="resident training images")
    ap.add_argument("--size", type=int, default=IMAGE_SIZE, help="image height and width")
    ap.add_argument("--base-channels", type=int, default=BASE_CHANNELS)
    ap.add_argument("--epochs", type=int, default=TIMED_EPOCHS, help="epochs a timed call")
    ap.add_argument("--warmup", type=int, default=WARMUP_CALLS, help="warm-up calls")
    ap.add_argument("--rounds", type=int, default=ROUNDS, help="timed calls")
    ap.add_argument("--precision", default="bf16", help="'bf16' (default) or 'f32'")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_workload_args(ap)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--optimizer", default="adamw",
                    help="a create_train_state optimizer name (default adamw)")
    args = ap.parse_args(argv)
    line = run_bench(args.device, rounds=args.rounds, warmup=args.warmup, epochs=args.epochs,
                     n_images=args.images, size=args.size,
                     base_channels=args.base_channels, precision=args.precision,
                     dropout=args.dropout, optimizer=args.optimizer)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
