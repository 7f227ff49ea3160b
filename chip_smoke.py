#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the training paths from ``csrc/`` (one
   ``nvcc`` per source, started together), timing the build;
3. hold each kernel against its plain PyTorch version on the card: K1 at
   the training shape and at shapes that stress row tiling, odd sizes,
   masked slots, saturated probabilities and the diffusion-only residual;
   K2 (the fused AdamW) bit for bit at the U-Net's parameter shapes and at
   awkward sizes, misaligned and beyond one launch's table; and whether
   PyTorch divides by a Python float truly on the card;
4. check the U-Net forward on the card against the CPU in float32;
5. drive the port's main path, ``train()``, at full width (U-Net with
   base_channels 64, 128x128 images, batch 8, bf16, one epoch per stage)
   and check that Stage II went through K1, with the expected launch
   counts, and that every logged loss is finite;
6. drive the K2 path, ``create_train_state(optimizer="pallas_adamw")``
   with the Stage II objective through ``train_stage``, at the same width
   and check its launch counts; then 3 float32 steps with deterministic
   cuDNN of "pallas_adamw" and "adamw" from the same weights: bit-equal;
7. checkpoint and resume on the card: a "pallas_adamw" state saved after
   2 steps and restored into a fresh state continues bit-equal to 4
   uninterrupted steps; ``train()`` with ``checkpoint_every=1``, a crash
   injected after Stage II epoch 1 and ``resume=True`` completes;
8. time the kernels, their plain versions, the library's fused AdamW and
   steady-state Stage II training with "adamw" and "pallas_adamw", with
   CUDA events;
9. print one JSON line describing every kernel, then the result line.

Needs one card, a CUDA toolkit (``nvcc``) and this repository around it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PKG = "physics_informed_image_segmentation_tpu_torch"

# Published peaks of one H100 SXM at its full power limit (NVIDIA data
# sheet): HBM3 bandwidth and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float operations a pixel costs in each kernel, counted from the source
FWD_FLOPS_PER_PIXEL = 45
BWD_FLOPS_PER_PIXEL = 90
# K2 per parameter: reads p, g, m, v and writes p, m, v (7 x 4 bytes);
# 15 float operations (4 mul + 2 add for the moments, 2 div + sqrt + add
# for the direction, mul + add + mul + add for the decay and step)
ADAMW_BYTES_PER_PARAM = 28
ADAMW_FLOPS_PER_PARAM = 15

D, A, EPS = 5.0, 0.5, 0.05
STAGE2 = dict(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=D,
              reaction_threshold=A, epsilon=EPS)
# Kernel vs plain version: both sum in float32 but in different orders
# (per-thread partials and warp trees against PyTorch's reductions; no
# atomics), and nvcc may contract a*b+c into FMAs.  Sums: rtol 1e-5.
# Gradients: atol 1e-6 * max|g| + rtol 1e-5 elementwise.
SUM_RTOL = 1e-5
GRAD_ATOL_REL, GRAD_RTOL = 1e-6, 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_case(shape, seed, *, saturated=False, mask=None):
    g = torch.Generator().manual_seed(seed)
    b = shape[0]
    if saturated:
        u = torch.randint(0, 3, shape, generator=g).float() / 2.0  # {0, 0.5, 1}
    else:
        u = 0.02 + 0.96 * torch.rand(shape, generator=g)
    t = (torch.rand(shape, generator=g) > 0.5).float()
    m = torch.ones((b, 1)) if mask is None else torch.tensor(mask, dtype=torch.float32).reshape(b, 1)
    cot = torch.randn((b, 6), generator=g)
    return [x.cuda() for x in (u, t, m, cot)]


def kernel_and_plain(u, t, m, cot, use_reaction):
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    out = {}
    for name, fn in (("kernel", K.FusedPhysicsSums.apply),
                     ("plain", K.fused_physics_sums_reference)):
        uu = u.clone().requires_grad_(True)
        tt = t.clone().requires_grad_(True)
        sums = fn(uu, tt, m, D, A, EPS, use_reaction)
        du, dt = torch.autograd.grad(sums, (uu, tt), cot)
        torch.cuda.synchronize()
        out[name] = (sums.detach(), du, dt)
    return out


def grad_ok(k, p) -> bool:
    tol = GRAD_ATOL_REL * p.abs().max() + GRAD_RTOL * p.abs()
    return bool(torch.all((k - p).abs() <= tol))


def check_kernels() -> dict:
    """Kernel vs plain version at every case; returns the main-shape errors."""
    cases = [
        ("train shape (8,128,128)", (8, 128, 128), {}, True),
        ("row tiling (2,512,512)", (2, 512, 512), {}, True),
        ("odd size (3,17,23)", (3, 17, 23), {}, True),
        ("masked slots (4,32,32)", (4, 32, 32), {"mask": [1, 0, 1, 0]}, True),
        ("saturated u (2,16,16)", (2, 16, 16), {"saturated": True}, True),
        ("no reaction (2,64,64)", (2, 64, 64), {}, False),
    ]
    errors = {}
    for i, (label, shape, kw, use_reaction) in enumerate(cases):
        u, t, m, cot = make_case(shape, seed=i, **kw)
        res = kernel_and_plain(u, t, m, cot, use_reaction)
        (sk, duk, dtk), (sp, dup, dtp) = res["kernel"], res["plain"]
        for name, x in (("sums", sk), ("du", duk), ("dt", dtk)):
            check(bool(torch.isfinite(x).all()), f"{label}: kernel {name} not finite")
        sum_ok = bool(torch.all((sk - sp).abs() <= SUM_RTOL * sp.abs()))
        err_s = float((sk - sp).abs().max())
        err_du = float((duk - dup).abs().max())
        err_dt = float((dtk - dtp).abs().max())
        print(f"K1 {label}: max|d sums| {err_s:.3e}, max|d du| {err_du:.3e} "
              f"(max|du| {float(dup.abs().max()):.3e}), max|d dt| {err_dt:.3e}")
        check(sum_ok, f"{label}: forward sums differ beyond rtol {SUM_RTOL}")
        check(grad_ok(duk, dup), f"{label}: du differs beyond tolerance")
        check(grad_ok(dtk, dtp), f"{label}: dt differs beyond tolerance")
        if "mask" in kw:
            dead = torch.tensor(kw["mask"], device=u.device) == 0
            check(bool((duk[dead] == 0).all() and (dtk[dead] == 0).all()),
                  "masked slots must get exactly zero gradient")
        if i == 0:
            errors = {"physics_sums_fwd": err_s, "physics_sums_bwd": max(err_du, err_dt)}
    return errors


@contextlib.contextmanager
def deterministic_f32():
    """float32 without TF32 and deterministic cuDNN, restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def unet_param_shapes() -> list:
    from physics_informed_image_segmentation_tpu_torch import UNet

    return [tuple(p.shape) for p in UNet(base_channels=64).parameters()]


def adamw_case(shapes, seed):
    """Params, and three steps of gradients of varied scale (1 to 1e-5 a
    tensor), on the card."""
    g = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=g).cuda() for s in shapes]
    grads = []
    for _ in range(3):
        scales = (10.0 ** -torch.randint(0, 6, (len(shapes),), generator=g)).tolist()
        grads.append([(torch.randn(s, generator=g) * sc).cuda() for s, sc in zip(shapes, scales)])
    return params, grads


def placed(x: torch.Tensor, misalign: bool) -> torch.Tensor:
    """A copy of ``x``; with ``misalign``, a contiguous view one float past
    a 16-byte boundary, so the kernel takes its scalar path."""
    if not misalign:
        return x.clone()
    view = torch.empty(x.numel() + 1, device=x.device)[1:].view(x.shape)
    view.copy_(x)
    return view


def run_adamw(cls, params, grads, misalign=False):
    """Copies of ``params`` stepped by ``cls`` (lr 1e-4, wd 1e-5) over
    ``grads``; returns the optimizer (params, m and v inside)."""
    opt = cls([placed(p, misalign) for p in params], 1e-4, 1e-5)
    opt.m = [placed(x, misalign) for x in opt.m]
    opt.v = [placed(x, misalign) for x in opt.v]
    for gs in grads:
        opt.step([placed(x, misalign) for x in gs])
    torch.cuda.synchronize()
    return opt


@torch.no_grad()
def adamw_diff(a, b) -> float:
    """Largest |difference| over params, m and v of two optimizers."""
    worst = 0.0
    for x, y in zip(a.params + a.m + a.v, b.params + b.m + b.v):
        if x.numel():
            worst = max(worst, float((x - y).abs().max()))
    return worst


def check_division() -> None:
    """The plain AdamW must divide by its bias corrections truly, as optax
    does.  Reports what PyTorch does with a Python float divisor on the
    card (``torch.div`` by a CPU scalar multiplies by the reciprocal)."""
    from physics_informed_image_segmentation_tpu_torch.train.optim import (
        _true_div,
        bias_corrections,
    )

    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(5)) * 1e-3
    xc = x.cuda()
    for count in (1, 2, 3, 10, 1000):
        for bc in bias_corrections(count):
            true_div = torch.from_numpy(x.numpy() / np.float32(bc))
            ours = _true_div([xc], bc)[0].cpu()
            by_float = torch._foreach_div([xc], bc)[0].cpu()
            print(f"division by {bc!r} on the card: _foreach_div by the float misses true "
                  f"division in {int((by_float != true_div).sum())} of {x.numel()}; the plain "
                  f"AdamW's division in {int((ours != true_div).sum())}")
            check(torch.equal(ours, true_div), "the plain AdamW does not divide truly")


def check_adamw() -> float:
    """K2 against its plain version, bit for bit; returns max|diff| at the
    U-Net's shapes."""
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2
    from physics_informed_image_segmentation_tpu_torch.train.optim import AdamW

    check_division()
    awkward = [(1,), (3,), (64,), (1023,), (4096,), (4097,), (65537,), (3, 3, 7, 5), (0,),
               (1 << 20,), (4_718_592,)]
    cases = [
        ("U-Net base 64 shapes", unet_param_shapes(), False, 1),
        ("awkward sizes", awkward, False, 1),
        ("awkward sizes, misaligned", awkward, True, 1),
        ("70 tensors (two launches)", [(17 * i + 1,) for i in range(70)], False, 2),
    ]
    main_err = None
    for i, (label, shapes, misalign, launches_per_step) in enumerate(cases):
        params, grads = adamw_case(shapes, seed=10 + i)
        K2.reset_launch_counts()
        kernel = run_adamw(K2.FusedAdamW, params, grads, misalign=misalign)
        launches = K2.launch_counts["adamw"]
        plain = run_adamw(AdamW, params, grads, misalign=misalign)
        err = adamw_diff(kernel, plain)
        print(f"K2 {label}: {len(shapes)} tensors, {sum(int(np.prod(s)) for s in shapes)} "
              f"params, 3 steps: max|diff| over p, m, v {err:.3e}; {launches} launches")
        check(launches == 3 * launches_per_step,
              f"{label}: expected {3 * launches_per_step} launches, got {launches}")
        for x in kernel.params + kernel.m + kernel.v:
            check(bool(torch.isfinite(x).all()), f"{label}: kernel output not finite")
        check(err == 0.0, f"{label}: K2 is not bit-equal to its plain version")
        if main_err is None:
            main_err = err
    return main_err


def check_unet() -> None:
    """U-Net forward on the card (f32, TF32 off) against the CPU."""
    from physics_informed_image_segmentation_tpu_torch import UNet
    from physics_informed_image_segmentation_tpu_torch.utils.device import set_precision

    set_precision("f32")
    model = UNet(base_channels=64, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand((2, 1, 64, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x)
        out = model.cuda()(x.cuda()).cpu()
    err = float((out - ref).abs().max())
    print(f"U-Net f32 forward, card vs CPU: max|diff| {err:.3e}")
    # float32 convolutions on both sides, summed in different orders
    check(err <= 1e-4, "U-Net forward on the card disagrees with the CPU")


def drive_main_path() -> dict:
    """The port's train() at full width; returns its K1 launch counts."""
    from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K
    from physics_informed_image_segmentation_tpu_torch.train import train

    n_train, n_val, n_test, batch = 32, 8, 8, 8
    images, masks = make_blobs(n_train + n_val + n_test, 128, 128, seed=0)
    split = lambda a, b: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cuda")
    data = dict(
        train_data=split(0, n_train),
        val_data=split(n_train, n_train + n_val),
        test_data=split(n_train + n_val, n_train + n_val + n_test),
    )
    scratch = REPO / "build"  # git-ignored
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(
            stage1_epochs=1, stage2_epochs=1, batch_size=batch, base_channels=64,
            precision="bf16", make_plots=False, verbose=False, device="cuda",
            output_dir=Path(tmp) / "output", models_dir=Path(tmp) / "models", **data,
        )
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        check(Path(res["pde_model"]).exists(), "Stage II checkpoint missing")

    steps, val_batches = -(-n_train // batch), -(-n_val // batch)
    print(f"train(): base_channels 64, 128x128, batch {batch}, bf16, "
          f"{seconds:.2f} s for both stages + test evaluation; K1 launches {counts}")
    check(counts["physics_sums_fwd"] == steps + val_batches,
          f"expected {steps + val_batches} forward launches, got {counts['physics_sums_fwd']}")
    check(counts["physics_sums_bwd"] == steps,
          f"expected {steps} backward launches, got {counts['physics_sums_bwd']}")
    for stage in ("stage1", "stage2"):
        for row in res[stage]["epochs"]:
            for k, v in row.items():
                check(np.isfinite(v), f"{stage} {k} is not finite: {v}")
    for row in res["stage2"]["epochs"]:
        check(row["train_pde_loss"] > 0 and row["val_pde_loss"] > 0,
              "Stage II pde_loss must be positive")
        print(f"Stage II epoch {row['epoch']}: train loss {row['train_loss']:.6f}, "
              f"pde {row['train_pde_loss']:.6e}, phase field {row['train_phase_field_loss']:.6e}, "
              f"val dice {row['val_dice_score']:.4f}")
    dice = res["test_metrics_stage2"]["dice_scores"]
    check(len(dice) == n_test and np.isfinite(dice).all(), "test metrics malformed")
    return counts


def unet64(seed: int = 0):
    from physics_informed_image_segmentation_tpu_torch import UNet

    return UNet(base_channels=64, generator=torch.Generator().manual_seed(seed)).cuda()


def blob_data(n: int, seed: int):
    from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs

    images, masks = make_blobs(n, 128, 128, seed=seed)
    return DeviceDataset.from_numpy(images, masks, "cuda")


def drive_adamw_path() -> dict:
    """The K2 path at full width: ``create_train_state(optimizer="pallas_adamw")``
    with the Stage II objective through ``train_stage`` (one epoch of 4
    steps and a validation batch, bf16); returns the launch counts."""
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, make_eval_epoch_fn, make_train_epoch_fn, train_stage,
    )
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2

    batch, steps = 8, 4
    train_data, val_data = blob_data(batch * steps, seed=2), blob_data(batch, seed=3)
    state = create_train_state(unet64(), 1e-5, optimizer="pallas_adamw")
    cfg = LossConfig(**STAGE2)
    K1.reset_launch_counts()
    K2.reset_launch_counts()
    state, _, _, rows = train_stage(
        state, make_train_epoch_fn(cfg, precision="bf16"), make_eval_epoch_fn(cfg, precision="bf16"),
        train_data, val_data, batch_size=batch, num_epochs=1, stage_name="Stage II",
        shuffle_seed=0, verbose=False,
    )
    torch.cuda.synchronize()
    counts = {**K1.launch_counts, **K2.launch_counts}
    print(f"K2 path (pallas_adamw, Stage II objective, base 64, 128x128, batch {batch}, bf16, "
          f"{steps} steps + 1 val batch): launches {counts}; train loss {rows[0]['train_loss']:.6f}")
    check(state.step == steps, f"expected {steps} optimizer steps, got {state.step}")
    check(counts["adamw"] == steps, f"expected {steps} K2 launches, got {counts['adamw']}")
    check(counts["physics_sums_fwd"] == steps + 1 and counts["physics_sums_bwd"] == steps,
          f"K1 launches on the K2 path: {counts}")
    check(all(np.isfinite(v) for v in rows[0].values()), f"non-finite metrics: {rows[0]}")
    return counts


def check_adamw_path_bit_equal() -> None:
    """3 float32 steps with deterministic cuDNN of "pallas_adamw" and
    "adamw" from the same weights, plan and dropout seed: bit-equal."""
    from physics_informed_image_segmentation_tpu_torch.data import epoch_batch_indices
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, make_train_epoch_fn,
    )

    with deterministic_f32():
        data = blob_data(24, seed=4)
        idx, valid = epoch_batch_indices(24, 8, shuffle=True, device="cuda",
                                         generator=torch.Generator().manual_seed(1))
        epoch_fn = make_train_epoch_fn(LossConfig(**STAGE2), precision="f32")
        final = {}
        for name in ("adamw", "pallas_adamw"):
            model = unet64()
            state = create_train_state(model, 1e-4, optimizer=name, dropout_seed=5)
            state, res = epoch_fn(state, data.images, data.masks, idx, valid)
            final[name] = ([p.detach().clone() for p in model.parameters()], res["loss"])
    (pa, la), (pk, lk) = final["adamw"], final["pallas_adamw"]
    diff = max(float((a - b).abs().max()) for a, b in zip(pa, pk))
    print(f"K2 path vs adamw, 3 f32 steps, deterministic cuDNN: max|d params| {diff:.3e}, "
          f"losses {la!r} / {lk!r}")
    check(diff == 0.0 and la == lk, "pallas_adamw and adamw trajectories differ")


def check_resume_engine() -> None:
    """A "pallas_adamw" state saved after 2 steps and restored into a fresh
    state (other weights, other dropout seed) continues bit-equal to 4
    uninterrupted steps (f32, deterministic cuDNN, dropout on)."""
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, make_train_step_fn, restore_train_state, save_train_state,
    )

    with deterministic_f32(), tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        data = blob_data(32, seed=6)
        batches = [(data.images[i:i + 8], data.masks[i:i + 8], torch.ones(8, device="cuda"))
                   for i in range(0, 32, 8)]
        step = make_train_step_fn(LossConfig(**STAGE2), compute_metrics=False, precision="f32")
        fresh = lambda seed: create_train_state(unet64(seed), 1e-4, optimizer="pallas_adamw",
                                                dropout_seed=seed + 7)
        whole = fresh(0)
        for b in batches:
            step(whole, *b)
        first = fresh(0)
        for b in batches[:2]:
            step(first, *b)
        path = save_train_state(first, tmp, keep=1)
        resumed = restore_train_state(fresh(99), tmp)
        check(resumed.step == 2, f"restored step {resumed.step}")
        for b in batches[2:]:
            step(resumed, *b)
        torch.cuda.synchronize()
        diff = adamw_diff(whole.optimizer, resumed.optimizer)
        size = path.stat().st_size
    print(f"checkpoint after 2 steps ({size / 1e6:.1f} MB), restored, 2 more steps vs 4 "
          f"uninterrupted: max|diff| over params, m, v {diff:.3e}")
    check(diff == 0.0, "a resumed pallas_adamw state differs from an uninterrupted one")


def check_resume_train() -> None:
    """``train()`` at full width with ``checkpoint_every=1``, a crash
    injected after Stage II epoch 1 of 2, then ``resume=True``."""
    from physics_informed_image_segmentation_tpu_torch.train import train

    n_train, n_val, batch = 32, 8, 8
    data = dict(train_data=blob_data(n_train, seed=7), val_data=blob_data(n_val, seed=8))
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        out, models = Path(tmp) / "output", Path(tmp) / "models"
        kw = dict(stage1_epochs=1, stage2_epochs=2, batch_size=batch, base_channels=64,
                  make_plots=False, verbose=False, device="cuda", output_dir=out,
                  models_dir=models, checkpoint_every=1, checkpoint_keep=1, **data)
        os.environ["PIIS_FAULT_AFTER"] = "Stage II:1"
        try:
            train(**kw)
            raise RuntimeError("chip_smoke: the injected crash did not happen")
        except RuntimeError as e:
            check("PIIS_FAULT_AFTER" in str(e), f"unexpected failure: {e}")
        finally:
            del os.environ["PIIS_FAULT_AFTER"]
        (csv_path,) = out.glob("metrics_stage2_*.csv")
        before = csv_path.read_text().splitlines()
        ckpts = sorted(p.name for p in (models / "checkpoints" / "stage2").iterdir())
        res = train(resume=True, **kw)
        after = Path(res["stage2_csv"]).read_text().splitlines()
    trained = [len(t["epoch_seconds"]) for t in res["stage_timings"]]
    print(f"train() resume on the card: Stage II checkpoints before the resume {ckpts}; "
          f"epochs trained by the resumed run per stage {trained}; Stage II rows "
          f"{len(after) - 1}")
    check(ckpts == [f"step_{n_train // batch}"], f"Stage II checkpoints {ckpts}")
    check(Path(res["stage2_csv"]) == csv_path, "the resumed run did not continue its CSV")
    check(len(before) == 2 and len(after) == 3 and after[:2] == before,
          "the replayed Stage II row differs from the row written before the crash")
    check(trained == [0, 1], "Stage I must be skipped and Stage II resume after epoch 1")
    for row in res["stage2"]["epochs"]:
        check(all(np.isfinite(v) for v in row.values()), f"non-finite row {row}")


def time_cuda(fn, warmup=5, reps=30) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each bracketed
    by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_pixels: int, batch: int, bwd: bool) -> tuple[float, str]:
    """Least time for the work on this card: bytes moved (each input read
    once, each output written once) or float32 operations, whichever is
    larger."""
    if bwd:  # read u, t, m, cot; write du, dt
        nbytes = 4 * n_pixels * 4 + batch * 4 + batch * 24
        flops = BWD_FLOPS_PER_PIXEL * n_pixels
    else:  # read u, t, m; write sums
        nbytes = 2 * n_pixels * 4 + batch * 4 + batch * 24
        flops = FWD_FLOPS_PER_PIXEL * n_pixels
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels() -> dict:
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    out = {}
    for shape in ((8, 128, 128), (8, 512, 512)):
        u, t, m, cot = make_case(shape, seed=100)
        args = (D, A, EPS, True)
        fwd = lambda: K._launch_fwd(u, t, m, *args)
        bwd = lambda: K._launch_bwd(u, t, m, cot, *args, need_dt=True)
        with torch.no_grad():
            plain_fwd = lambda: K.fused_physics_sums_reference(u, t, m, *args)
            k_fwd, p_fwd = time_cuda(fwd), time_cuda(plain_fwd)
        k_bwd = time_cuda(bwd)
        uu, tt = u.clone().requires_grad_(True), t.clone().requires_grad_(True)
        sums = K.fused_physics_sums_reference(uu, tt, m, *args)
        p_bwd = time_cuda(lambda: torch.autograd.grad(sums, (uu, tt), cot, retain_graph=True))
        n = shape[0] * shape[1] * shape[2]
        b_fwd, b_fwd_by = bound_ms(n, shape[0], bwd=False)
        b_bwd, b_bwd_by = bound_ms(n, shape[0], bwd=True)
        out[shape] = dict(fwd=k_fwd, plain_fwd=p_fwd, bound_fwd=b_fwd, bound_fwd_by=b_fwd_by,
                          bwd=k_bwd, plain_bwd=p_bwd, bound_bwd=b_bwd, bound_bwd_by=b_bwd_by)
        print(f"K1 times at {shape}: fwd {k_fwd:.4f} ms (plain {p_fwd:.4f}, bound {b_fwd:.5f} "
              f"by {b_fwd_by}); bwd {k_bwd:.4f} ms (plain {p_bwd:.4f}, bound {b_bwd:.5f} "
              f"by {b_bwd_by})")
    print("library_ms: no single PyTorch call computes K1's function, so there is no "
          "library yardstick (null)")
    return out


def adamw_bound_ms(n_params: int) -> tuple[float, str]:
    t_bytes = ADAMW_BYTES_PER_PARAM * n_params / PEAK_BYTES_PER_S * 1e3
    t_ops = ADAMW_FLOPS_PER_PARAM * n_params / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_adamw() -> dict:
    """Median ms per ``step()`` over the U-Net's 20.5M parameters: K2, the
    plain ``_foreach`` AdamW and, as the library yardstick,
    ``torch.optim.AdamW(fused=True)`` (it rounds in another order; the
    port never calls it).  Timed in turns: kernel, plain, library, library,
    plain, kernel."""
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2
    from physics_informed_image_segmentation_tpu_torch.train.optim import AdamW

    params, grads = adamw_case(unet_param_shapes(), seed=20)
    gs = grads[0]
    n = sum(p.numel() for p in params)
    kernel = K2.FusedAdamW([p.clone() for p in params], 1e-4, 1e-5)
    plain = AdamW([p.clone() for p in params], 1e-4, 1e-5)
    lib_params = [p.clone().requires_grad_(True) for p in params]
    for p, g in zip(lib_params, gs):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=1e-5, fused=True)
    fns = {"kernel": lambda: kernel.step(gs), "plain": lambda: plain.step(gs), "library": lib.step}
    runs: dict = {k: [] for k in fns}
    K2.reset_launch_counts()
    for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
        runs[name].append(time_cuda(fns[name]))
    launches_per_step = K2.launch_counts["adamw"] / kernel.count
    # what dividing truly (by a 0-dim tensor) costs the plain AdamW against
    # dividing by the Python float, over the same tensors
    from physics_informed_image_segmentation_tpu_torch.train.optim import _true_div

    div_true = time_cuda(lambda: _true_div(plain.m, 0.1))
    div_float = time_cuda(lambda: torch._foreach_div(plain.m, 0.1))
    print(f"plain AdamW division over the U-Net's moments, ms per call: by a 0-dim tensor "
          f"(true division) {div_true:.4f}, by the Python float {div_float:.4f}")
    out = {k: statistics.mean(v) for k, v in runs.items()}
    out["bound"], out["bound_by"] = adamw_bound_ms(n)
    out["launches_per_step"] = launches_per_step
    print(f"K2 times over {n} params in {len(params)} tensors, ms per step() (two medians "
          f"each): kernel {runs['kernel']}, plain _foreach {runs['plain']}, "
          f"torch.optim.AdamW(fused=True) {runs['library']}; bound {out['bound']:.5f} ms by "
          f"{out['bound_by']}; {launches_per_step:g} launches per step")
    return out


def time_training(optimizer: str) -> float:
    """Steady-state Stage II train img/s at full width (bf16, batch 8)."""
    from physics_informed_image_segmentation_tpu_torch import UNet
    from physics_informed_image_segmentation_tpu_torch.data import (
        DeviceDataset, epoch_batch_indices, make_blobs,
    )
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, make_train_epoch_fn,
    )

    n, batch = 64, 8
    images, masks = make_blobs(n, 128, 128, seed=1)
    data = DeviceDataset.from_numpy(images, masks, "cuda")
    model = UNet(base_channels=64, generator=torch.Generator().manual_seed(0)).cuda()
    state = create_train_state(model, 1e-5, optimizer=optimizer)
    cfg = LossConfig(**STAGE2)
    epoch_fn = make_train_epoch_fn(cfg, precision="bf16")
    gen = torch.Generator().manual_seed(0)
    rates = []
    for i in range(4):  # the first epoch is warm-up
        idx, valid = epoch_batch_indices(n, batch, shuffle=True, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, res = epoch_fn(state, data.images, data.masks, idx, valid)
        torch.cuda.synchronize()
        if i > 0:
            rates.append(n / (time.perf_counter() - t0))
        check(np.isfinite(res["loss"]), "Stage II timing epoch loss not finite")
    rate = statistics.median(rates)
    print(f"Stage II train steady state, {optimizer}: {rate:.1f} img/s (median of {len(rates)} "
          f"epochs of {n // batch} steps; base_channels 64, 128x128, batch {batch}, bf16)")
    return rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from physics_informed_image_segmentation_tpu_torch.utils.cuda_build import build_all

    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = build_all(["physics_sums", "adamw"], verbose=True)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    errors = check_kernels()
    errors["adamw"] = check_adamw()
    torch.cuda.synchronize()
    check_unet()
    torch.cuda.synchronize()
    counts = drive_main_path()
    torch.cuda.synchronize()
    k2_counts = drive_adamw_path()
    check_adamw_path_bit_equal()
    check_resume_engine()
    check_resume_train()
    torch.cuda.synchronize()
    times = time_kernels()
    k2_times = time_adamw()
    rates = {name: [] for name in ("adamw", "pallas_adamw")}
    for name in ("adamw", "pallas_adamw", "pallas_adamw", "adamw"):
        rates[name].append(time_training(name))
    torch.cuda.synchronize()

    main_shape = times[(8, 128, 128)]
    src = f"{PKG}/csrc/physics_sums.cu"
    kernels = [
        {"name": "physics_sums_fwd", "route": "cuda", "source": src,
         "replaces": "physics_informed_image_segmentation_tpu/ops/pallas_physics.py:245",
         "launches": counts["physics_sums_fwd"], "max_abs_err": errors["physics_sums_fwd"],
         "ms": main_shape["fwd"], "plain_ms": main_shape["plain_fwd"],
         "bound_ms": main_shape["bound_fwd"], "bound_by": main_shape["bound_fwd_by"],
         "library_ms": None},
        {"name": "physics_sums_bwd", "route": "cuda", "source": src,
         "replaces": "physics_informed_image_segmentation_tpu/ops/pallas_physics.py:262",
         "launches": counts["physics_sums_bwd"], "max_abs_err": errors["physics_sums_bwd"],
         "ms": main_shape["bwd"], "plain_ms": main_shape["plain_bwd"],
         "bound_ms": main_shape["bound_bwd"], "bound_by": main_shape["bound_bwd_by"],
         "library_ms": None},
        {"name": "adamw", "route": "cuda", "source": f"{PKG}/csrc/adamw.cu",
         "replaces": "physics_informed_image_segmentation_tpu/train/pallas_optim.py:118",
         "launches": k2_counts["adamw"], "max_abs_err": errors["adamw"],
         "ms": k2_times["kernel"], "plain_ms": k2_times["plain"],
         "bound_ms": k2_times["bound"], "bound_by": k2_times["bound_by"],
         "library_ms": k2_times["library"]},
    ]
    print(json.dumps({"stage2_train_img_per_s": rates, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
