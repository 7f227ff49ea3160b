#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the training path from ``csrc/`` (one
   ``nvcc`` per source, started together), timing the build;
3. hold each kernel against its plain PyTorch version on the card, at
   the training shape and at shapes that stress row tiling, odd sizes,
   masked slots, saturated probabilities and the diffusion-only residual;
4. check the U-Net forward on the card against the CPU in float32;
5. drive the port's main path, ``train()``, at full width (U-Net with
   base_channels 64, 128x128 images, batch 8, bf16, one epoch per stage)
   and check that Stage II went through the kernels, with the expected
   launch counts, and that every logged loss is finite;
6. time the kernels, their plain versions and steady-state Stage II
   training, with CUDA events;
7. print one JSON line describing every kernel, then the result line.

Needs one card, a CUDA toolkit (``nvcc``) and this repository around it.
"""

from __future__ import annotations

import json
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

D, A, EPS = 5.0, 0.5, 0.05
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


def time_training() -> float:
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
    state = create_train_state(model, 1e-5)
    cfg = LossConfig(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0,
                     reaction_threshold=0.5, epsilon=0.05)
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
    print(f"Stage II train steady state: {rate:.1f} img/s (median of {len(rates)} epochs of "
          f"{n // batch} steps; base_channels 64, 128x128, batch {batch}, bf16)")
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
    built = build_all(["physics_sums"], verbose=True)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    errors = check_kernels()
    torch.cuda.synchronize()
    check_unet()
    torch.cuda.synchronize()
    counts = drive_main_path()
    torch.cuda.synchronize()
    times = time_kernels()
    rate = time_training()
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
    ]
    print(json.dumps({"stage2_train_img_per_s": rate, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
