#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without the
final result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``csrc/`` (five sources, one ``nvcc``
   each, started together), timing the build;
3. hold each kernel against its plain PyTorch version on the card: K1 at
   the training shape and at shapes that stress the tiling (H and W of 2
   to 5, shapes that end inside a tile both ways, W of 1000 and 4096),
   masked slots, saturated probabilities and the diffusion-only residual,
   against autograd of the plain sums and against the tile-wise plain
   backward, with and without dt, repeated bit for bit, and captured in a
   CUDA graph and replayed; K2 (the fused AdamW) bit for bit at the
   U-Net's parameter shapes and at awkward sizes, misaligned and beyond one
   launch's table, its plan kept over steps with fresh gradients and made
   anew for a replaced tensor; and whether PyTorch divides by a Python
   float truly on the card;
4. check the U-Net forward on the card against the CPU in float32;
5. drive the port's main path, ``train()``, at full width (U-Net with
   base_channels 64, 128x128 images, batch 8, bf16, one epoch per stage)
   and check that Stage II went through K1, with the expected launch
   counts, and that every logged loss is finite; then serve the ``.pth``
   it wrote: a ``Predictor`` at full width, ``predict`` on 20 images (a
   padded last chunk) against the model's own forward, ``tta`` on a
   symmetric input, ``predict_device`` on 64 device-resident images
   against ``predict`` and its images per second, ``predict_tiled`` on a
   512x512 image; then the experiment layer at the same width: an ablation
   study of R1.0 and a three-stage R1.3 (one epoch a stage) with K1's launch
   counts (Stage II of R1.3 alone launches it), its files, result keys and
   finite metrics, the same study resumed (no K1 launch, the same
   aggregate), ``evaluate_and_compare`` and ``run_repeated_evaluations`` on
   its checkpoints, and the ``run_ablation`` and ``evaluate`` CLIs on a
   synthetic COCO layout;
   then the reference-name surface (``compat.py``) at the same width:
   ``DiceBCEPDELoss`` on a (8, 1, 128, 128) batch forward and backward
   through K1 (1 / 1 launches) against its plain path, the native
   rasteriser against PIL on a synthetic COCO split,
   ``evaluate_on_test_set`` from a base-64 ``.pth`` on that split, and the
   ``Predictor`` and ``evaluate_on_test_set`` from the committed
   ``.msgpack`` fixtures against the JAX Predictor's stored outputs;
6. drive the K2 path, ``create_train_state(optimizer="pallas_adamw")``
   with the Stage II objective through ``train_stage``, at the same width
   and check its launch counts; then 3 float32 steps with deterministic
   cuDNN of "pallas_adamw" and "adamw" from the same weights: bit-equal;
7. checkpoint and resume on the card: a "pallas_adamw" state saved after
   2 steps and restored into a fresh state continues bit-equal to 4
   uninterrupted steps; ``train()`` with ``checkpoint_every=1``, a crash
   injected after Stage II epoch 1 and ``resume=True`` completes;
8. K3 (the halo-padded physics sums) against its plain version and its
   tile-wise plain backward at the megapixel block (1,1026,1026), the
   training block (8,130,130), odd pitches, interiors one pixel high, nine
   images with ragged tiles, a block 4 bytes off its alignment, the
   smallest band, saturated u and without the reaction term, each case
   with the copy width it took, repeated bit for bit, and captured in a
   CUDA graph and replayed; and K3 on the four ghost-filled row bands of a
   (2,256,256) field against K1 on the whole field, sums and folded
   gradients;
   then K4 (the 3x3 convolution: forward in both tap orders, dx and dW)
   against its plain version at the probe's shape (8,128,128,64) in bf16,
   the JAX tests' shapes, several tiles with ragged edges, two channel
   chunks and all-ones inputs, and in float32 against ``F.conv2d``; every
   case prints the kernel set (wgmma, wmma or CUDA cores) that its forward,
   dx and dW took and is held to the set its operands should take;
   then GroupNorm with its residual and ReLU (``ops/group_norm.py``)
   against float64 at TransUNet's site kinds at 1024², batch 8, odd H*W,
   H*W below a pack, one group, in bf16 and float32, repeated bit for bit,
   and a bf16 forward and backward of TransUNet's ResNet at 1024² that
   counts 52 launches each way;
   then Swin-Unet's LayerNorm (``ops/layer_norm.py``) against float64 at
   every distinct site of an 896² step, batch 8, in the sites' types, and at
   odd row counts in every type pair, repeated bit for bit, and a bf16
   forward and backward of Swin-Unet at 896² that counts 38 launches each
   way (a no-grad forward 38 and 0);
9. the data×space path at world 1 (NCCL through a file store): the
   megapixel train step (``parallel/megapixel.py``: 1024x1024, base 64,
   bf16, 3 steps) with K3's launch counts and its peak memory; one f32
   halo step at 128x128 against the unsharded K1 step; one
   data-parallel epoch of ``make_sharded_epoch_fns`` through
   ``train_stage`` with K1's launch counts; space-sharded epochs
   (``make_sharded_epoch_fns(spatial=True)`` through ``train_stage``: base
   64, 512x512, batch 2, bf16, 2 epochs of 2 steps and a validation batch)
   with K3's launch counts (none of K1) and the peak memory, then
   ``parallel/spatial_check.py`` (base 64, 128x128, f32, dropout 0) against
   the unsharded epochs on the same plan;
   then the streamed path (``HostDataset`` → ``batch_iterator`` →
   ``chunk_batches`` → ``prefetch_to_device`` with pinned memory and a side
   stream → ``make_train_chunk_fn``, "pallas_adamw", base 64, bf16) with
   K1's and K2's launch counts (no K2 launch on a padding step), its f32
   run against the resident epoch on the same order, and ``d4_augment`` on
   the card's generator;
   then the conv probe (``utils/conv_probe.py``) at full width with K4's
   launch counts;
   then the measurement entry points (``drive_benches``), each through its
   ``main`` and cut in depth: ``bench`` (the headline train img/s with its
   MFU and kernel check; K1 once each way a step), ``scripts.ab_bench``
   "adamw" against "pallas_adamw" (K2 once a step), ``scripts.floor_bench``
   (the component ladder), ``scripts.serve_bench``,
   ``scripts.megapixel_bench`` (the one-card 1024x1024 step with
   ``UNet(remat=True)`` and without: equal losses, a lower peak with remat;
   K1 on the whole field) and ``scripts.sweep_bench`` (3 members, batched
   and serial); every line they print must parse;
   then the JAX repo's last entry points: ``scripts.ablation_burnin``
   (``--ablation R1`` through the CLI in fresh processes, 8/4/4+4 images,
   1+1 epochs: uninterrupted, then SIGKILLed with 1-3 of R1's 4 variant
   JSONs written and resumed with ``--resume latest``; the aggregates
   bit-equal, K1's counts as each process printed them),
   ``scripts.stream_train`` (the resident, stream-step and stream-chunk-16
   rows at 64 images, one round; K1 once each way a real step),
   ``scripts.quant_probe`` (the int8 convolution exact against float64, and
   one stage shape) and ``examples.quickstart_synthetic`` (8/4/4 images,
   1+1 epochs: finite Dice, 4 masks, K1 2 / 1);
10. time the kernels, their plain versions, the library's calls (fused
   AdamW, ``F.conv2d`` and its weight gradient) and
   steady-state Stage II training with "adamw" and "pallas_adamw", with
   CUDA events (GroupNorm's at the ResNet's largest sites, against its
   byte floor and the autocast path it replaces); K1's, K2's, K3's and
   K4's kernels and the library's calls
   also by device time per call (``torch.profiler``), which leaves the
   wrapper out and lists the device kernels a call launched (K3: one each
   way, or the script fails), and K1 and K3 in runs of queued calls;
11. print one JSON line describing every kernel, then the result line.

Needs one card, a CUDA toolkit (``nvcc``) and this repository around it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
# K3 float operations per pixel, counted from the source: the forward's
# stencils, reaction and energies per interior pixel; the backward's
# fields per interior pixel plus its gather per padded pixel
K3_FWD_FLOPS_PER_PIXEL = 28
K3_BWD_FLOPS_PER_PIXEL = 45

# K4 against its plain version.  float32: both sum the same products in
# float32 in different orders; forward rtol 1e-5 / atol 1e-5, gradients
# (sums over up to B*H*W pixels) rtol 1e-4 / atol 1e-4, the bars the JAX
# package's tests hold its TPU kernel to.  bf16: both accumulate in float32
# and round once, so they differ by at most one bf16 rounding where the
# float32 sums fall on either side of a tie: rtol 2^-7, atol 1e-2.  Against
# cuDNN in float32 without TF32: rtol 1e-4 elementwise plus 5e-5 of the
# tensor's largest magnitude.  cuDNN picks its own algorithm (Winograd, FFT,
# split sums); its deterministic weight gradient has read 1e-5 of the
# largest magnitude away from the kernel where the kernel and the plain
# float32 version were 3e-7 apart, so the bar is set by cuDNN's error.
K4_F32_FWD = (1e-5, 1e-5)
K4_F32_GRAD = (1e-4, 1e-4)
K4_BF16 = (2.0 ** -7, 1e-2)
K4_CUDNN_RTOL, K4_CUDNN_ATOL_REL = 1e-4, 5e-5
PEAK_BF16_FLOPS = 989e12
PROBE_SHAPE = (8, 128, 128, 64, 64)
PROBE_STEPS = 16

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
    """Kernel vs both plain versions at every case; returns the main-shape
    errors."""
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    cases = [
        ("train shape (8,128,128)", (8, 128, 128), {}, True),
        ("row tiling (2,512,512)", (2, 512, 512), {}, True),
        ("megapixel field (1,1024,1024)", (1, 1024, 1024), {}, True),
        ("odd size (3,17,23)", (3, 17, 23), {}, True),
        ("masked slots (4,32,32)", (4, 32, 32), {"mask": [1, 0, 1, 0]}, True),
        ("saturated u (2,16,16)", (2, 16, 16), {"saturated": True}, True),
        ("no reaction (2,64,64)", (2, 64, 64), {}, False),
        ("ends inside a tile both ways (3,130,70)", (3, 130, 70), {"mask": [1, 0, 1]}, True),
        ("W = 1000 (2,24,1000)", (2, 24, 1000), {}, True),
        ("W = 4096 (1,3,4096)", (1, 3, 4096), {}, True),
        ("unaligned rows, two tiles across (2,37,101)", (2, 37, 101), {"saturated": True}, False),
    ]
    cases += [(f"small ({b},{h},{w})", (b, h, w), {}, (h + w) % 2 == 0)
              for b, h, w in [(2, 2, 2), (1, 2, 5), (3, 3, 3), (1, 3, 4), (2, 4, 2), (1, 4, 4),
                              (1, 5, 3), (2, 5, 5), (1, 2, 130), (1, 66, 2)]]
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
        dut, dtt = K.fused_physics_sums_bwd_tiled(u, t, m, cot, D, A, EPS, use_reaction)
        print(f"K1 {label}: max|d sums| {err_s:.3e}, max|d du| {err_du:.3e} "
              f"(max|du| {float(dup.abs().max()):.3e}), max|d dt| {err_dt:.3e}; against the "
              f"tile-wise plain backward {float((duk - dut).abs().max()):.3e}, "
              f"{float((dtk - dtt).abs().max()):.3e}")
        check(sum_ok, f"{label}: forward sums differ beyond rtol {SUM_RTOL}")
        check(grad_ok(duk, dup), f"{label}: du differs beyond tolerance")
        check(grad_ok(dtk, dtp), f"{label}: dt differs beyond tolerance")
        check(grad_ok(duk, dut) and grad_ok(dtk, dtt),
              f"{label}: du or dt differs from the tile-wise plain backward")
        if "mask" in kw:
            dead = torch.tensor(kw["mask"], device=u.device) == 0
            check(bool((duk[dead] == 0).all() and (dtk[dead] == 0).all()),
                  "masked slots must get exactly zero gradient")
        # without dt: the same du to the bit, and nothing in dt's place
        du_only, none = K._launch_bwd(u, t, m, cot, D, A, EPS, use_reaction, need_dt=False)
        check(none is None and torch.equal(du_only, duk), f"{label}: du changes without dt")
        # no float atomics: the same inputs give the same bits
        again = kernel_and_plain(u, t, m, cot, use_reaction)["kernel"]
        check(all(torch.equal(a, b) for a, b in zip(again, res["kernel"])),
              f"{label}: the kernels do not repeat bit for bit")
        if i == 0:
            errors = {"physics_sums_fwd": err_s, "physics_sums_bwd": max(err_du, err_dt)}
    check_kernels_in_a_graph()
    return errors


def check_kernels_in_a_graph() -> None:
    """K1 forward and backward captured in one CUDA graph and replayed on
    three inputs: bit-equal to the eager calls.  The forward's ticket is
    part of no memset, so this shows that the last block sets it back."""
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    args = (D, A, EPS, True)
    for shape in ((8, 128, 128), (3, 130, 70)):
        u, t, m, cot = make_case(shape, seed=200)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            K._launch_fwd(u, t, m, *args)  # the stream's workspace is made outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            sums = K._launch_fwd(u, t, m, *args)
            du, dt = K._launch_bwd(u, t, m, cot, *args, need_dt=True)
        for seed in (201, 202, 203):
            fresh = make_case(shape, seed=seed)
            for held, new in zip((u, t, m, cot), fresh):
                held.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            replayed = (sums.clone(), du.clone(), dt.clone())
            eager = (K._launch_fwd(*fresh[:3], *args),
                     *K._launch_bwd(*fresh, *args, need_dt=True))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(replayed, eager)),
                  f"K1 replayed in a CUDA graph at {shape} differs from the eager call")
        print(f"K1 forward + backward in a CUDA graph at {shape}: 3 replays on fresh inputs "
              f"bit-equal to the eager calls")


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
    check_adamw_plan()
    return main_err


def check_adamw_plan() -> None:
    """K2's plan at the U-Net's shapes: built at the first step, kept over
    steps with fresh gradient tensors, made anew when a parameter tensor is
    replaced (the old tensor is left alone), bit-equal to the plain AdamW
    all the way."""
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2
    from physics_informed_image_segmentation_tpu_torch.train.optim import AdamW

    params, grads = adamw_case(unet_param_shapes(), seed=30)
    kernel = K2.FusedAdamW([p.clone() for p in params], 1e-4, 1e-5)
    plain = AdamW([p.clone() for p in params], 1e-4, 1e-5)
    plans = []
    for gs in grads + grads[:1]:
        kernel.step([g.clone() for g in gs])
        plain.step(gs)
        plans.append(kernel._plan)
    check(all(p is plans[0] for p in plans), "K2 built a new plan though no tensor changed")
    check(adamw_diff(kernel, plain) == 0.0, "K2 with a kept plan is not bit-equal")
    old = kernel.params[3]
    kept = old.clone()
    kernel.params[3] = old.clone()
    check(not plans[0].matches(kernel.params, kernel.m, kernel.v), "a stale plan still matches")
    for gs in grads[1:]:
        kernel.step([g.clone() for g in gs])
        plain.step(gs)
    torch.cuda.synchronize()
    check(kernel._plan is not plans[0], "K2 kept its plan though a parameter was replaced")
    check(torch.equal(old, kept), "K2 updated a tensor that is no longer a parameter")
    check(adamw_diff(kernel, plain) == 0.0, "K2 after a replaced parameter is not bit-equal")
    print(f"K2 plan: kept over {len(plans)} steps with fresh gradient tensors, made anew after a "
          f"parameter tensor was replaced; {kernel.count} steps bit-equal to the plain AdamW")


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


def drive_main_path(keep_model: Path) -> dict:
    """The port's train() at full width; returns its K1 launch counts and
    copies the Stage II ``.pth`` it wrote to ``keep_model``."""
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
        shutil.copyfile(res["pde_model"], keep_model)

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


# Serving.  A Predictor's answers against the same bf16 model called
# directly on the same padded chunks, and predict_device against predict:
# the same arithmetic, so equal bits are expected; 2e-3 on probabilities
# allows a bf16 rounding to flip should cuDNN pick another algorithm for a
# call, and is far below the difference between two images.  Against the
# float32 forward (TF32 off): 5e-2, the rounding of bf16 (8 bits) through
# the U-Net's 23 layers.
# tta on a symmetric input: its 8 views are one image, so the mean of the
# 8 predictions moved back is symmetric as far as those predictions are
# equal; they sit at different places of one 8B-image batch, where cuDNN's
# bf16 results have read up to a rounding of the logit apart (4.7e-5 on the
# probability): 5e-4.
SERVE_SAME_ATOL = 2e-3
SERVE_TTA_ATOL = 5e-4
SERVE_BF16_ATOL = 5e-2


def drive_serving(model_path: Path) -> dict:
    """Serving at full width: a ``Predictor`` (base 64, bf16, 128x128,
    batch 8) on the ``.pth`` that the smoke ``train()`` wrote; returns the
    images per second of ``predict_device``."""
    from physics_informed_image_segmentation_tpu_torch import UNet
    from physics_informed_image_segmentation_tpu_torch.data import make_blobs
    from physics_informed_image_segmentation_tpu_torch.serve import Predictor
    from physics_informed_image_segmentation_tpu_torch.train.checkpoint import load_params

    p = Predictor(model_path)
    check(p.device.type == "cuda" and p.dtype == torch.bfloat16 and p.batch_size == 8,
          "the Predictor's defaults are not the card, bf16 and batch 8")
    images = make_blobs(20, 128, 128, seed=21)[0]
    probs = p.predict(images)  # 20 = two chunks and a padded one
    check(probs.shape == (20, 128, 128, 1) and probs.dtype == np.float32, f"predict {probs.shape}")
    check(bool(np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()),
          "predict left (0, 1)")

    model = load_params(model_path, UNet(base_channels=64)).cuda().eval()
    x = torch.as_tensor(images, device="cuda").permute(0, 3, 1, 2)
    with torch.no_grad():
        with deterministic_f32():
            ref32 = model(x).permute(0, 2, 3, 1).cpu().numpy()
        model.to(torch.bfloat16)
        padded = torch.cat([x, torch.zeros_like(x[:4])]).to(torch.bfloat16)
        ref16 = torch.cat([model(padded[i:i + 8]) for i in (0, 8, 16)])[:20]
        ref16 = ref16.permute(0, 2, 3, 1).cpu().numpy()
    d16, d32 = float(np.abs(probs - ref16).max()), float(np.abs(probs - ref32).max())
    print(f"Predictor.predict on 20 images (base 64, bf16, 128x128, batch 8): max|d| against the "
          f"bf16 model called directly {d16:.3e}, against its float32 forward {d32:.3e}; "
          f"probabilities in [{probs.min():.4f}, {probs.max():.4f}]")
    check(d16 <= SERVE_SAME_ATOL, f"predict differs from the model's own bf16 forward by {d16}")
    check(d32 <= SERVE_BF16_ATOL, f"predict differs from the float32 forward by {d32}")
    masks = p.predict(images, threshold=0.5)
    check(bool(np.array_equal(masks, (probs > 0.5).astype(np.float32))), "threshold is not '>'")

    # the largest of the 8 views: symmetric to the bit, whatever the order
    sym = images[:3]
    sym = np.maximum(np.maximum(sym, sym[:, ::-1]), np.maximum(sym[:, :, ::-1], sym[:, ::-1, ::-1]))
    sym = np.maximum(sym, sym.transpose(0, 2, 1, 3))
    tta = p.predict(sym, tta=True)
    asym = max(float(np.abs(tta - tta[:, ::-1]).max()), float(np.abs(tta - tta[:, :, ::-1]).max()),
               float(np.abs(tta - tta.transpose(0, 2, 1, 3)).max()))
    print(f"tta on a symmetric input: largest asymmetry of the output {asym:.3e}")
    check(tta.shape == (3, 128, 128, 1) and asym <= SERVE_TTA_ATOL,
          f"tta output is not symmetric: {asym}")

    many = make_blobs(64, 128, 128, seed=22)[0]
    on_card = torch.as_tensor(many, device="cuda")
    dev = p.predict_device(on_card)
    check(isinstance(dev, torch.Tensor) and dev.is_cuda and dev.shape == (64, 128, 128, 1)
          and dev.dtype == torch.float32, "predict_device must return a float32 device tensor")
    dd = float(np.abs(dev.cpu().numpy() - p.predict(many)).max())
    print(f"predict_device on 64 device-resident images against predict: max|d| {dd:.3e}")
    check(dd <= SERVE_SAME_ATOL, f"predict_device differs from predict by {dd}")

    big = make_blobs(1, 512, 512, seed=23)[0][0]
    tiled = p.predict_tiled(big)
    check(tiled.shape == (512, 512, 1) and bool(np.isfinite(tiled).all()),
          f"predict_tiled returned {tiled.shape}")
    print(f"predict_tiled on 512x512 (25 tiles of 128, overlap 32): probabilities in "
          f"[{tiled.min():.4f}, {tiled.max():.4f}]")

    rates = []
    for i in range(6):  # the first run is warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.predict_device(on_card)
        torch.cuda.synchronize()
        if i > 0:
            rates.append(64 / (time.perf_counter() - t0))
    rate = statistics.median(rates)
    print(f"predict_device: {rate:.1f} img/s (median of {len(rates)} runs over 64 device-resident "
          f"images; base 64, 128x128, batch 8, bf16)")
    return {"predict_device_img_per_s": rate, "runs": rates}


def _finite_dice(metrics: dict, n: int, where: str) -> None:
    dice = np.asarray(metrics["dice_scores"], np.float64)
    check(dice.shape == (n,) and bool(np.isfinite(dice).all()), f"{where}: dice {dice}")


def _stage_rows(path: Path) -> list:
    import csv

    check(path.exists(), f"{path.name} missing")
    with open(path, newline="") as f:
        rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    check(len(rows) >= 1, f"{path.name} is empty")
    for row in rows:
        check(all(np.isfinite(v) for v in row.values()), f"{path.name}: non-finite row {row}")
    return rows


# result keys of the JAX package's run_ablation_variant (three stages and
# one stage) and of its study JSON
THREE_STAGE_KEYS = {
    "config", "model_path", "pde_model_path", "baseline_model_path", "baseline_in_dist_metrics",
    "baseline_out_dist_metrics", "pde_in_dist_metrics", "pde_out_dist_metrics",
    "stage3_in_dist_metrics", "stage3_out_dist_metrics", "metrics", "in_dist_metrics",
    "out_dist_metrics", "stage_comparison"}
SINGLE_STAGE_KEYS = {"config", "model_path", "in_dist_metrics", "out_dist_metrics", "metrics"}
STUDY_KEYS = {"ablation_name", "variants", "num_runs", "results", "aggregated_results",
              "aggregated_results_in_dist", "aggregated_results_out_dist"}


@contextlib.contextmanager
def quiet():
    """Hold the experiment layer's own report (hundreds of lines a study) in
    a buffer, and write its end to stderr if the block fails."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    except BaseException:
        sys.stderr.write(buf.getvalue()[-20000:])
        raise


def drive_experiments(smi: str, device: str = "cuda", base_channels: int = 64,
                      size: int = 128) -> dict:
    """The experiment layer at full width (base 64, 128x128, batch 8, bf16):
    a two-variant study (R1.0, and R1.3 with the Stage III control, one
    epoch a stage) with K1's launch counts, the same study resumed, the
    pair and pooled comparisons on its checkpoints, and the ``run_ablation``
    and ``evaluate`` CLIs on a synthetic COCO layout.  Returns the seconds
    of each stage and the launch counts."""
    import dataclasses

    from physics_informed_image_segmentation_tpu_torch import evaluate as evaluate_cli
    from physics_informed_image_segmentation_tpu_torch import run_ablation as ablation_cli
    from physics_informed_image_segmentation_tpu_torch.data import (
        DeviceDataset, make_blobs, write_synthetic_coco)
    from physics_informed_image_segmentation_tpu_torch.experiments import (
        ablation, evaluate_and_compare, run_ablation_study, run_repeated_evaluations, studies)
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    n = {"train": 32, "val": 8, "in_dist": 8, "out_dist": 8}
    batch = 8
    data = {}
    for i, (split, count) in enumerate(n.items()):
        images, masks = make_blobs(count, size, size, seed=30 + i)
        data[split] = DeviceDataset.from_numpy(images, masks, device)
    baseline = studies.define_ablation_r1()[0]
    three = dataclasses.replace(studies.define_ablation_r1()[3], use_three_stage=True,
                                stage1_epochs=1, stage2_epochs=1, stage3_epochs=1)
    common = dict(datasets=data, batch_size=batch, stage1_epochs=1, stage2_epochs=1,
                  precision="bf16", base_channels=base_channels, device=device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # seconds of each stage and of each evaluation of the first study,
    # through the names the variant runner calls
    seconds: dict = {}

    def timed(fn, label):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            seconds.setdefault(kwargs.get("stage_name", label), []).append(
                time.perf_counter() - t0)
            return out
        return run

    scratch = REPO / "build"  # git-ignored
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        real_train_stage, real_evaluate = ablation.train_stage, ablation.evaluate_model
        ablation.train_stage = timed(real_train_stage, "stage")
        ablation.evaluate_model = timed(real_evaluate, "evaluate (one model, one test set)")
        try:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with quiet():
                study = run_ablation_study("R1", [baseline, three], output_dir=tmp, **common)
            sync()
            study_s = time.perf_counter() - t0
            counts = dict(K.launch_counts)
        finally:
            ablation.train_stage, ablation.evaluate_model = real_train_stage, real_evaluate
        steps, val_batches = -(-n["train"] // batch), -(-n["val"] // batch)
        print(f"ablation study (R1.0 and a three-stage R1.3, base {base_channels}, "
              f"{size}x{size}, batch {batch}, bf16, one epoch a stage): {study_s:.2f} s; "
              f"K1 launches {counts}")
        check(counts["physics_sums_fwd"] == steps + val_batches,
              f"expected {steps + val_batches} K1 forward launches on the ablation path, "
              f"got {counts['physics_sums_fwd']}")
        check(counts["physics_sums_bwd"] == steps,
              f"expected {steps} K1 backward launches on the ablation path, "
              f"got {counts['physics_sums_bwd']}")

        folder = Path(study["ablation_folder"])
        b_stem, t_stem = ablation._snake(baseline.name), ablation._snake(three.name)
        _stage_rows(folder / f"{b_stem}_stage2_metrics.csv")
        for stage in ("stage1", "stage2", "stage3"):
            rows = _stage_rows(folder / f"{t_stem}_{stage}_metrics.csv")
            check(len(rows) == 1, f"{t_stem} {stage} ran {len(rows)} epochs, expected 1")
        row = _stage_rows(folder / f"{t_stem}_stage2_metrics.csv")[0]
        check(row["train_pde_loss"] > 0 and row["val_pde_loss"] > 0,
              "Stage II pde_loss must be positive")
        names = [f"{b_stem}_{baseline.seed}.pth", f"{b_stem}_results.json",
                 f"{t_stem}_baseline_after_stage1.pth", f"{t_stem}_after_pde_stage2.pth",
                 f"{t_stem}_after_stage3.pth", f"{t_stem}_results.json"]
        names += [f"{t_stem}_{pair}_comparison_{dist}.csv"
                  for pair in ("stage1_vs_stage2", "stage1_vs_stage3", "stage2_vs_stage3")
                  for dist in ("in_dist", "out_dist")]
        for key in ("results_json", "summary_csv", "summary_csv_in_dist",
                    "summary_csv_out_dist"):
            names.append(Path(study[key]).name)
        missing = [name for name in names if not (folder / name).exists()]
        check(not missing, f"the study did not write {missing}")

        results = json.loads(Path(study["results_json"]).read_text())
        check(set(results) == STUDY_KEYS, f"study JSON keys {sorted(results)}")
        by_name = {r["config"]["name"]: r for r in results["results"]}
        check(set(by_name[baseline.name]) == SINGLE_STAGE_KEYS,
              f"single-stage result keys {sorted(by_name[baseline.name])}")
        res3 = by_name[three.name]
        check(set(res3) == THREE_STAGE_KEYS, f"three-stage result keys {sorted(res3)}")
        check(set(res3["stage_comparison"]) ==
              {"stage1_vs_stage2", "stage1_vs_stage3", "stage2_vs_stage3"},
              f"stage_comparison keys {sorted(res3['stage_comparison'])}")
        for name, res in by_name.items():
            for key in (k for k in res if k.endswith("_metrics") or k == "metrics"):
                size_n = n["out_dist"] if "out_dist" in key else n["in_dist"]
                _finite_dice(res[key], size_n, f"{name} {key}")

        K.reset_launch_counts()
        with quiet():
            resumed = run_ablation_study("R1", [baseline, three], output_dir=tmp,
                                         resume_from=folder, **common)
        check(K.launch_counts == {"physics_sums_fwd": 0, "physics_sums_bwd": 0},
              f"the resumed study launched K1: {K.launch_counts}")
        # as JSON text: a Hausdorff distance of an empty prediction is NaN
        check(json.dumps(resumed["aggregated_results"], sort_keys=True)
              == json.dumps(study["aggregated_results"], sort_keys=True),
              "the resumed study's aggregate differs from the first run's")
        check(resumed["ablation_folder"] == str(folder), "the resumed study moved folder")
        print("ablation study resumed from its folder: the same aggregate, no K1 launch")

        pair = (folder / f"{t_stem}_baseline_after_stage1.pth",
                folder / f"{t_stem}_after_pde_stage2.pth")
        t0 = time.perf_counter()
        with quiet():
            cmp = evaluate_and_compare(*pair, None, None, batch_size=batch,
                                       output_dir=tmp / "compare", test_data=data["in_dist"],
                                       base_channels=base_channels, device=device)
        compare_s = time.perf_counter() - t0
        for key in ("baseline_metrics", "pde_metrics"):
            _finite_dice(cmp[key], n["in_dist"], f"evaluate_and_compare {key}")
        for key in ("results_csv", "summary_csv", "comparison_json"):
            check(Path(cmp[key]).exists(), f"evaluate_and_compare did not write {key}")
        check(set(cmp["comparison_results"]) == set(res3["in_dist_metrics"]),
              "evaluate_and_compare compared other metrics")
        with quiet():
            rep = run_repeated_evaluations(
                [pair[0], pair[0]], [pair[1], folder / f"{t_stem}_after_stage3.pth"], None,
                None, batch_size=batch, output_dir=tmp / "repeated",
                test_data=data["out_dist"], base_channels=base_channels, device=device)
        _finite_dice(rep["pde_metrics"], 2 * n["out_dist"], "run_repeated_evaluations")
        check(Path(rep["aggregated_csv"]).exists(), "no aggregated_results CSV")
        print(f"evaluate_and_compare on the three-stage variant's Stage I and II "
              f"checkpoints: {compare_s:.2f} s; dice p (t-test) "
              f"{cmp['comparison_results']['dice_scores']['t_pvalue']:.4f}")

        # the CLIs on a synthetic COCO layout of their default paths
        coco = tmp / "coco"
        for i, split in enumerate(("training", "validation", "in_dist_testing",
                                   "out_dist_testing")):
            img_dir, ann = write_synthetic_coco(coco / "tmp" / split, n=8, height=size,
                                                width=size, seed=40 + i)
            (coco / "images" / "annotation").mkdir(parents=True, exist_ok=True)
            shutil.move(str(img_dir), coco / "images" / split)
            shutil.move(str(ann), coco / "images" / "annotation" / f"{split}_annotation.json")
        cwd = os.getcwd()
        os.chdir(coco)
        try:
            with quiet():
                t0 = time.perf_counter()
                ablation_cli.main(["--ablation", "R1", "--stage1-epochs", "1",
                                   "--stage2-epochs", "1", "--base-channels", str(base_channels),
                                   "--device", device])
                cli_s = time.perf_counter() - t0
                (cli_folder,) = (coco / "output" / "ablation").glob("R1_*")
                check(len(list(cli_folder.glob("*_results.json"))) == 4,
                      "run_ablation R1 did not finish its four variants")
                stem = "r1.3_rd_+_phase-field"
                cli_pair = [str(cli_folder / f"{stem}_baseline_after_stage1.pth"),
                            str(cli_folder / f"{stem}_after_pde_stage2.pth")]
                test = ["--test-dir", "images/in_dist_testing", "--test-json",
                        "images/annotation/in_dist_testing_annotation.json",
                        "--base-channels", str(base_channels), "--device", device]
                evaluate_cli.main(["--baseline", cli_pair[0], "--pde", cli_pair[1],
                                   "--output-dir", "pair", *test])
                evaluate_cli.main(["--baseline", str(cli_folder / "*_baseline_after_stage1.pth"),
                                   "--pde", str(cli_folder / "*_after_pde_stage2.pth"),
                                   "--repeated", "--output-dir", "repeated", *test])
                evaluate_cli.main(["--model-path", cli_pair[1], "--output-dir", "single", *test])
        finally:
            os.chdir(cwd)
        check(len(list((coco / "pair").glob("*"))) == 3, "evaluate (pair) files missing")
        check(len(list((coco / "repeated").glob("aggregated_results_*.csv"))) == 1,
              "evaluate --repeated wrote no aggregated CSV")
        single = json.loads((coco / "single" / f"single_model_metrics_{stem}_after_pde_stage2"
                             ".json").read_text())
        _finite_dice({"dice_scores": single["dice_scores"]["per_image"]}, 8,
                     "evaluate --model-path")
        print(f"run_ablation --ablation R1 (8 images a split, one epoch a stage): "
              f"{cli_s:.2f} s; evaluate: pair, --repeated and --model-path")
    return {"study_s": study_s, "stage_s": seconds, "k1_launches": counts,
            "evaluate_and_compare_s": compare_s, "run_ablation_cli_s": cli_s, "card": smi}


# The batched sweep (experiments/sweep.py).  K1 against the plain physics
# on the sweep path: the batched code with physics_backend="cuda" against
# "torch", float32 without TF32 and with deterministic cuDNN; the physics
# sums (rtol 1e-5 apart) are the only difference, and two epochs carry it
# into the histories: rtol 1e-4.  The stack against the serial variant
# runner: float32, dropout 0, S1's lr of 1e-4, patience 3, up to eight
# Stage II epochs of three steps (the members stop at the fourth).  A
# convolution over stacked weights rounds differently from one model's,
# and AdamW's normalised step turns that rounding into up to a fraction of
# the learning rate wherever a gradient is near 0, so: the stop epochs
# equal; the stage rows' losses rtol 1e-4 and their thresholded scores
# atol 1e-3 (a few of 128x128 pixels); each member's parameters within 5%
# of its own Stage II movement, max |serial - Stage I| (a member whose
# gradient was dropped misses by all of it, one frozen a step early or
# late by about a twelfth).  S1's members 0 and 4 end within that rounding of each
# other in their parameters, so the parameters cannot tell the two apart;
# their pde_loss columns can (a = 0.3 against 0.7): each batched member's
# must lie further than 10 times the rows' rtol from the other serial
# member's, so that losses routed to the wrong member would fail.
SWEEP_HISTORY_RTOL = 1e-4
SWEEP_ROWS_RTOL = 1e-4
SWEEP_SCORE_ATOL = 1e-3
SWEEP_SERIAL_REL = 5e-2
SWEEP_TIMING_EPOCHS = 4  # 80 images at batch 8: 40 Stage II steps a side and turn


@contextlib.contextmanager
def dropout_off(*modules):
    """Build the U-Nets of ``modules`` (which import ``UNet`` by name)
    without dropout."""
    from physics_informed_image_segmentation_tpu_torch.models import UNet

    saved = [m.UNet for m in modules]
    for m in modules:
        m.UNet = lambda **kw: UNet(**{**kw, "dropout": 0.0})
    try:
        yield
    finally:
        for m, unet in zip(modules, saved):
            m.UNet = unet


def drive_sweep(smi: str) -> dict:
    """The batched sensitivity sweep on the card: S1's five members through
    ``run_batched_study`` at full width (base 64, 128x128, batch 8, bf16,
    80 training images so that S1's 10% is one batch; Stage I one epoch,
    Stage II two) with K1's launch counts on the sweep path; the batched
    Stage II against the five serial Stage II runs, timed in paired turns
    over 40 steps a side, with the peak device memory of each; at base 8 in
    float32 the sweep with K1 against the plain physics, and members 0 and
    4 against the serial variant runner; ``run_ablation --ablation S1
    --batched`` on a synthetic COCO layout."""
    from physics_informed_image_segmentation_tpu_torch import run_ablation as ablation_cli
    from physics_informed_image_segmentation_tpu_torch.data import (
        DeviceDataset, fold_seed, make_blobs, subset_fraction_indices, write_synthetic_coco)
    from physics_informed_image_segmentation_tpu_torch.experiments import (
        ablation, create_ablation_loss_config, run_batched_study, studies, sweep,
        sweep_scalars_from_variants)
    from physics_informed_image_segmentation_tpu_torch.models import UNet
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K
    from physics_informed_image_segmentation_tpu_torch.train.engine import (
        create_train_state, make_eval_epoch_fn, make_train_epoch_fn, train_stage)

    size, batch = 128, 8
    n = {"train": 80, "val": 8, "in_dist": 8, "out_dist": 8}
    data = {}
    for i, (split, count) in enumerate(n.items()):
        images, masks = make_blobs(count, size, size, seed=50 + i)
        data[split] = DeviceDataset.from_numpy(images, masks, "cuda")
    s1 = studies.define_ablation_s1()
    m_count = len(s1)
    common = dict(batch_size=batch, stage1_epochs=1, stage2_epochs=2, precision="bf16",
                  base_channels=64, device="cuda")

    scratch = REPO / "build"  # git-ignored
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with quiet():
            study = run_batched_study("S1", s1, datasets=data, output_dir=tmp / "batched",
                                      **common)
        torch.cuda.synchronize()
        study_s = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        steps = -(-int(n["train"] * s1[0].train_fraction) // batch)
        val_batches = -(-n["val"] // batch)
        epochs = common["stage2_epochs"]
        print(f"batched S1 study ({m_count} members, base 64, {size}x{size}, batch {batch}, "
              f"bf16, Stage I 1 epoch, Stage II {epochs}): {study_s:.2f} s; "
              f"K1 launches {counts}")
        want_fwd, want_bwd = m_count * epochs * (steps + val_batches), m_count * epochs * steps
        check(counts == {"physics_sums_fwd": want_fwd, "physics_sums_bwd": want_bwd},
              f"expected {want_fwd} / {want_bwd} K1 launches on the sweep path, got {counts}")
        folder = Path(study["ablation_folder"])
        results = json.loads(Path(study["results_json"]).read_text())
        check(results["batched"] is True and set(results) == STUDY_KEYS | {"batched"},
              f"batched study JSON keys {sorted(results)}")
        check(study["stop_epochs"] == [epochs] * m_count, f"stop epochs {study['stop_epochs']}")
        for variant, res in zip(s1, results["results"]):
            stem = ablation._snake(variant.name)
            rows = _stage_rows(folder / f"{stem}_stage2_metrics.csv")
            check(len(rows) == epochs and all(r["train_pde_loss"] > 0 for r in rows),
                  f"{stem}: Stage II rows {rows}")
            check((folder / f"{stem}_after_pde_stage2.pth").exists(), f"{stem}: no .pth")
            for dist in ("in_dist", "out_dist"):
                _finite_dice(res[f"{dist}_metrics"], n[dist], f"{variant.name} {dist}")
        _stage_rows(folder / "shared_stage1_metrics.csv")

        # Stage II from the shared Stage I weights on all 80 training
        # images, batched and as five serial runs, in turns: seconds, and
        # the peak device memory above what was allocated before
        init = torch.load(folder / "shared_baseline_after_stage1.pth", weights_only=True)
        seed = s1[0].seed
        timing = dict(num_epochs=SWEEP_TIMING_EPOCHS, batch_size=batch, learning_rate=1e-4,
                      precision="bf16")

        def batched_turn():
            return sweep.run_batched_sweep(
                UNet(base_channels=64), init, sweep_scalars_from_variants(s1), data["train"],
                data["val"], early_stopping_patience=SWEEP_TIMING_EPOCHS,
                shuffle_seed=fold_seed(seed, 2), seed=seed + 2, device="cuda", **timing)

        def serial_turn():
            for variant in s1:
                model = UNet(base_channels=64).cuda()
                model.load_state_dict(init)
                cfg = create_ablation_loss_config(variant, "auto")
                train_stage(create_train_state(model, timing["learning_rate"],
                                               dropout_seed=seed + 2),
                            make_train_epoch_fn(cfg, precision="bf16"),
                            make_eval_epoch_fn(cfg, precision="bf16"), data["train"],
                            data["val"], batch_size=batch, num_epochs=SWEEP_TIMING_EPOCHS,
                            stage_name="Stage II (PDE)", shuffle_seed=fold_seed(seed, 2),
                            early_stopping=None, verbose=False)

        turns = {"batched": [], "serial": []}
        peak = {}
        for name in ("batched", "serial", "serial", "batched"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with quiet():
                (batched_turn if name == "batched" else serial_turn)()
            torch.cuda.synchronize()
            turns[name].append(time.perf_counter() - t0)
            peak[name] = torch.cuda.max_memory_allocated() - before
        n_params = sum(p.numel() for p in UNet(base_channels=64).parameters())
        state = {"batched": 4 * m_count * n_params * 4, "serial": 4 * n_params * 4}
        stage2 = {"member_steps_a_side": SWEEP_TIMING_EPOCHS * -(-n["train"] // batch) * m_count,
                  "batched_s": turns["batched"], "serial_sum_s": turns["serial"],
                  "peak_bytes_above_start": peak,
                  "param_grad_moment_bytes": state}
        gib = 2 ** 30
        print(f"S1 Stage II, base 64, {size}x{size}, bf16, batch {batch}, "
              f"{SWEEP_TIMING_EPOCHS} epochs of {-(-n['train'] // batch)} steps and "
              f"{val_batches} validation batch, turns batched/serial/serial/batched: batched "
              f"{', '.join(f'{t:.3f}' for t in turns['batched'])} s ({m_count} members in "
              f"one stack), serial {', '.join(f'{t:.3f}' for t in turns['serial'])} s (sum of "
              f"{m_count} runs); peak device memory above the start: batched "
              f"{peak['batched'] / gib:.3f} GiB (parameters, gradients and moments "
              f"{state['batched'] / gib:.3f}), one serial run {peak['serial'] / gib:.3f} GiB "
              f"({state['serial'] / gib:.3f}); {smi}")

        # float32 at base 8: K1 against the plain physics on the sweep path
        np.random.seed(seed)
        train_sub = data["train"].select(subset_fraction_indices(n["train"],
                                                                 s1[0].train_fraction))
        f32 = dict(num_epochs=epochs, batch_size=batch, learning_rate=1e-4, precision="f32",
                   device="cuda")
        with deterministic_f32():
            init8 = UNet(base_channels=8, dropout=0.0,
                         generator=torch.Generator().manual_seed(0)).state_dict()
            histories = [sweep.run_batched_sweep(
                UNet(base_channels=8, dropout=0.0), init8, sweep_scalars_from_variants(s1),
                train_sub, data["val"], physics_backend=backend, **f32)["history"]
                for backend in ("cuda", "torch")]
        history_rel = 0.0
        for key, ref in histories[1].items():
            np.testing.assert_allclose(histories[0][key], ref, rtol=SWEEP_HISTORY_RTOL,
                                       err_msg=f"sweep history {key}, K1 against plain")
            ref = np.asarray(ref, np.float64)
            diff = np.abs(np.asarray(histories[0][key], np.float64) - ref)
            history_rel = max(history_rel, float(np.max(diff / np.maximum(np.abs(ref), 1e-30))))

        # float32 at base 8, dropout 0: members 0 and 4 against the serial
        # variant runner, on 240 training images (S1's 10%: three steps)
        images, masks = make_blobs(240, size, size, seed=70)
        data8 = dict(data, train=DeviceDataset.from_numpy(images, masks, "cuda"))
        small = dict(batch_size=batch, stage1_epochs=1, stage2_epochs=8, learning_rate=1e-4,
                     early_stopping_patience=3, precision="f32", base_channels=8,
                     device="cuda")
        members = (0, m_count - 1)
        with deterministic_f32(), dropout_off(sweep, ablation), quiet():
            f32_study = run_batched_study("S1", s1, datasets=data8, output_dir=tmp / "f32",
                                          **small)
            serial = {m: ablation.run_ablation_variant(s1[m], datasets=data8,
                                                       ablation_folder=tmp / "f32_serial",
                                                       **small)
                      for m in members}
        f32_folder = Path(f32_study["ablation_folder"])
        stage1 = torch.load(f32_folder / "shared_baseline_after_stage1.pth", weights_only=True)
        stops = [f32_study["stop_epochs"][m] for m in members]
        rows, serial_rows, gap, move = {}, {}, {}, {}
        for m in members:
            stem = ablation._snake(s1[m].name)
            rows[m] = _stage_rows(f32_folder / f"{stem}_stage2_metrics.csv")
            serial_rows[m] = _stage_rows(tmp / "f32_serial" / f"{stem}_stage2_metrics.csv")
            ours = torch.load(f32_folder / f"{stem}_after_pde_stage2.pth", weights_only=True)
            ref = torch.load(serial[m]["pde_model_path"], weights_only=True)
            gap[m] = max(float((ours[k] - ref[k]).abs().max()) for k in ref)
            move[m] = max(float((ref[k] - stage1[k]).abs().max()) for k in ref)
            check(len(rows[m]) == len(serial_rows[m]) == stops[members.index(m)],
                  f"member {m}: batched stopped at {stops[members.index(m)]} "
                  f"({len(rows[m])} rows), serial after {len(serial_rows[m])}")

        def rel(m, other, columns):
            return max(abs(row[k] - ref_row[k]) / max(abs(ref_row[k]), 1e-30)
                       for row, ref_row in zip(rows[m], serial_rows[other]) for k in columns)

        scores = [k for k in serial_rows[0][0] if k.endswith("_score")]
        losses = [k for k in serial_rows[0][0] if k.endswith("_loss")]
        pde = [k for k in losses if "pde" in k]  # the phase-field energy does not read a
        loss_rel = max(rel(m, m, losses) for m in members)
        score_err = max(abs(row[k] - ref_row[k]) for m in members
                        for row, ref_row in zip(rows[m], serial_rows[m]) for k in scores)
        cross_rel = min(rel(m, other, pde) for m, other in (members, members[::-1]))
        print(f"sweep at base 8, f32: K1 against the plain physics, histories max rel diff "
              f"{history_rel:.3e}; members {members} against serial variants (dropout 0, "
              f"lr 1e-4, stop epochs {stops} of {small['stage2_epochs']}): losses max rel diff "
              f"{loss_rel:.3e} (bar {SWEEP_ROWS_RTOL}), scores max abs diff {score_err:.3e} "
              f"(bar {SWEEP_SCORE_ATOL}), pde columns against the other member's "
              f"{cross_rel:.3e}; max |dparam| {[f'{gap[m]:.3e}' for m in members]} against "
              f"their own Stage II movement {[f'{move[m]:.3e}' for m in members]} "
              f"(bar {SWEEP_SERIAL_REL} of it)")
        check(min(stops) < small["stage2_epochs"], f"no member stopped early: {stops}")
        check(loss_rel <= SWEEP_ROWS_RTOL, f"batched losses against serial: {loss_rel:.3e}")
        check(score_err <= SWEEP_SCORE_ATOL, f"batched scores against serial: {score_err:.3e}")
        check(cross_rel > 10 * SWEEP_ROWS_RTOL,
              f"members {members}' pde columns only {cross_rel:.3e} apart")
        check(all(gap[m] <= SWEEP_SERIAL_REL * move[m] for m in members),
              f"batched members against serial: max |dparam| {gap} against their movement "
              f"{move}")

        # run_ablation --batched on a synthetic COCO layout (10% of 20 images)
        coco = tmp / "coco"
        counts_cli = {"training": 20, "validation": 4, "in_dist_testing": 4,
                      "out_dist_testing": 4}
        for i, (split, count) in enumerate(counts_cli.items()):
            img_dir, ann = write_synthetic_coco(coco / "tmp" / split, n=count, height=size,
                                                width=size, seed=60 + i)
            (coco / "images" / "annotation").mkdir(parents=True, exist_ok=True)
            shutil.move(str(img_dir), coco / "images" / split)
            shutil.move(str(ann), coco / "images" / "annotation" / f"{split}_annotation.json")
        cwd = os.getcwd()
        os.chdir(coco)
        try:
            t0 = time.perf_counter()
            with quiet():
                ablation_cli.main(["--ablation", "S1", "--batched", "--stage1-epochs", "1",
                                   "--stage2-epochs", "1", "--base-channels", "64"])
            cli_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        (cli_folder,) = (coco / "output" / "ablation").glob("S1_*")
        cli_json = json.loads((cli_folder / f"ablation_{cli_folder.name}.json").read_text())
        check(cli_json["batched"] is True and len(cli_json["results"]) == m_count,
              "run_ablation --batched did not write its batched results")
        check(len(list(cli_folder.glob("*_after_pde_stage2.pth"))) == m_count,
              "run_ablation --batched did not write every member's model")
        print(f"run_ablation --ablation S1 --batched (20 training images): {cli_s:.2f} s")
    return {"study_s": study_s, "k1_launches": counts, "stage2": stage2,
            "history_max_rel_diff": history_rel, "serial_stop_epochs": stops,
            "serial_loss_max_rel_diff": loss_rel, "serial_score_max_abs_diff": score_err,
            "serial_pde_columns_apart": cross_rel, "serial_max_abs_dparam": gap,
            "serial_movement": move, "run_ablation_batched_cli_s": cli_s, "card": smi}


# The reference-name surface (compat.py).  The compat loss through K1
# against the same class on its plain path (CPU tensors): K1's bars, sums
# (here the loss) rtol 1e-5, gradients atol 1e-6 * max|g| + rtol 1e-5.  The
# Predictor from the committed .msgpack fixtures against the JAX Predictor's
# outputs stored beside them (XLA on a CPU): float32 1e-4, the bar of the
# U-Net forward on the card against the CPU (check_unet); bf16 2e-3, the
# CPU tests' bar for bf16 against JAX's bf16 (a value may land on the
# neighbouring bf16 after any layer).  Metrics of one evaluation on the card
# and on the CPU: a pixel within the forward's 1e-4 of the threshold may
# flip; one flip moves a 128x128 image's Dice by about 1e-4 and its
# Boundary-F1, which counts only the few hundred boundary pixels, by up to
# about 5e-3.
# The native rasteriser against PIL: the share of equal mask pixels of
# tests/test_native.py, 0.995 (the two differ on a thin ring of sub-pixel
# boundary cases).
COMPAT_FWD_ATOL, COMPAT_BF16_ATOL, COMPAT_METRIC_ATOL, RASTER_AGREE = 1e-4, 2e-3, 5e-3, 0.995


def drive_compat(smi: str) -> dict:
    """The reference names at the published width: ``DiceBCEPDELoss`` on a
    (8, 1, 128, 128) CUDA batch forward and backward with K1's launch counts
    and against its plain path; ``evaluate_on_test_set`` from a base-64
    ``.pth`` on a synthetic COCO split, whose masks the native rasteriser
    draws as PIL does; the ``Predictor`` and ``evaluate_on_test_set`` from
    the committed ``.msgpack`` fixtures."""
    from physics_informed_image_segmentation_tpu_torch import (
        DiceBCEPDELoss, UNet, evaluate_model, evaluate_on_test_set,
    )
    from physics_informed_image_segmentation_tpu_torch.data import (
        DeviceDataset, load_split, write_synthetic_coco,
    )
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K
    from physics_informed_image_segmentation_tpu_torch.ops.losses import dice_bce_pde_loss
    from physics_informed_image_segmentation_tpu_torch.serve import Predictor
    from physics_informed_image_segmentation_tpu_torch.train import save_params

    out = {"card": smi}
    g = torch.Generator().manual_seed(11)
    pred = 0.02 + 0.96 * torch.rand((8, 1, 128, 128), generator=g)
    target = (torch.rand((8, 1, 128, 128), generator=g) > 0.5).float()
    loss_fn = DiceBCEPDELoss(pde_weight=1e-3, phase_field_weight=1e-3)

    def value_and_grad(p, t):
        p = p.clone().requires_grad_(True)
        loss = loss_fn(p, t)
        return loss.detach(), torch.autograd.grad(loss, p)[0]

    p_cuda, t_cuda = pred.cuda(), target.cuda()
    K.reset_launch_counts()
    loss_k, grad_k = value_and_grad(p_cuda, t_cuda)
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    loss_p, grad_p = value_and_grad(pred, target)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    gk, gp = grad_k.cpu(), grad_p
    gerr = float((gk - gp).abs().max())
    print(f"compat DiceBCEPDELoss (8,1,128,128) through K1: launches {counts}; loss "
          f"{float(loss_k):.8f} against the plain path {float(loss_p):.8f} (rel {rel:.3e}), "
          f"gradient max|d| {gerr:.3e}")
    check(counts == {"physics_sums_fwd": 1, "physics_sums_bwd": 1},
          f"expected 1 / 1 K1 launches on the compat path, got {counts}")
    check(rel <= SUM_RTOL, f"compat loss differs from its plain path by {rel:.3e} relative")
    check(grad_ok(gk, gp), f"compat loss gradient differs from its plain path by {gerr:.3e}")
    out.update(counts=counts, loss_rel=rel, grad_max_abs=gerr)
    out["ms_kernel"] = time_cuda(lambda: value_and_grad(p_cuda, t_cuda))

    def plain_on_card():
        p = p_cuda.clone().requires_grad_(True)
        torch.autograd.grad(dice_bce_pde_loss(p, t_cuda, pde_weight=1e-3,
                                              phase_field_weight=1e-3), p)

    out["ms_plain"] = time_cuda(plain_on_card)
    print(f"compat loss forward + backward: K1 {out['ms_kernel']:.4f} ms, plain PyTorch on the "
          f"card {out['ms_plain']:.4f} ms ({smi})")

    scratch = REPO / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        img_dir, ann = write_synthetic_coco(Path(tmp) / "test", n=8, height=128, width=128,
                                            seed=21)
        pil, native = load_split(img_dir, ann), load_split(img_dir, ann, raster_backend="native")
        agree = float((pil.masks == native.masks).mean())
        print(f"native rasteriser against PIL on the split: {agree:.6f} of mask pixels equal, "
              f"{int((pil.masks != native.masks).sum())} differ")
        check(np.array_equal(pil.images, native.images) and agree >= RASTER_AGREE,
              f"native masks agree with PIL's on {agree} of pixels")
        model = UNet(base_channels=64, generator=torch.Generator().manual_seed(5)).cuda()
        pth = save_params(model, Path(tmp) / "unet.pth")
        t0 = time.perf_counter()
        with quiet():
            metrics = evaluate_on_test_set(str(pth), img_dir, ann, batch_size=8)
        out["evaluate_s"] = time.perf_counter() - t0
        with quiet():
            direct = evaluate_model(model.eval(), DeviceDataset.from_numpy(
                pil.images, pil.masks, "cuda"), 8, precision="f32")
        check(set(metrics) == {"dice_scores", "iou_scores", "boundary_f1_scores",
                               "hausdorff_distances"}, f"metric keys {sorted(metrics)}")
        for k, v in metrics.items():
            check(v.shape == (8,) and np.array_equal(v, direct[k], equal_nan=True),
                  f"evaluate_on_test_set {k} differs from evaluate_model: {v} {direct[k]}")
        check(np.isfinite(metrics["dice_scores"]).all(), "non-finite Dice")
        print(f"evaluate_on_test_set(.pth, base 64, 8 images 128x128, f32): "
              f"{out['evaluate_s']:.3f} s, mean Dice {metrics['dice_scores'].mean():.6f} ({smi})")

        fixtures = REPO / "tests" / "torch_port_data"
        expected = np.load(fixtures / "unet_b4_expected.npz")
        images = expected["input"].transpose(0, 2, 3, 1)
        for precision, atol in (("f32", COMPAT_FWD_ATOL), ("bf16", COMPAT_BF16_ATOL)):
            kw = dict(base_channels=4, batch_size=2, image_size=(32, 32), precision=precision)
            path = fixtures / f"unet_b4_{precision}.msgpack"
            predictor = Predictor(path, **kw)
            diff = float(np.abs(predictor.predict(images) - expected[precision]).max())
            print(f"Predictor from {path.name} on the card against the JAX Predictor's "
                  f"outputs: max|d| {diff:.3e} (bar {atol})")
            check(diff <= atol, f"{path.name}: Predictor differs from JAX by {diff}")
            out[f"msgpack_{precision}_max_abs"] = diff
        small_dir, small_ann = write_synthetic_coco(Path(tmp) / "small", n=6, height=40,
                                                    width=40, seed=22)
        f32 = dict(base_channels=4, batch_size=2, image_size=(32, 32), precision="f32")
        with quiet():
            on_card = evaluate_on_test_set(Predictor(fixtures / "unet_b4_f32.msgpack", **f32),
                                           small_dir, small_ann, batch_size=2)
            on_cpu = evaluate_on_test_set(
                Predictor(fixtures / "unet_b4_f32.msgpack", device="cpu", **f32),
                small_dir, small_ann, device="cpu", batch_size=2)
        worst = max(float(np.abs(on_card[k] - on_cpu[k]).max())
                    for k in ("dice_scores", "iou_scores", "boundary_f1_scores"))
        print(f"evaluate_on_test_set(.msgpack Predictor) card against CPU: max|d| {worst:.3e}")
        check(worst <= COMPAT_METRIC_ATOL and np.isfinite(on_card["dice_scores"]).all(),
              f"evaluation from the .msgpack differs between card and CPU by {worst}")
        out["msgpack_eval_card_vs_cpu"] = worst
    return out


def unet64(seed: int = 0):
    from physics_informed_image_segmentation_tpu_torch import UNet

    return UNet(base_channels=64, generator=torch.Generator().manual_seed(seed)).cuda()


def blob_data(n: int, seed: int, size: int = 128):
    from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs

    images, masks = make_blobs(n, size, size, seed=seed)
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


def k3_case(shape, seed, *, saturated=False):
    g = torch.Generator().manual_seed(seed)
    if saturated:
        p = torch.randint(0, 3, shape, generator=g).float() / 2.0  # {0, 0.5, 1}
    else:
        p = 0.02 + 0.96 * torch.rand(shape, generator=g)
    return p.cuda(), torch.randn((shape[0], 2), generator=g).cuda()


def k3_kernel_and_plain(p, cot, use_reaction):
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3

    out = {}
    for name, fn in (("kernel", K3.PaddedPhysicsSums.apply),
                     ("plain", K3.padded_physics_sums_reference)):
        pp = p.detach().requires_grad_(True)  # p's own storage: a misaligned view stays one
        sums = fn(pp, D, A, EPS, use_reaction)
        (dp,) = torch.autograd.grad(sums, pp, cot)
        torch.cuda.synchronize()
        out[name] = (sums.detach(), dp)
    return out


def check_k3() -> dict:
    """K3 against its plain version and its tile-wise plain backward, with
    the copy width every case takes; returns the megapixel block's errors."""
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3

    cases = [
        ("megapixel block (1,1026,1026)", (1, 1026, 1026), {}, True),
        ("training block (8,130,130)", (8, 130, 130), {}, True),
        ("odd pitch (3,37,53)", (3, 37, 53), {}, True),
        ("odd pitch, W+2 = 35 (3,9,35)", (3, 9, 35), {}, True),
        ("smallest band (2,4,35)", (2, 4, 35), {}, True),
        ("h = 1 (2,3,130)", (2, 3, 130), {}, True),
        ("h = w = 1 (3,3,3)", (3, 3, 3), {}, False),
        ("B = 9, tiles that do not divide (9,37,131)", (9, 37, 131), {}, True),
        ("base 4 bytes off (8,130,130)", (8, 130, 130), {"misalign": True}, True),
        ("saturated u (2,18,26)", (2, 18, 26), {"saturated": True}, True),
        ("no reaction (8,130,130)", (8, 130, 130), {}, False),
        ("no reaction, saturated (3,37,53)", (3, 37, 53), {"saturated": True}, False),
    ]
    errors = {}
    for i, (label, shape, kw, use_reaction) in enumerate(cases):
        p, cot = k3_case(shape, seed=40 + i, saturated=kw.get("saturated", False))
        if kw.get("misalign"):
            p = placed(p, misalign=True)
        width = K3.copy_bytes(p)
        check(width == K3._library().padded_physics_copy_bytes(p.data_ptr(), shape[2]),
              f"K3 {label}: the kernel and copy_bytes disagree on the copy width")
        res = k3_kernel_and_plain(p, cot, use_reaction)
        (sk, dk), (sp, dpl) = res["kernel"], res["plain"]
        check(bool(torch.isfinite(sk).all() and torch.isfinite(dk).all()),
              f"K3 {label}: kernel output not finite")
        dt = K3.padded_physics_sums_bwd_tiled(p, cot, D, A, EPS, use_reaction)
        err_s, err_d = float((sk - sp).abs().max()), float((dk - dpl).abs().max())
        plan = tuple(K3.tile_plan(shape[0], shape[1] - 2, shape[2] - 2))
        print(f"K3 {label}: {width}-byte copies, tiles {plan}; "
              f"max|d sums| {err_s:.3e}, max|d dp| {err_d:.3e} (max|dp| "
              f"{float(dpl.abs().max()):.3e}); against the tile-wise plain backward "
              f"{float((dk - dt).abs().max()):.3e}")
        check(width == (4 if kw.get("misalign") or shape[2] % 2 else 8),
              f"K3 {label}: {width}-byte copies")
        check(bool(torch.all((sk - sp).abs() <= SUM_RTOL * sp.abs())),
              f"K3 {label}: forward sums differ beyond rtol {SUM_RTOL}")
        check(grad_ok(dk, dpl), f"K3 {label}: dp differs beyond tolerance")
        check(grad_ok(dk, dt), f"K3 {label}: dp differs from the tile-wise plain backward")
        check(bool((dk[:, [0, 0, -1, -1], [0, -1, 0, -1]] == 0).all()),
              f"K3 {label}: the ghost ring's corners must get zero gradient")
        # no float atomics: the same inputs give the same bits, three times over
        for _ in range(2):
            again = k3_kernel_and_plain(p, cot, use_reaction)["kernel"]
            check(all(torch.equal(a, b) for a, b in zip(again, res["kernel"])),
                  f"K3 {label}: the kernels do not repeat bit for bit")
        if i == 0:
            errors = {"padded_physics_fwd": err_s, "padded_physics_bwd": err_d}
    check_k3_in_a_graph()
    return errors


def check_k3_in_a_graph() -> None:
    """K3 forward and backward captured in one CUDA graph and replayed on
    three fresh inputs: bit-equal to the eager calls (the forward's last
    block leaves its ticket at 0; the backward needs no scratch)."""
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3

    args = (D, A, EPS, True)
    for shape in ((1, 1026, 1026), (8, 130, 130), (9, 37, 131)):
        p, cot = k3_case(shape, seed=210)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            K3._launch_fwd(p, *args)  # the stream's workspace is made outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            sums = K3._launch_fwd(p, *args)
            dp = K3._launch_bwd(p, cot, *args)
        for seed in (211, 212, 213):
            fresh = k3_case(shape, seed=seed)
            p.copy_(fresh[0])
            cot.copy_(fresh[1])
            graph.replay()
            torch.cuda.synchronize()
            replayed = (sums.clone(), dp.clone())
            eager = (K3._launch_fwd(fresh[0], *args), K3._launch_bwd(*fresh, *args))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(replayed, eager)),
                  f"K3 replayed in a CUDA graph at {shape} differs from the eager call")
        print(f"K3 forward + backward in a CUDA graph at {shape}: 3 replays on fresh inputs "
              f"bit-equal to the eager calls")


def bands_with_ghosts(u, n_bands):
    """Cut (B, H, W) into row bands with their ghost rows filled from the
    neighbours (mirrored at the global edges) and mirrored columns."""
    h = u.shape[1] // n_bands
    blocks = []
    for k in range(n_bands):
        top = u[:, k * h - 1] if k > 0 else u[:, 1]
        bot = u[:, (k + 1) * h] if k < n_bands - 1 else u[:, -2]
        rows = torch.cat([top[:, None], u[:, k * h:(k + 1) * h], bot[:, None]], dim=1)
        blocks.append(torch.cat([rows[..., 1:2], rows, rows[..., -2:-1]], dim=2).contiguous())
    return blocks


def fold_bands(grads, n_bands, shape):
    """Transpose of :func:`bands_with_ghosts`: ghost rows go back to the
    rows they came from, mirror ghosts onto rows and columns 1 and -2."""
    du = torch.zeros(shape, device=grads[0].device)
    h = shape[1] // n_bands
    for k, g in enumerate(grads):
        core = g[..., 1:-1].clone()
        core[..., 1] += g[..., 0]
        core[..., -2] += g[..., -1]
        du[:, k * h:(k + 1) * h] += core[:, 1:-1]
        du[:, k * h - 1 if k > 0 else 1] += core[:, 0]
        du[:, (k + 1) * h if k < n_bands - 1 else -2] += core[:, -1]
    return du


def check_k3_against_k1() -> None:
    """K3 on the 4 ghost-filled row bands of a (2,256,256) field against
    K1 on the whole field: summed [Σr², Σpf] rtol 1e-5, and the folded
    band gradients against K1's du for a cotangent on those two columns."""
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1

    shape = (2, 256, 256)
    g = torch.Generator().manual_seed(50)
    u = (0.02 + 0.96 * torch.rand(shape, generator=g)).cuda()
    cot = torch.randn((2, 2), generator=g).cuda()
    for use_reaction in (True, False):
        uu = u.clone().requires_grad_(True)
        sums = K1.FusedPhysicsSums.apply(uu, torch.zeros_like(u), torch.ones((2, 1), device="cuda"),
                                        D, A, EPS, use_reaction)
        cot6 = torch.zeros((2, 6), device="cuda")
        cot6[:, 4:] = cot
        (du_k1,) = torch.autograd.grad(sums, uu, cot6)
        blocks = [b.requires_grad_(True) for b in bands_with_ghosts(u, 4)]
        total = torch.stack([K3.PaddedPhysicsSums.apply(b, D, A, EPS, use_reaction)
                             for b in blocks]).sum(0)
        du_k3 = fold_bands(torch.autograd.grad(total, blocks, cot), 4, shape)
        torch.cuda.synchronize()
        ref = sums[:, 4:].detach()
        err_s, err_d = float((total.detach() - ref).abs().max()), float((du_k3 - du_k1).abs().max())
        print(f"K3 on 4 bands vs K1 on the field (2,256,256), reaction {use_reaction}: "
              f"max|d sums| {err_s:.3e} of {float(ref.abs().max()):.3e}, max|d du| {err_d:.3e} "
              f"(max|du| {float(du_k1.abs().max()):.3e})")
        check(bool(torch.all((total.detach() - ref).abs() <= SUM_RTOL * ref.abs())),
              "K3 over bands and K1 disagree on the sums")
        check(grad_ok(du_k3, du_k1), "K3's folded band gradients and K1's du disagree")


def k4_case(shape, dtype, seed, scale=0.1):
    """x (B,H,W,Cin) ~ N(0,1), w (3,3,Cin,Cout) ~ scale N(0,1) and a
    cotangent (B,H,W,Cout) ~ 0.1 N(0,1), in ``dtype`` on the card."""
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g).to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=g) * scale).to(dtype)
    cot = (torch.randn((b, h, w, cout), generator=g) * 0.1).to(dtype)
    return x.cuda(), wt.cuda(), cot.cuda()


def k4_grads(fn, x, wt, cot, paired):
    xx, ww = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    out = fn(xx, ww, paired)
    dx, dw = torch.autograd.grad(out, (xx, ww), cot)
    torch.cuda.synchronize()
    return out.detach(), dx, dw


def close(k, p, tol) -> bool:
    rtol, atol = tol
    k, p = k.float(), p.float()
    return bool(torch.all((k - p).abs() <= atol + rtol * p.abs()))


def check_k4() -> dict:
    """K4 (forward in both tap orders, dx, dW) against its plain version
    and, in float32, against cuDNN; returns the probe shape's errors."""
    from physics_informed_image_segmentation_tpu_torch.ops import conv_kernel as K4

    f32, bf16 = torch.float32, torch.bfloat16
    cores, wmma, wgmma = "cuda-cores", "wmma", "wgmma"
    # label, shape, type, scale of w and cot, the kernel sets that the forward,
    # dx (a forward with Cin and Cout exchanged) and dW must take
    cases = [
        ("probe shape (8,128,128,64->64) bf16", PROBE_SHAPE, bf16, 0.05, (wgmma,) * 3),
        ("JAX test shape (2,16,16,8->8) f32", (2, 16, 16, 8, 8), f32, 0.1, (cores,) * 3),
        ("JAX test shape (1,8,32,4->12) f32", (1, 8, 32, 4, 12), f32, 0.1, (cores,) * 3),
        ("several tiles, ragged rows (2,44,64,16->24) f32", (2, 44, 64, 16, 24), f32, 0.1,
         (cores,) * 3),
        ("several tiles (2,44,64,16->24) bf16", (2, 44, 64, 16, 24), bf16, 0.1,
         (wmma, cores, wmma)),
        ("two channel chunks (1,16,32,72->136) f32", (1, 16, 32, 72, 136), f32, 0.1, (cores,) * 3),
        ("any W, ragged columns (1,20,24,8->8) f32", (1, 20, 24, 8, 8), f32, 0.1, (cores,) * 3),
        ("CUDA cores in bf16, Cin % 16 != 0 (2,16,16,8->8) bf16", (2, 16, 16, 8, 8), bf16, 0.1,
         (cores,) * 3),
        ("wmma, two chunks, ragged (1,20,24,80->136) bf16", (1, 20, 24, 80, 136), bf16, 0.1,
         (wmma, cores, wmma)),
        ("wmma (2,16,16,16->24) bf16", (2, 16, 16, 16, 24), bf16, 0.1, (wmma, cores, wmma)),
        ("one tile (1,8,16,64->64) bf16", (1, 8, 16, 64, 64), bf16, 0.1, (wgmma,) * 3),
        ("an image smaller than a tile (2,5,8,64->64) bf16", (2, 5, 8, 64, 64), bf16, 0.1,
         (wgmma,) * 3),
        ("ragged H and W, fewer tiles than SMs (2,44,72,64->64) bf16", (2, 44, 72, 64, 64), bf16,
         0.1, (wgmma,) * 3),
        ("ragged, more tiles than SMs (3,72,136,64->64) bf16", (3, 72, 136, 64, 64), bf16, 0.05,
         (wgmma,) * 3),
        ("two input chunks (1,20,24,128->64) bf16", (1, 20, 24, 128, 64), bf16, 0.1,
         (wgmma,) * 3),
        ("two output chunks (1,16,32,64->128) bf16", (1, 16, 32, 64, 128), bf16, 0.1,
         (wgmma,) * 3),
        ("dW on wgmma, forward on wmma (1,16,16,192->64) bf16", (1, 16, 16, 192, 64), bf16, 0.05,
         (wmma, wgmma, wgmma)),
    ]
    errors = {}
    for i, (label, shape, dtype, scale, expected_sets) in enumerate(cases):
        x, wt, cot = k4_case(shape, dtype, seed=70 + i, scale=scale)
        fwd_tol, grad_tol = (K4_F32_FWD, K4_F32_GRAD) if dtype == f32 else (K4_BF16, K4_BF16)
        w9 = wt.reshape(9, shape[3], shape[4])
        sets = (K4.kernel_set(x, w9), K4.kernel_set(cot, w9.transpose(1, 2).contiguous()),
                K4.kernel_set(x, cot, dw=True))
        print(f"K4 {label}: kernel sets forward {sets[0]}, dx {sets[1]}, dW {sets[2]}")
        check(sets == expected_sets, f"K4 {label}: kernel sets {sets}, expected {expected_sets}")
        for paired in (False, True):
            # Conv3x3Same takes any W; the public function keeps the JAX contract
            ko, kdx, kdw = k4_grads(K4.Conv3x3Same.apply, x, wt, cot, paired)
            po, pdx, pdw = k4_grads(K4.conv3x3_same_reference, x, wt, cot, paired)
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in ((ko, po), (kdx, pdx), (kdw, pdw))]
            print(f"K4 {label}, paired {paired}: max|d out| {errs[0]:.3e} (max|out| "
                  f"{float(po.float().abs().max()):.3e}), max|d dx| {errs[1]:.3e}, max|d dw| "
                  f"{errs[2]:.3e} (max|dw| {float(pdw.float().abs().max()):.3e})")
            for name, a in (("out", ko), ("dx", kdx), ("dw", kdw)):
                check(a.dtype == dtype and bool(torch.isfinite(a).all()),
                      f"K4 {label}: kernel {name} has type {a.dtype} or is not finite")
            check(close(ko, po, fwd_tol), f"K4 {label}, paired {paired}: forward beyond {fwd_tol}")
            check(close(kdx, pdx, grad_tol), f"K4 {label}, paired {paired}: dx beyond {grad_tol}")
            check(close(kdw, pdw, grad_tol), f"K4 {label}, paired {paired}: dw beyond {grad_tol}")
            if dtype == f32:
                with deterministic_f32():
                    lo, ldx, ldw = k4_grads(
                        lambda a, b, _: F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1),
                                                 padding=1).permute(0, 2, 3, 1), x, wt, cot, paired)
                print("    against F.conv2d: max|d out| {:.3e}, max|d dx| {:.3e}, max|d dw| {:.3e}"
                      .format(*(float((a - b).abs().max())
                                for a, b in ((ko, lo), (kdx, ldx), (kdw, ldw)))))
                for name, a, ref in (("out", ko, lo), ("dx", kdx, ldx), ("dw", kdw, ldw)):
                    tol = (K4_CUDNN_RTOL, K4_CUDNN_ATOL_REL * float(ref.abs().max()))
                    check(close(a, ref, tol), f"K4 {label}, paired {paired}: {name} differs from "
                          f"cuDNN's by {float((a - ref).abs().max()):.3e}, beyond {tol}")
            if sets[1] == wgmma:
                # dx read the weights transposed in the kernel: the same products in the
                # same order as the forward kernel on weights laid out by PyTorch
                laid_out = w9.flip(0).transpose(1, 2).contiguous()
                check(torch.equal(K4._launch_fwd(cot, w9, paired, transposed=True),
                                  K4._launch_fwd(cot, laid_out, paired)),
                      f"K4 {label}, paired {paired}: dx differs between the two weight layouts")
            if i == 0:
                errors["conv3x3_fwd_paired" if paired else "conv3x3_fwd"] = max(errs[0], errs[1])
                errors["conv3x3_dw"] = max(errors.get("conv3x3_dw", 0.0), errs[2])
    # all-ones: the sums count the taps that fall inside the image
    for paired in (False, True):
        ones = K4.conv3x3_same(torch.ones((1, 8, 16, 4), device="cuda"),
                               torch.ones((3, 3, 4, 4), device="cuda"), paired)
        got = [float(ones[0, 4, 8, 0]), float(ones[0, 0, 8, 1]), float(ones[0, 0, 0, 3]),
               float(ones[0, 7, 15, 2])]
        print(f"K4 all ones (1,8,16,4->4), paired {paired}: interior, edge, corners {got}")
        check(got == [36.0, 24.0, 16.0, 16.0], f"K4 zero padding: {got} != [36, 24, 16, 16]")
        # the wgmma kernels, two ragged tiles each way: 64 channels a tap, all exact in bf16
        ones = K4.Conv3x3Same.apply(torch.ones((1, 9, 17, 64), device="cuda", dtype=bf16),
                                    torch.ones((3, 3, 64, 64), device="cuda", dtype=bf16), paired)
        got = [float(ones[0, 4, 8, 0]), float(ones[0, 7, 15, 63]), float(ones[0, 0, 8, 1]),
               float(ones[0, 8, 9, 5]), float(ones[0, 4, 16, 7]), float(ones[0, 0, 0, 3]),
               float(ones[0, 8, 16, 2])]
        print(f"K4 all ones (1,9,17,64->64) bf16, paired {paired}: interior, across tiles, edges, "
              f"corners {got}")
        check(got == [576.0, 576.0, 384.0, 384.0, 384.0, 256.0, 256.0],
              f"K4 zero padding on wgmma: {got} != [576, 576, 384, 384, 384, 256, 256]")
    # no atomics: the same inputs give the same bits
    x, wt, cot = k4_case(PROBE_SHAPE, bf16, seed=70, scale=0.05)
    check(torch.equal(K4.conv3x3_same(x, wt), K4.conv3x3_same(x, wt)),
          "K4 forward does not repeat bit for bit")
    check(torch.equal(K4._launch_dw(x, cot), K4._launch_dw(x, cot)),
          "K4 dW does not repeat bit for bit")
    torch.cuda.synchronize()
    return errors


# GroupNorm (+ residual, ReLU) against float64, with the gradients taken
# through the kernel's own ReLU decisions (a pre-activation within float32
# rounding of 0 may fall either way): the output one rounding of a float32
# value (bf16 2^-8, float32 1e-5 relative) plus 1e-5 of the largest; the
# gradients 1e-5 relative (a bf16 dx: 2^-8) plus 1e-5 of the largest.
GN_ATOL_REL = 1e-5


def gn_case(shape, groups, dtype, out, residual, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, c, h, w = shape
    x = (torch.randn(shape, device="cuda", generator=g)
         * (0.5 + torch.rand(1, c, 1, 1, device="cuda", generator=g)) + 0.3).to(dtype)
    weight = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    r = torch.randn(shape, device="cuda", generator=g) if residual else None
    dy = torch.randn(shape, device="cuda", generator=g).to(out)
    return x, weight, bias, r, dy


def gn_kernel_and_reference(x, weight, bias, r, dy, groups, eps, relu, out):
    from physics_informed_image_segmentation_tpu_torch.ops.group_norm import GroupNormAct

    extra = (r,) if r is not None else ()
    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias, *extra)]
    y = GroupNormAct.apply(*ins[:3], ins[3] if extra else None, groups, eps, relu, out, True)
    kernel = (y.detach(), *torch.autograd.grad(y, ins, dy))
    ref_ins = [t.double().requires_grad_(True) for t in (x, weight, bias, *extra)]
    z = F.group_norm(ref_ins[0], groups, ref_ins[1], ref_ins[2], eps)
    if extra:
        z = z + ref_ins[3]
    ry = torch.where(kernel[0] > 0, z, torch.zeros_like(z)) if relu else z
    ref = (z.detach().clamp_min(0) if relu else z.detach(),
           *torch.autograd.grad(ry, ref_ins, dy.double()))
    return kernel, ref, z.detach()


def check_group_norm() -> dict:
    """GroupNorm with its residual and ReLU (``ops/group_norm.py``) against
    float64 at TransUNet's site kinds and awkward shapes: odd H*W (groups
    and channels off the 16-byte packs), H*W below a pack, one channel a
    group, one group; bf16 and float32 inputs; repeated bit for bit.
    Returns the largest errors at the root's shape."""
    from physics_informed_image_segmentation_tpu_torch.ops import group_norm as GN

    GN.reset_launch_counts()
    f32, bf16 = torch.float32, torch.bfloat16
    # label, shape, groups, eps, residual, relu, output type (None: the input's)
    cases = [
        ("root (8,64,512,512) G32", (8, 64, 512, 512), 32, 1e-6, False, True, None),
        ("gn3 + residual (8,256,255,255) G32", (8, 256, 255, 255), 32, 1e-6, True, True, f32),
        ("last gn3, bf16 out (8,1024,64,64) G32", (8, 1024, 64, 64), 32, 1e-6, True, True, None),
        ("gn_proj (8,1024,64,64) G=C eps 1e-5", (8, 1024, 64, 64), 1024, 1e-5, False, False, f32),
        ("gn2 (3,64,37,29) G32", (3, 64, 37, 29), 32, 1e-6, False, True, None),
        ("H*W below a pack (2,32,2,3) G8", (2, 32, 2, 3), 8, 1e-6, True, True, f32),
        ("one group (2,24,9,7) G1", (2, 24, 9, 7), 1, 1e-6, False, True, None),
        ("residual, no ReLU (2,16,5,5) G4", (2, 16, 5, 5), 4, 1e-6, True, False, f32),
    ]
    errors = {}
    for i, (label, shape, groups, eps, residual, relu, out) in enumerate(cases):
        for dtype in (bf16, f32):
            o = out or dtype
            x, weight, bias, r, dy = gn_case(shape, groups, dtype, o, residual, seed=300 + i)
            kernel, ref, z = gn_kernel_and_reference(x, weight, bias, r, dy, groups, eps, relu, o)
            errs = []
            for name, k, p in zip(("y", "dx", "dgamma", "dbeta", "dr"), kernel, ref):
                rtol = 1e-5
                if (name == "y" and o == bf16) or (name == "dx" and dtype == bf16):
                    rtol = 2.0 ** -8
                err = (k.double() - p).abs()
                errs.append(float(err.max()))
                check(bool(torch.all(err <= GN_ATOL_REL * p.abs().max() + rtol * p.abs())),
                      f"GroupNorm {label} {dtype}: {name} beyond its tolerance ({errs[-1]:.3e})")
            if relu:
                flipped = (kernel[0] > 0) != (z > 0)
                check(bool(torch.all(z[flipped].abs() <= 1e-5)),
                      f"GroupNorm {label} {dtype}: the ReLU decided {int(flipped.sum())} elements "
                      f"away from 0 otherwise than float64")
            print(f"GroupNorm {label} {dtype}: max|d y| {errs[0]:.3e}, dx {errs[1]:.3e}, "
                  f"dgamma {errs[2]:.3e}, dbeta {errs[3]:.3e}"
                  + (f", dr {errs[4]:.3e}" if residual else ""))
            if i == 0 and dtype == bf16:
                errors["group_norm_fwd"], errors["group_norm_bwd"] = errs[0], max(errs[1:])
            again = gn_kernel_and_reference(x, weight, bias, r, dy, groups, eps, relu, o)[0]
            check(all(torch.equal(a, b) for a, b in zip(kernel, again)),
                  f"GroupNorm {label} {dtype}: does not repeat bit for bit")
            del x, r, dy, kernel, ref, z, again
    # the residual stream's bf16 copy: y cast to bf16, and its gradient added to y's
    x, weight, bias, r, dy = gn_case((8, 256, 255, 255), 32, bf16, f32, True, seed=390)
    dy_low = torch.randn(x.shape, device="cuda").to(bf16)
    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias, r)]
    y, y_low = GN.GroupNormAct.apply(*ins, 32, 1e-6, True, f32, True, True)
    check(torch.equal(y_low, y.to(bf16)), "GroupNorm's bf16 copy is not y cast to bf16")
    both = torch.autograd.grad((y, y_low), ins, (dy, dy_low))
    ins2 = [t.clone().requires_grad_(True) for t in (x, weight, bias, r)]
    y2 = GN.GroupNormAct.apply(*ins2, 32, 1e-6, True, f32, True)
    summed = torch.autograd.grad(y2, ins2, dy + dy_low.float())
    check(all(torch.equal(a, b) for a, b in zip(both, summed)),
          "GroupNorm's backward with the bf16 copy's gradient differs from one given the sum")
    print("GroupNorm bf16 copy of the residual stream: bit-equal, forward and backward")
    torch.cuda.synchronize()
    # two forwards and backwards a case and type, and two for the bf16 copy
    expected = {"group_norm_fwd": 4 * len(cases) + 2, "group_norm_bwd": 4 * len(cases) + 2}
    check(GN.launch_counts == expected,
          f"GroupNorm launches {GN.launch_counts}, expected {expected}")
    return errors


def drive_resnet_norms() -> dict:
    """A bf16 forward and backward of TransUNet's ResNetV2 at 1024², batch
    2, as the model runs it: every one of its 52 norms takes the kernels.
    Returns the launch counts of that step."""
    from physics_informed_image_segmentation_tpu_torch.models import TransUNet
    from physics_informed_image_segmentation_tpu_torch.ops import group_norm as GN

    size = 1024
    model = TransUNet(img_size=size).to("cuda").train()
    resnet = model.transformer.embeddings.hybrid_model
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(2, 1, size, size, device="cuda", generator=g).repeat(1, 3, 1, 1)
    GN.reset_launch_counts()
    with torch.autocast("cuda", torch.bfloat16):
        feats, skips = resnet(x, model.norm_counts)
    loss = feats.float().square().mean() + sum(s.float().mean() for s in skips)
    torch.autograd.grad(loss, list(resnet.parameters()))
    torch.cuda.synchronize()
    counts = dict(GN.launch_counts)
    check(model.norm_counts == {"fused": 52, "plain": 0},
          f"TransUNet's ResNet norms: {model.norm_counts}, expected 52 fused")
    check(counts == {"group_norm_fwd": 52, "group_norm_bwd": 52},
          f"TransUNet's ResNet step launched {counts}, expected 52 each way")
    print(f"TransUNet ResNet at {size}², batch 2, bf16: norm calls {model.norm_counts}, "
          f"launches {counts}")
    del model, resnet, x, feats, skips, loss
    torch.cuda.empty_cache()
    return counts


# the sites timed, at 1024², batch 8: label, shape, groups, eps, residual,
# relu, output type (None: bf16 like the input)
GN_TIMED = [
    ("root", (8, 64, 512, 512), 32, 1e-6, False, True, None),
    ("block1 gn3 + residual", (8, 256, 255, 255), 32, 1e-6, True, True, torch.float32),
    ("block3 gn3 + residual", (8, 1024, 64, 64), 32, 1e-6, True, True, torch.float32),
    ("block1 gn_proj", (8, 256, 255, 255), 256, 1e-5, False, False, torch.float32),
]


def gn_floor_bytes(numel: int, proj: bool) -> tuple[int, int]:
    """The byte floor of a forward and a backward, as
    ``benchmark/metrics/norm_roofline.transunet.py`` counts it: bf16 input
    and output (gn_proj: the input), and for the backward the gradient in,
    the input and the gradient out (gn_proj: the input and the gradient out)."""
    return (2 if proj else 4) * numel, (4 if proj else 6) * numel


def time_group_norm() -> dict:
    """GroupNorm's kernels at the ResNet's largest sites, forward and
    backward, by CUDA events, against their byte floor and against today's
    path under bf16 autocast (float32 ``group_norm``, add and ``relu``, and
    apart their backward); ms per call."""
    from physics_informed_image_segmentation_tpu_torch.ops import group_norm as GN

    rows = {}
    for label, shape, groups, eps, residual, relu, out in GN_TIMED:
        o = out or torch.bfloat16
        x, weight, bias, r, dy = gn_case(shape, groups, torch.bfloat16, o, residual, seed=400)
        weight.requires_grad_(True)
        bias.requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        rg = r.clone().requires_grad_(True) if residual else None
        ins = [t for t in (xg, weight, bias, rg) if t is not None]

        def fwd():
            return GN.GroupNormAct.apply(xg, weight, bias, rg, groups, eps, relu, o, True)

        y = fwd()
        saved = y.grad_fn

        def bwd():
            return saved.apply(dy)

        def plain_fwd():
            with torch.autocast("cuda", torch.bfloat16):
                z = F.group_norm(xg, groups, weight, bias, eps)
                if residual:
                    z = rg + z
                return F.relu(z) if relu else z

        z = plain_fwd()
        dz = dy.to(z.dtype)

        def plain_bwd():
            return torch.autograd.grad(z, ins, dz, retain_graph=True)

        fwd_ms, bwd_ms = time_cuda(fwd), time_cuda(bwd)
        plain_fwd_ms, plain_bwd_ms = time_cuda(plain_fwd), time_cuda(plain_bwd)
        floor_f, floor_b = gn_floor_bytes(x.numel(), not relu)
        row = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_ms": plain_fwd_ms,
               "plain_bwd_ms": plain_bwd_ms,
               "floor_fwd_ms": floor_f / PEAK_BYTES_PER_S * 1e3,
               "floor_bwd_ms": floor_b / PEAK_BYTES_PER_S * 1e3}
        row["fwd_share"] = row["floor_fwd_ms"] / fwd_ms
        row["bwd_share"] = row["floor_bwd_ms"] / bwd_ms
        rows[label] = row
        print(f"GroupNorm {label} {shape}: forward {fwd_ms:.3f} ms ({100 * row['fwd_share']:.1f}% "
              f"of its byte floor), backward {bwd_ms:.3f} ms ({100 * row['bwd_share']:.1f}%); "
              f"autocast's path forward {plain_fwd_ms:.3f} ms, backward {plain_bwd_ms:.3f} ms")
        del x, r, dy, xg, rg, y, saved, z, dz
    torch.cuda.synchronize()
    return rows


def swin_norm_sites(batch: int = 8, size: int = 896) -> list:
    """Every LayerNorm call of Swin-Unet at ``size``² under bf16 autocast,
    as ``(C, rows at batch, input type, output type)`` in call order:
    recorded from the model itself (a batch-1 no-grad forward)."""
    from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    sites, real = [], LN.LayerNormFn.apply

    def record(x, weight, bias, eps, out_dtype):
        sites.append((x.shape[-1], batch * (x.numel() // x.shape[-1]), x.dtype, out_dtype))
        return real(x, weight, bias, eps, out_dtype)

    model = SwinUnet(img_size=size).to("cuda").eval()
    LN.LayerNormFn.apply = record
    try:
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
            model(torch.rand(1, 1, size, size, device="cuda"))
    finally:
        LN.LayerNormFn.apply = real
    del model
    torch.cuda.empty_cache()
    return sites


def ln_case(c, rows, dtype, out, seed):
    """x with a per-row offset and scale, gamma and beta away from 1 and 0,
    dy in the output's type."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, c, device="cuda", generator=g)
         * (0.5 + torch.rand(rows, 1, device="cuda", generator=g))
         + torch.randn(rows, 1, device="cuda", generator=g)).to(dtype)
    weight = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=g)
    bias = 0.1 * torch.randn(c, device="cuda", generator=g)
    dy = torch.randn(rows, c, device="cuda", generator=g).to(out)
    return x, weight, bias, dy


def ln_kernel(x, weight, bias, dy, out):
    from physics_informed_image_segmentation_tpu_torch.ops.layer_norm import LayerNormFn

    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = LayerNormFn.apply(*ins, 1e-5, out)
    return (y.detach(), *torch.autograd.grad(y, ins, dy))


def check_layer_norm() -> dict:
    """Swin-Unet's LayerNorm kernels (``ops/layer_norm.py``) against float64
    at every distinct site of an 896² step, batch 8, in the sites' types,
    and at row counts that leave a block's row groups part empty, in every
    type pair; repeated bit for bit.  Returns the largest errors at the x4
    expand's site."""
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f"site C={c} rows={rows} {str(i)[6:]}->{str(o)[6:]}", c, rows, i, o)
             for c, rows, i, o in dict.fromkeys(swin_norm_sites())]
    cases += [(f"odd rows C={c} rows={rows} {str(i)[6:]}->{str(o)[6:]}", c, rows, i, o)
              for c, rows in ((96, 1), (192, 3), (384, 7), (768, 5), (1536, 3), (96, 1001))
              for i, o in ((f32, f32), (f32, bf16), (bf16, f32), (bf16, bf16))]
    LN.reset_launch_counts()
    errors = {}
    for k, (label, c, rows, dtype, out) in enumerate(cases):
        x, weight, bias, dy = ln_case(c, rows, dtype, out, seed=500 + k)
        got = ln_kernel(x, weight, bias, dy, out)
        ins = [t.double().requires_grad_(True) for t in (x, weight, bias)]
        z = F.layer_norm(ins[0], (c,), ins[1], ins[2], 1e-5)
        want = (z.detach(), *torch.autograd.grad(z, ins, dy.double()))
        del ins, z
        errs = []
        for name, kv, p, t in zip(("y", "dx", "dgamma", "dbeta"), got, want,
                                  (out, dtype, f32, f32)):
            err = (kv.double() - p).abs()
            errs.append(float(err.max()))
            rtol = 2.0 ** -8 if t == bf16 else 1e-5
            check(bool(torch.all(err <= 1e-5 * p.abs().max() + rtol * p.abs())),
                  f"LayerNorm {label}: {name} beyond its tolerance ({errs[-1]:.3e})")
            del err
        print(f"LayerNorm {label}: max|d y| {errs[0]:.3e}, dx {errs[1]:.3e}, "
              f"dgamma {errs[2]:.3e}, dbeta {errs[3]:.3e}")
        if rows == 8 * 896 * 896:
            errors["layer_norm_fwd"], errors["layer_norm_bwd"] = errs[0], max(errs[1:])
        again = ln_kernel(x, weight, bias, dy, out)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"LayerNorm {label}: does not repeat bit for bit")
        del x, dy, got, want, again
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    expected = {"layer_norm_fwd": 2 * len(cases), "layer_norm_bwd": 2 * len(cases)}
    check(LN.launch_counts == expected,
          f"LayerNorm launches {LN.launch_counts}, expected {expected}")
    return errors


def drive_swin_norms() -> dict:
    """A bf16 forward and backward of Swin-Unet at 896², batch 2, as the
    model runs it: every one of its 38 norms takes the kernels each way,
    and a no-grad forward takes them forward only.  Returns the launch
    counts of the training step."""
    from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    size = 896
    model = SwinUnet(img_size=size).to("cuda").train()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(2, 1, size, size, device="cuda", generator=g)
    LN.reset_launch_counts()
    with torch.autocast("cuda", torch.bfloat16):
        out = model(x, torch.Generator(device="cuda").manual_seed(1))
    torch.autograd.grad(out.mean(), list(model.parameters()))
    torch.cuda.synchronize()
    counts = dict(LN.launch_counts)
    check(counts == {"layer_norm_fwd": 38, "layer_norm_bwd": 38},
          f"Swin-Unet's step launched {counts}, expected 38 each way")
    LN.reset_launch_counts()
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        model.eval()(x)
    torch.cuda.synchronize()
    check(LN.launch_counts == {"layer_norm_fwd": 38, "layer_norm_bwd": 0},
          f"Swin-Unet's no-grad forward launched {LN.launch_counts}, expected 38 and 0")
    print(f"Swin-Unet at {size}², batch 2, bf16: LayerNorm launches {counts} a step, "
          f"{dict(LN.launch_counts)} a no-grad forward")
    del model, x, out
    torch.cuda.empty_cache()
    return counts


# the sites timed, at 896², batch 8: label, C, rows, input type, output type
LN_TIMED = [
    ("x4 expand", 96, 8 * 896 * 896, torch.bfloat16, torch.bfloat16),
    ("stage-1 norm1", 96, 8 * 224 * 224, torch.float32, torch.bfloat16),
    ("PatchExpand to stage 1", 96, 8 * 224 * 224, torch.bfloat16, torch.float32),
]


def ln_floor_bytes(numel: int, in_size: int, out_size: int) -> tuple[int, int]:
    """The byte floor of a forward and a backward, as
    ``benchmark/metrics/ln_roofline.swinunet.py`` counts it: the input read
    and the output written; the input and the output's gradient read and
    the input's gradient written."""
    return numel * (in_size + out_size), numel * (2 * in_size + out_size)


def time_layer_norm() -> dict:
    """The LayerNorm kernels at Swin-Unet's largest sites, forward and
    backward, by CUDA events, against their byte floor, their plain
    version on the card, and autocast's ``nn.LayerNorm`` path (a float32
    ``layer_norm`` of the input cast up, and the output cast to bf16 where
    a linear reads it; apart its backward); ms per call."""
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    rows_out = {}
    for label, c, rows, dtype, out in LN_TIMED:
        x, weight, bias, dy = ln_case(c, rows, dtype, out, seed=600)
        weight.requires_grad_(True)
        bias.requires_grad_(True)
        xg = x.clone().requires_grad_(True)

        def fwd():
            return LN.LayerNormFn.apply(xg, weight, bias, 1e-5, out)

        y = fwd()
        saved = y.grad_fn

        def bwd():
            return saved.apply(dy)

        def plain_fwd():
            return LN.layer_norm_fwd_plain(x, weight.detach(), bias.detach(), 1e-5, out)

        _, mean, rstd = plain_fwd()

        def plain_bwd():
            return LN.layer_norm_bwd_plain(dy, x, mean, rstd, weight.detach())

        def library_fwd():
            with torch.autocast("cuda", torch.bfloat16):
                z = F.layer_norm(xg, (c,), weight, bias, 1e-5)
                return z.to(out)

        z = library_fwd()

        def library_bwd():
            return torch.autograd.grad(z, [xg, weight, bias], dy, retain_graph=True)

        row = {"fwd_ms": time_cuda(fwd), "bwd_ms": time_cuda(bwd),
               "plain_fwd_ms": time_cuda(plain_fwd), "plain_bwd_ms": time_cuda(plain_bwd),
               "library_fwd_ms": time_cuda(library_fwd), "library_bwd_ms": time_cuda(library_bwd)}
        floor_f, floor_b = ln_floor_bytes(x.numel(), x.element_size(), dy.element_size())
        row["floor_fwd_ms"] = floor_f / PEAK_BYTES_PER_S * 1e3
        row["floor_bwd_ms"] = floor_b / PEAK_BYTES_PER_S * 1e3
        row["fwd_share"] = row["floor_fwd_ms"] / row["fwd_ms"]
        row["bwd_share"] = row["floor_bwd_ms"] / row["bwd_ms"]
        rows_out[label] = row
        print(f"LayerNorm {label} ({rows}, {c}) {str(dtype)[6:]}->{str(out)[6:]}: forward "
              f"{row['fwd_ms']:.3f} ms ({100 * row['fwd_share']:.1f}% of its byte floor), backward "
              f"{row['bwd_ms']:.3f} ms ({100 * row['bwd_share']:.1f}%); plain forward "
              f"{row['plain_fwd_ms']:.3f}, backward {row['plain_bwd_ms']:.3f} ms; autocast's "
              f"layer_norm forward {row['library_fwd_ms']:.3f}, backward "
              f"{row['library_bwd_ms']:.3f} ms")
        del x, dy, xg, y, saved, z, mean, rstd
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows_out


def drive_probe() -> dict:
    """The probe's path at full width through ``utils/conv_probe.py``:
    (8,128,128,64) bf16, every row; returns its results and K4's launch
    counts, read around it."""
    from physics_informed_image_segmentation_tpu_torch.ops import conv_kernel as K4
    from physics_informed_image_segmentation_tpu_torch.utils import conv_probe

    K4.reset_launch_counts()
    res = conv_probe.run_probe(steps=PROBE_STEPS)
    torch.cuda.synchronize()
    counts = dict(K4.launch_counts)
    runs = conv_probe.WARMUP + conv_probe.TIMED
    # a fwd step launches the forward kernel once; a fwdbwd step launches it
    # twice (out and dx) and the dW kernels once
    expect = {"conv3x3_fwd": 3 * runs * PROBE_STEPS, "conv3x3_fwd_paired": 3 * runs * PROBE_STEPS,
              "conv3x3_dw": 2 * runs * PROBE_STEPS}
    print(f"conv probe: K4 launches {counts}")
    check(counts == expect, f"probe launches {counts}, expected {expect}")
    check(res["shape"] == [8, 128, 128, 64] and res["device"] == "gpu", f"probe ran {res['shape']}")
    for name, row in res["results"].items():
        for label, cell in row.items():
            check(np.isfinite(cell["us_per_step"]) and cell["us_per_step"] > 0,
                  f"probe {name} {label}: {cell}")
    return {"res": res, "counts": counts}


# The bench's analytic FLOPs at base 64, 128x128, batch 8, the count of the
# JAX repo's root bench.py at its defaults.
BENCH_FLOPS_AT_DEFAULTS = 544_890_421_248
REMAT_LOSS_RTOL = 1e-6


def run_script(main, argv) -> list:
    """A measurement script's ``main(argv)`` in this process: its standard
    output echoed, and every line of it parsed as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    check(rc == 0, f"{main.__module__} {argv} returned {rc}")
    lines = [json.loads(line) for line in text.splitlines()]
    check(bool(lines), f"{main.__module__} {argv} printed nothing")
    return lines


def reset_kernel_counts() -> None:
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2

    for k in (K1, K2, K3):
        k.reset_launch_counts()


def drive_benches(smi: str) -> dict:
    """The measurement entry points on the card, each cut in depth and run
    through its ``main`` as a user runs it: ``bench`` (64 images, 1 warm-up
    and 2 timed calls of 2 epochs; its kernel check), ``scripts.ab_bench``
    "adamw" against "pallas_adamw" (1 warm-up and 2 turns of 1 epoch),
    ``scripts.floor_bench`` (8 steps a rung), ``scripts.serve_bench`` (128
    images, batch 32), ``scripts.megapixel_bench`` (1024x1024, 2 steps, remat
    on and off) and ``scripts.sweep_bench`` (3 members, 1 epoch).  Every
    line they print must parse; K1's and K2's launches are counted around
    each run against the steps it took."""
    from physics_informed_image_segmentation_tpu_torch import bench
    from physics_informed_image_segmentation_tpu_torch.scripts import (
        ab_bench, floor_bench, megapixel_bench, serve_bench, sweep_bench,
    )
    from physics_informed_image_segmentation_tpu_torch.utils.measure import launch_counts

    out = {}
    t0 = time.perf_counter()
    check(bench.analytic_flops_per_step() == BENCH_FLOPS_AT_DEFAULTS,
          f"analytic FLOPs {bench.analytic_flops_per_step()} at the defaults")

    reset_kernel_counts()
    (line,) = run_script(bench.main, ["--images", "64", "--warmup", "1", "--rounds", "2",
                                      "--epochs", "2"])
    torch.cuda.synchronize()
    total = launch_counts()
    steps = (1 + 2) * 2 * (64 // 8)
    # the kernel check compares K1 and K3 with their plain versions, one
    # launch each way: a comparison, not the path
    checked = {"physics_sums_fwd": 1, "physics_sums_bwd": 1, "padded_physics_fwd": 1,
               "padded_physics_bwd": 1}
    counts = {k: v - checked.get(k, 0) for k, v in total.items()}
    print(f"bench path: {steps} train steps; launches {counts} ({total} with the kernel check)")
    check(counts["physics_sums_fwd"] == steps and counts["physics_sums_bwd"] == steps,
          f"bench: K1 launches {total}, expected {steps} / {steps} and the check's")
    check(counts["padded_physics_fwd"] == 0 and counts["padded_physics_bwd"] == 0,
          f"bench: K3 launches {total}, expected the check's alone")
    check(line["metric"] == "train_images_per_sec_per_chip" and line["kernel_check"] == "pass"
          and line["physics_backend"] == "cuda", f"bench line {line}")
    check(line["flops_per_step"] == BENCH_FLOPS_AT_DEFAULTS, "bench flops_per_step")
    check(line["launches_per_step"]["physics_sums_fwd"] == 1
          and line["launches_per_step"]["physics_sums_bwd"] == 1, "bench launches a step")
    if "H100" in torch.cuda.get_device_name(0):
        check(line["mfu"] is not None and 0 < line["mfu"] < 1, f"bench mfu {line['mfu']}")
    check(all(np.isfinite(v) and v > 0 for v in line["rounds"]), f"bench rounds {line}")
    out["bench"] = {"line": line, "counts": counts}

    reset_kernel_counts()
    lines = run_script(ab_bench.main, ["adamw", "pallas_adamw", "--images", "64", "--warmup",
                                       "1", "--rounds", "2", "--epochs", "1"])
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = (1 + 2) * (64 // 8)
    print(f"ab_bench path: {steps} train steps a variant; launches {counts}")
    check(counts["adamw"] == steps, f"ab_bench: K2 launches {counts}, expected {steps}")
    check(counts["physics_sums_fwd"] == 2 * steps and counts["physics_sums_bwd"] == 2 * steps,
          f"ab_bench: K1 launches {counts}")
    check(len(lines) == 3 and lines[1]["launches_per_step"]["adamw"] == 1
          and lines[0]["launches_per_step"]["adamw"] == 0, f"ab_bench lines {lines}")
    out["ab_bench"] = {"lines": lines, "counts": counts}

    reset_kernel_counts()
    lines = run_script(floor_bench.main, ["--steps", "8"])
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = (floor_bench.WARMUP + floor_bench.TIMED) * 8
    check(counts["physics_sums_fwd"] == 3 * steps and counts["physics_sums_bwd"] == 3 * steps,
          f"floor_bench: K1 launches {counts}, expected {3 * steps} (loss, opt, full)")
    ladder = lines[-1]["floor_ms_per_step"]
    check(list(ladder) == list(floor_bench.RUNGS) and all(v > 0 for v in ladder.values()),
          f"floor_bench ladder {ladder}")
    out["floor_bench"] = {"ladder": ladder, "counts": counts}

    lines = run_script(serve_bench.main, ["--images", "128", "--batch-size", "32"])
    check([ln["mode"] for ln in lines] == ["plain", "tta"], f"serve_bench lines {lines}")
    out["serve_bench"] = lines

    reset_kernel_counts()
    lines = run_script(megapixel_bench.main, ["1024", "2"])
    torch.cuda.synchronize()
    counts = launch_counts()
    on, off = lines
    check("error" not in on and "error" not in off, f"megapixel_bench: {lines}")
    check(counts["physics_sums_fwd"] == 8 and counts["physics_sums_bwd"] == 8,
          f"megapixel_bench: K1 launches {counts}, expected 8 / 8 (a warm-up step and 3 "
          f"steps, remat on and off)")
    gap = max(abs(a - b) / abs(b) for a, b in zip(on["losses"], off["losses"]))
    print(f"megapixel_bench: remat against no remat, losses {gap:.3e} relative; peak above the "
          f"start {on['peak_above_start_bytes']} against {off['peak_above_start_bytes']} bytes")
    check(gap <= REMAT_LOSS_RTOL, f"remat changes the losses by {gap:.3e}")
    check(on["peak_above_start_bytes"] < off["peak_above_start_bytes"],
          "remat does not lower the peak memory")
    out["megapixel_bench"] = {"lines": lines, "counts": counts, "loss_gap": gap}

    reset_kernel_counts()
    lines = run_script(sweep_bench.main, ["--members", "3", "--epochs", "1"])
    torch.cuda.synchronize()
    counts = launch_counts()
    train_b, val_b = -(-sweep_bench.N_TRAIN // 8), -(-sweep_bench.N_VAL // 8)
    # batched and serial, cold and warm: each member once a step each way
    exp_fwd, exp_bwd = 2 * 2 * 3 * (train_b + val_b), 2 * 2 * 3 * train_b
    check(counts["physics_sums_fwd"] == exp_fwd and counts["physics_sums_bwd"] == exp_bwd,
          f"sweep_bench: K1 launches {counts}, expected {exp_fwd} / {exp_bwd}")
    check([ln.get("mode") for ln in lines[:2]] == ["batched", "serial"],
          f"sweep_bench lines {lines}")
    out["sweep_bench"] = {"lines": lines, "counts": counts}
    out["seconds"] = time.perf_counter() - t0
    print(f"drive_benches: {out['seconds']:.1f} s  [{smi}]")
    return out


def k4_bound_ms(shape, itemsize: int, dw: bool) -> tuple[float, str]:
    """Least time for K4's work: the forward reads x and w and writes out,
    dW reads x and g and writes the float32 (9, Cin, Cout); or the
    2*B*H*W*9*Cin*Cout operations at the tensor cores' bf16 rate (the
    operands' type at the probe's shape), whichever is larger."""
    b, h, w, cin, cout = shape
    pixels = b * h * w
    if dw:
        nbytes = pixels * (cin + cout) * itemsize + 9 * cin * cout * 4
    else:
        nbytes = pixels * (cin + cout) * itemsize + 9 * cin * cout * itemsize
    flops = 2 * pixels * 9 * cin * cout
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_us_per_call(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn``, from ``torch.profiler`` over
    ``reps`` calls: ``{"total": µs, "kernels": {name: µs}}``.  It counts
    what ran on the card and leaves out the wrapper's time on the host.
    Where the profiler cannot trace the card, ``total`` is None: not
    measured."""
    from physics_informed_image_segmentation_tpu_torch.utils.profile_step import _device_time
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # what ran on the card, without the ranges that user annotations span there
    kernels = {e.key: _device_time(e) / reps for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_time(e) > 0
               and not getattr(e, "is_user_annotation", False)}
    return {"total": sum(kernels.values()) if kernels else None, "kernels": kernels}


# Device times are taken last: the phases that time calls with CUDA events or
# the host's clock queue their device-time readings here and main() takes them
# at the end, so that nothing is timed in a process that torch.profiler has
# already traced (check_profiler_cost measures what that would have added).
_device_jobs: list = []


def defer_device_time(label: str, fn, sink: dict, key: str, ms: float | None = None) -> None:
    """Queue ``sink[key] = device_us_per_call(fn)`` for the end of the run;
    ``ms`` is the call's time by CUDA events, printed beside it."""
    _device_jobs.append((label, fn, sink, key, ms))


def run_device_jobs() -> None:
    with torch.no_grad():
        for label, fn, sink, key, ms in _device_jobs:
            row = sink[key] = device_us_per_call(fn)
            print_device_time(label, row)
            if ms is not None and row["total"] is not None:
                print(f"    per call by CUDA events minus device time: "
                      f"{ms * 1e3 - row['total']:.1f} us")
    _device_jobs.clear()


def host_us_per_call(fn, reps: int = 1000) -> float:
    """Microseconds a call of ``fn`` takes in a run of ``reps`` calls queued
    back to back: host clock from a synchronise to the synchronise after the
    last call, so the larger of the host's and the card's time per call,
    without the cost of timing each call."""
    for _ in range(reps // 10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def print_device_time(label: str, row: dict) -> None:
    """One line for a :func:`device_us_per_call` result: the total and the
    device kernels of one call, each with its time."""
    if row["total"] is None:
        print(f"{label}: not measured (the profiler traced no kernel)")
        return
    parts = ", ".join(f"{k[:60]} {v:.2f}" for k, v in sorted(row["kernels"].items(),
                                                            key=lambda kv: -kv[1]))
    print(f"{label}: {row['total']:.2f} us in {len(row['kernels'])} device kernel(s) ({parts})")


def time_k4() -> dict:
    """K4 at the probe's shape (bf16): each kernel, its plain version and
    the library's call (``F.conv2d`` on channels-last operands;
    ``torch.nn.grad.conv2d_weight`` for dW), median ms of 30 calls; the
    device time per call of the kernels and the library's calls comes
    under ``"device_us"`` when :func:`run_device_jobs` runs."""
    from physics_informed_image_segmentation_tpu_torch.ops import conv_kernel as K4

    x, wt, cot = k4_case(PROBE_SHAPE, torch.bfloat16, seed=80, scale=0.05)
    w9 = wt.reshape(9, 64, 64)
    xn, gn = x.permute(0, 3, 1, 2), cot.permute(0, 3, 1, 2)
    wo = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    ww = wt.clone().requires_grad_(True)
    plain_out = K4.conv3x3_same_reference(x, ww)
    out = {}
    with torch.no_grad():
        lib_fwd = time_cuda(lambda: F.conv2d(xn, wo, padding=1))
        for name, paired in (("conv3x3_fwd", False), ("conv3x3_fwd_paired", True)):
            b_ms, b_by = k4_bound_ms(PROBE_SHAPE, 2, dw=False)
            out[name] = dict(
                ms=time_cuda(lambda: K4._launch_fwd(x, w9, paired)),
                plain_ms=time_cuda(lambda: K4.conv3x3_same_reference(x, wt, paired)),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_fwd)
        b_ms, b_by = k4_bound_ms(PROBE_SHAPE, 2, dw=True)
        out["conv3x3_dw"] = dict(
            ms=time_cuda(lambda: K4._launch_dw(x, cot)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_cuda(lambda: torch.nn.grad.conv2d_weight(xn, wo.shape, gn, padding=1)))
    out["conv3x3_dw"]["plain_ms"] = time_cuda(
        lambda: torch.autograd.grad(plain_out, ww, cot, retain_graph=True))
    for name, row in out.items():
        print(f"K4 {name} at (8,128,128,64->64) bf16: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
              f"library {row['library_ms']:.4f}, bound {row['bound_ms']:.5f} by {row['bound_by']})")
    device: dict = {}
    for name, fn in (
        ("conv3x3_fwd", lambda: K4._launch_fwd(x, w9, False)),
        ("conv3x3_fwd_paired", lambda: K4._launch_fwd(x, w9, True)),
        ("conv3x3_fwd as dx", lambda: K4._launch_dx(cot, w9, False)),
        ("conv3x3_dw", lambda: K4._launch_dw(x, cot)),
        ("F.conv2d", lambda: F.conv2d(xn, wo, padding=1)),
        ("conv2d_weight", lambda: torch.nn.grad.conv2d_weight(xn, wo.shape, gn, padding=1)),
    ):
        defer_device_time(f"K4 device time per call, {name}", fn, device, name)
    return {"rows": out, "device_us": device}


def drive_halo_path(smi: str) -> dict:
    """The data×space path at world 1: the megapixel step (1024x1024,
    base 64, bf16, 3 steps) through ``parallel/megapixel.py``; returns its
    result and K3's launch counts, read around it."""
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
    from physics_informed_image_segmentation_tpu_torch.parallel import megapixel
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2

    for k in (K1, K2, K3):
        k.reset_launch_counts()
    res = megapixel.run(1024, 64)
    torch.cuda.synchronize()
    counts = {**K1.launch_counts, **K2.launch_counts, **K3.launch_counts}
    print(f"megapixel halo step at world 1: 1024x1024, base 64, bf16, batch 1, 3 steps: losses "
          f"{res['losses']}; first step {res['first_step_ms']:.1f} ms, then "
          f"{res['ms_per_step']:.2f} ms/step; peak memory {res['peak_bytes'] / 2**30:.3f} GiB; "
          f"launches {counts}; {smi}")
    check(counts["padded_physics_fwd"] == 3 and counts["padded_physics_bwd"] == 3,
          f"expected 3 forward and 3 backward K3 launches, got {counts}")
    check(all(np.isfinite(v) for v in res["losses"]), f"non-finite losses {res['losses']}")
    check(res["peak_bytes"] > 0, "no peak memory measured")
    return {"res": res, "counts": counts}


def check_halo_step_against_unsharded() -> dict:
    """One f32 halo step at world 1 (128x128, base 64, batch 8, dropout on,
    deterministic cuDNN) against the unsharded K1 step from the same
    weights and dropout seed: |dloss| <= 5e-5 |loss|, params atol 1e-5."""
    from physics_informed_image_segmentation_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, shard_train_state,
    )
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, make_train_step_fn,
    )

    cfg = LossConfig(**STAGE2)
    mesh = make_mesh()
    data = blob_data(8, seed=9)
    with deterministic_f32():
        runs = {}
        for name in ("halo", "unsharded"):
            model = unet64()
            state = create_train_state(model, 1e-4, dropout_seed=5)
            if name == "halo":
                state = shard_train_state(state, mesh)
                step = make_sharded_train_step(cfg, mesh, spatial=True, halo_physics=True,
                                               precision="f32")
                state, loss = step(state, data.images, data.masks)
            else:
                step = make_train_step_fn(cfg, compute_metrics=False, precision="f32")
                state, out = step(state, data.images, data.masks, torch.ones(8, device="cuda"))
                loss = out["loss"]
            runs[name] = (float(loss), [p.detach().clone() for p in model.parameters()])
    (lh, ph), (lu, pu) = runs["halo"], runs["unsharded"]
    diff = max(float((a - b).abs().max()) for a, b in zip(ph, pu))
    print(f"halo step vs unsharded K1 step, 128x128, base 64, f32: losses {lh!r} / {lu!r} "
          f"(|dloss| {abs(lh - lu):.3e}), max|d params| {diff:.3e}")
    check(abs(lh - lu) <= 5e-5 * abs(lu), "the halo step's loss differs beyond 5e-5 relative")
    check(diff <= 1e-5, "the halo step's parameters differ beyond 1e-5")
    return {"dloss": abs(lh - lu), "loss": lu, "dparams": diff}


def drive_dp_epoch() -> dict:
    """One data-parallel epoch of ``make_sharded_epoch_fns`` through
    ``train_stage`` (128x128, base 64, batch 8, bf16, 4 steps + 1 val
    batch); returns K1's launch counts."""
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
    from physics_informed_image_segmentation_tpu_torch.parallel import (
        make_mesh, make_sharded_epoch_fns, shard_train_state,
    )
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, train_stage,
    )

    mesh = make_mesh()
    batch, steps = 8, 4
    train_data, val_data = blob_data(batch * steps, seed=10), blob_data(batch, seed=11)
    state = shard_train_state(create_train_state(unet64(), 1e-5), mesh)
    K1.reset_launch_counts()
    state, _, _, rows = train_stage(
        state, *make_sharded_epoch_fns(LossConfig(**STAGE2), mesh, precision="bf16"),
        train_data, val_data, batch_size=batch, num_epochs=1, stage_name="Stage II",
        shuffle_seed=0, verbose=False,
    )
    torch.cuda.synchronize()
    counts = dict(K1.launch_counts)
    print(f"data-parallel epoch at world 1 (make_sharded_epoch_fns, train_stage, base 64, "
          f"128x128, batch {batch}, bf16): K1 launches {counts}; train loss "
          f"{rows[0]['train_loss']:.6f}, val dice {rows[0]['val_dice_score']:.4f}")
    check(counts["physics_sums_fwd"] == steps + 1 and counts["physics_sums_bwd"] == steps,
          f"K1 launches on the data-parallel path: {counts}")
    check(all(np.isfinite(v) for v in rows[0].values()), f"non-finite metrics: {rows[0]}")
    return counts


def drive_spatial_epochs(smi: str) -> dict:
    """Space-sharded epochs at world 1: ``train_stage`` with
    ``make_sharded_epoch_fns(spatial=True)`` at base 64, 512x512, batch 2,
    bf16, 2 epochs of 2 steps and 1 validation batch, with K3's launches
    (forward once a train and validation batch, backward once a train
    step; K1 none) and the peak memory; then ``parallel/spatial_check.py``
    at base 64, 128x128, f32, dropout 0: the same stage against the
    unsharded epochs (K1) on the same plan."""
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
    from physics_informed_image_segmentation_tpu_torch.parallel import (
        make_mesh, make_sharded_epoch_fns, shard_train_state, spatial_check,
    )
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, train_stage,
    )

    mesh = make_mesh()
    size, batch, steps, epochs = 512, 2, 2, 2
    train_data = blob_data(batch * steps, seed=20, size=size)
    val_data = blob_data(batch, seed=21, size=size)
    state = shard_train_state(create_train_state(unet64(), 1e-5), mesh)
    fns = make_sharded_epoch_fns(LossConfig(**STAGE2), mesh, spatial=True, precision="bf16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    K1.reset_launch_counts()
    K3.reset_launch_counts()
    t0 = time.perf_counter()
    state, _, _, rows = train_stage(state, *fns, train_data, val_data, batch_size=batch,
                                    num_epochs=epochs, stage_name="Stage II", shuffle_seed=0,
                                    verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {**K1.launch_counts, **K3.launch_counts}
    peak = torch.cuda.max_memory_allocated()
    print(f"space-sharded epochs at world 1 (make_sharded_epoch_fns(spatial=True), train_stage, "
          f"base 64, {size}x{size}, batch {batch}, bf16, {epochs} epochs of {steps} steps + 1 "
          f"val batch): {seconds:.2f} s; launches {counts}; peak memory {peak / 2**30:.3f} GiB "
          f"({(peak - start_bytes) / 2**30:.3f} above the start); train loss "
          f"{[round(r['train_loss'], 6) for r in rows]}, val BF1 "
          f"{[round(r['val_boundary_f1_score'], 4) for r in rows]}; {smi}")
    check(counts["padded_physics_fwd"] == epochs * (steps + 1)
          and counts["padded_physics_bwd"] == epochs * steps,
          f"K3 launches on the space-sharded epochs: {counts}")
    check(counts["physics_sums_fwd"] == 0 and counts["physics_sums_bwd"] == 0,
          f"K1 launched on the space-sharded epochs: {counts}")
    check(all(np.isfinite(v) for r in rows for v in r.values()), f"non-finite metrics: {rows}")

    with deterministic_f32():
        res = spatial_check.run(128, 64, 1, batch=8, n_train=12, n_val=8, epochs=1)
    print(f"space-sharded epoch vs unsharded (K1) on the same plan, base 64, 128x128, f32, "
          f"dropout 0, 2 steps + 1 val batch: loss columns {res['loss_max_rel_diff']:.3e} rel "
          f"(bar {spatial_check.LOSS_RTOL}), IoU/BF1 {res['score_max_abs_diff']:.3e} (bar "
          f"{spatial_check.SCORE_ATOL}), Dice {res['dice_max_abs_diff']:.3e} (bar "
          f"{spatial_check.DICE_ATOL}), max|d params| {res['max_abs_dparam']:.3e} against a "
          f"movement of {res['movement']:.3e} (bar {spatial_check.PARAM_REL} of it; L2 "
          f"ratio {res['dparam_l2_over_movement_l2']:.3e}); the first batch's gradient, "
          f"sharded against whole: largest relative L2 {res['first_step_grad_max_rel_l2']:.3e} "
          f"({res['first_step_grad_worst']}); whole with the forward in two halves of the "
          f"batch: {res['halves_grad_max_rel_l2']:.3e} ({res['halves_grad_worst']})")
    check(res["ok"], "the space-sharded epoch differs from the unsharded one beyond its bars")
    return {"counts": counts, "seconds": seconds, "peak_bytes": peak,
            "peak_above_start_bytes": peak - start_bytes, "vs_unsharded": res}


def drive_parallel_paths(smi: str) -> dict:
    """Phases of the data×space path, in a world of one on NCCL."""
    import torch.distributed as dist

    from physics_informed_image_segmentation_tpu_torch.parallel import initialize_distributed

    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        initialize_distributed(f"file://{tmp}/store", world_size=1, rank=0)
        try:
            check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not NCCL")
            out = {"halo": drive_halo_path(smi)}
            out["vs_unsharded"] = check_halo_step_against_unsharded()
            out["dp_counts"] = drive_dp_epoch()
            out["spatial"] = drive_spatial_epochs(smi)
        finally:
            dist.destroy_process_group()
    return out


STREAM_N, STREAM_BATCH, STREAM_K = 40, 8, 4  # 5 steps: a chunk of 4, then 1 + 3 padding


BURNIN_IMAGES = (8, 4, 4, 4)  # training, validation, in_dist, out_dist


def drive_burnin(smi: str) -> dict:
    """The ``--ablation`` crash/resume burn-in (``scripts.ablation_burnin``)
    at full width (base 64, 128x128, bf16), cut in depth: ``--ablation R1``,
    8/4/4+4 images, 1+1 epochs, each run a fresh process of the CLI under
    the script's launch.  Run A uninterrupted; run B SIGKILLed once R1 has
    written its first variant JSON (1-3 of 4 at the kill), then relaunched
    with ``--resume latest``; the aggregates must be bit-equal after the
    JAX script's path and timestamp fields.  K1's launches are the counts
    each finished process printed: 2 / 1 a physics variant (one train step
    and one validation batch), none in a killed process."""
    from physics_informed_image_segmentation_tpu_torch.scripts import ablation_burnin as burnin

    t0 = time.perf_counter()
    scratch = REPO / "build"  # git-ignored
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        cfg = burnin.Burnin(data_root=Path(tmp) / "data", work=Path(tmp) / "work",
                            ablation="R1", images=BURNIN_IMAGES, epochs=1)
        facts = {"card": smi}
        burnin.make_data(cfg)
        cfg.work.mkdir()
        a = burnin.run_a(cfg, facts)
        b = burnin.run_b(cfg, facts)
        line = burnin.report(cfg, facts)
    n_var = len(burnin.ALL_STUDIES["R1"]())
    check(1 <= b["variants_at_kill"] < n_var,
          f"burn-in: the kill landed with {b['variants_at_kill']} R1 variants written")
    check(line["report"] == "1/1", f"burn-in report {line}")
    (ka,), (kb,) = a["k1_launches"], b["k1_launches"]
    retrained = n_var - b["variants_at_kill"]  # R1.0, the one without physics, runs first
    check(ka == {"physics_sums_fwd": 6, "physics_sums_bwd": 3},
          f"burn-in run A: K1 launches {ka}, expected 6 / 3 (R1.1-R1.3)")
    check(kb == {"physics_sums_fwd": 2 * retrained, "physics_sums_bwd": retrained},
          f"burn-in run B resumed: K1 launches {kb}, expected {2 * retrained} / {retrained}")
    seconds = time.perf_counter() - t0
    print(f"drive_burnin: R1 killed with {b['variants_at_kill']} of {n_var} variants written and "
          f"resumed, aggregate bit-equal to the uninterrupted run; K1 {ka} / {kb}; launch "
          f"{a['launch']}; {seconds:.1f} s  [{smi}]")
    return {"run_a": a, "run_b": b, "report": line, "seconds": seconds}


def drive_stream_rows(smi: str) -> dict:
    """``scripts.stream_train`` through its ``main`` at full width, cut to
    64 images and one round: resident, stream-step and stream-chunk-16, each
    with K1 once each way a real step."""
    from physics_informed_image_segmentation_tpu_torch.scripts import stream_train
    from physics_informed_image_segmentation_tpu_torch.utils.measure import launch_counts

    t0 = time.perf_counter()
    n = 64
    reset_kernel_counts()
    lines = run_script(stream_train.main, ["--images", str(n), "--rounds", "1"])
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = sum(w + t for w, t in stream_train.EPOCHS.values()) * (n // 8)
    check([ln["row"] for ln in lines] == list(stream_train.ROWS), f"stream_train lines {lines}")
    for ln in lines:
        check(ln["k1_launches_per_step"] == {"physics_sums_fwd": 1.0, "physics_sums_bwd": 1.0},
              f"stream_train {ln['row']}: K1 launches a step {ln['k1_launches_per_step']}")
        check(ln["images_a_round"] == [n * ln["timed_epochs"]] and ln["value"] > 0,
              f"stream_train {ln['row']}: {ln}")
    check(counts["physics_sums_fwd"] == steps and counts["physics_sums_bwd"] == steps,
          f"stream_train: K1 launches {counts}, expected {steps} / {steps}")
    seconds = time.perf_counter() - t0
    print(f"drive_stream_rows: {steps} real steps, K1 {counts['physics_sums_fwd']} / "
          f"{counts['physics_sums_bwd']}; img/s "
          f"{ {ln['row']: round(ln['value'], 1) for ln in lines} }; {seconds:.1f} s  [{smi}]")
    return {"lines": lines, "counts": counts, "seconds": seconds}


def drive_quant(smi: str) -> dict:
    """``scripts.quant_probe``: the int8 convolution against float64 (error
    exactly 0) and the four rows at one stage shape, (128,16,16,512->512)."""
    from physics_informed_image_segmentation_tpu_torch.scripts import quant_probe

    t0 = time.perf_counter()
    check_line, shape_line = run_script(quant_probe.main, ["--shapes", "3"])
    check(check_line["max_abs_err"] == 0.0, f"int8 conv error {check_line['max_abs_err']}")
    check(shape_line["shape"] == list(quant_probe.SHAPES[3])
          and all(r["ms"] > 0 for r in shape_line["rows"].values()), f"quant_probe {shape_line}")
    seconds = time.perf_counter() - t0
    print(f"drive_quant: int8 conv exact; at {shape_line['shape']} int8/bf16 speed "
          f"{shape_line['int8_over_bf16_speed']}; {seconds:.1f} s  [{smi}]")
    return {"check": check_line, "shape": shape_line, "seconds": seconds}


def drive_quickstart(smi: str) -> dict:
    """``examples.quickstart_synthetic.main`` at full width, cut to 8/4/4
    images and 1+1 epochs: finite Dice, 4 masks written, K1 2 / 1 (Stage
    II's train step and validation batch)."""
    from physics_informed_image_segmentation_tpu_torch.examples import quickstart_synthetic
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1

    t0 = time.perf_counter()
    scratch = REPO / "build"  # git-ignored
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        K1.reset_launch_counts()
        with quiet():
            res = quickstart_synthetic.main(Path(tmp) / "run", "cuda", n_train=8, n_val=4,
                                            n_test=4, stage1_epochs=1, stage2_epochs=1)
        torch.cuda.synchronize()
        counts = dict(K1.launch_counts)
        masks = [p for p in res["masks"] if p.exists()]
    check(all(np.isfinite(v) for v in res["dice"].values()), f"quickstart Dice {res['dice']}")
    check(len(masks) == 4, f"quickstart wrote {len(masks)} masks, expected 4")
    check(counts == {"physics_sums_fwd": 2, "physics_sums_bwd": 1},
          f"quickstart: K1 launches {counts}, expected 2 / 1")
    seconds = time.perf_counter() - t0
    print(f"drive_quickstart: Dice {res['dice']}, 4 masks, K1 {counts}; {seconds:.1f} s  [{smi}]")
    return {"dice": res["dice"], "counts": counts, "seconds": seconds}


def drive_streaming(smi: str) -> dict:
    """The streamed path at full width: ``HostDataset`` of ``make_blobs``
    (128x128) → ``batch_iterator`` (batch 8) → ``chunk_batches(k=4)`` (the
    last chunk padded) → ``prefetch_to_device`` (pinned memory, side stream)
    → ``make_train_chunk_fn`` with the Stage II objective and
    "pallas_adamw", base 64, bf16: K1 once each way a real step, K2 once a
    real step and never on a padding step.  Then f32, dropout 0: the
    streamed chunks against the resident epoch on the same order; D4 codes
    drawn on the card.  The streamed rows are timed in ``drive_stream_rows``."""
    from physics_informed_image_segmentation_tpu_torch import UNet
    from physics_informed_image_segmentation_tpu_torch.data import (
        DeviceDataset, HostDataset, batch_iterator, chunk_batches, d4_augment, make_blobs,
        prefetch_to_device,
    )
    from physics_informed_image_segmentation_tpu_torch.data.augment import d4_apply
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
    from physics_informed_image_segmentation_tpu_torch.train import (
        LossConfig, create_train_state, make_train_chunk_fn, make_train_epoch_fn,
        make_train_step_fn,
    )
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2

    cfg = LossConfig(**STAGE2)
    images, masks = make_blobs(STREAM_N, 128, 128, seed=30)
    host = HostDataset(STREAM_N, images, masks)
    real = -(-STREAM_N // STREAM_BATCH)

    def streamed(state, chunk_fn):
        outs = []
        batches = batch_iterator(host, STREAM_BATCH, shuffle=True, seed=0, epoch=0)
        for xs, ys, vs in prefetch_to_device(chunk_batches(batches, STREAM_K), device="cuda"):
            state, out = chunk_fn(state, xs, ys, vs)
            outs.append(out)
        return state, outs

    def resident_plan(n):
        order = np.arange(n)
        np.random.default_rng(np.random.SeedSequence([0, 0])).shuffle(order)
        nb = -(-n // STREAM_BATCH)
        pad = nb * STREAM_BATCH - n
        idx = np.concatenate([order, np.zeros(pad, order.dtype)]).reshape(nb, STREAM_BATCH)
        valid = np.concatenate([np.ones(n), np.zeros(pad)]).reshape(nb, STREAM_BATCH)
        return (torch.tensor(idx, device="cuda"),
                torch.tensor(valid, dtype=torch.float32, device="cuda"))

    # launches at bf16
    state = create_train_state(unet64(), 1e-5, optimizer="pallas_adamw")
    K1.reset_launch_counts()
    K2.reset_launch_counts()
    state, outs = streamed(state, make_train_chunk_fn(cfg, precision="bf16"))
    torch.cuda.synchronize()
    counts = {**K1.launch_counts, **K2.launch_counts}
    losses = torch.cat([o["loss"] for o in outs]).cpu()
    n_col = torch.cat([o["n"] for o in outs]).cpu()
    print(f"streamed chunks (HostDataset → batch_iterator → chunk_batches(k={STREAM_K}) → "
          f"prefetch_to_device → make_train_chunk_fn, pallas_adamw, base 64, 128x128, batch "
          f"{STREAM_BATCH}, bf16): {len(outs)} chunks, {real} real steps and "
          f"{len(outs) * STREAM_K - real} padding steps; launches {counts}; step losses "
          f"{[round(float(v), 6) for v in losses]}")
    check(counts["adamw"] == real and state.step == real,
          f"expected {real} K2 launches and steps (none on padding), got {counts}, {state.step}")
    check(counts["physics_sums_fwd"] == real and counts["physics_sums_bwd"] == real,
          f"K1 launches on the streamed path: {counts}")
    check(bool(torch.isfinite(losses[:real]).all()) and bool(torch.isnan(losses[real:]).all())
          and float(n_col[real:].sum()) == 0.0, "streamed step metrics malformed")

    # f32, dropout 0: streamed chunks against the resident epoch on the same order
    data = DeviceDataset.from_numpy(images, masks, "cuda")
    with deterministic_f32():
        final = {}
        start = None
        for name in ("streamed", "resident"):
            model = UNet(base_channels=64, dropout=0.0,
                         generator=torch.Generator().manual_seed(0)).cuda()
            if start is None:
                start = [p.detach().clone() for p in model.parameters()]
            st = create_train_state(model, 1e-4, optimizer="pallas_adamw")
            if name == "streamed":
                st, outs = streamed(st, make_train_chunk_fn(cfg, precision="f32"))
                loss = float(torch.cat([o["loss"] for o in outs])[:real].double().mean())
            else:
                idx, valid = resident_plan(STREAM_N)
                st, res = make_train_epoch_fn(cfg, precision="f32")(
                    st, data.images, data.masks, idx, valid)
                loss = res["loss"]
            final[name] = ([p.detach().clone() for p in model.parameters()], loss)
    (ps, ls), (pr, lr_) = final["streamed"], final["resident"]
    gap = max(float((a - b).abs().max()) for a, b in zip(ps, pr))
    move = max(float((a - b).abs().max()) for a, b in zip(pr, start))
    print(f"streamed vs resident epoch, f32, dropout 0, same order: losses {ls!r} / {lr_!r}, "
          f"max|d params| {gap:.3e} against a movement of {move:.3e}")
    check(abs(ls - lr_) <= 1e-5 * abs(lr_) and gap <= 1e-3 * move,
          "the streamed chunks differ from the resident epoch beyond rounding")

    # D4 codes drawn on the card's generator, the same to image and mask
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    saved = gen.get_state()
    x, y = data.images[:STREAM_BATCH], data.masks[:STREAM_BATCH]
    xa, ya = d4_augment(gen, x, y)
    again = torch.Generator(device="cuda")
    again.set_state(saved)
    codes = torch.randint(0, 8, (STREAM_BATCH,), generator=again, device="cuda").tolist()
    for b, c in enumerate(codes):
        check(torch.equal(xa[b:b + 1], d4_apply(x[b:b + 1], c))
              and torch.equal(ya[b:b + 1], d4_apply(y[b:b + 1], c)),
              f"d4_augment sample {b}: not code {c} on image and mask")
    step = make_train_step_fn(cfg, precision="bf16", augment=d4_augment)
    state, out = step(state, x, y, torch.ones(STREAM_BATCH, device="cuda"))
    check(bool(torch.isfinite(out["loss"])), "augmented step loss not finite")
    print(f"d4_augment on the card: codes {codes}, image and mask alike; a step with "
          f"augment=d4_augment trained")
    return {"counts": counts, "stream_vs_resident": {"dloss": abs(ls - lr_), "dparams": gap,
                                                     "movement": move}, "card": smi}


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


def bound_ms(n_pixels: int, batch: int, bwd: bool, need_dt: bool = True) -> tuple[float, str]:
    """Least time for the work on this card: bytes moved (each input read
    once, each output written once) or float32 operations, whichever is
    larger."""
    if bwd:  # read u, t, m, cot; write du and, where the target needs it, dt
        nbytes = (4 if need_dt else 3) * n_pixels * 4 + batch * 4 + batch * 24
        flops = BWD_FLOPS_PER_PIXEL * n_pixels
    else:  # read u, t, m; write sums
        nbytes = 2 * n_pixels * 4 + batch * 4 + batch * 24
        flops = FWD_FLOPS_PER_PIXEL * n_pixels
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels() -> dict:
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    out = {}
    for shape in ((8, 128, 128), (8, 512, 512), (1, 1024, 1024)):
        u, t, m, cot = make_case(shape, seed=100)
        args = (D, A, EPS, True)
        # the tensors are bound now: the device-time readings call these after the loop
        fwd = lambda u=u, t=t, m=m: K._launch_fwd(u, t, m, *args)
        bwd = lambda u=u, t=t, m=m, cot=cot: K._launch_bwd(u, t, m, cot, *args, need_dt=True)
        bwd_du = lambda u=u, t=t, m=m, cot=cot: K._launch_bwd(u, t, m, cot, *args,
                                                              need_dt=False)
        with torch.no_grad():
            plain_fwd = lambda: K.fused_physics_sums_reference(u, t, m, *args)
            k_fwd, p_fwd = time_cuda(fwd), time_cuda(plain_fwd)
        k_bwd, k_bwd_du = time_cuda(bwd), time_cuda(bwd_du)
        uu, tt = u.clone().requires_grad_(True), t.clone().requires_grad_(True)
        sums = K.fused_physics_sums_reference(uu, tt, m, *args)
        p_bwd = time_cuda(lambda: torch.autograd.grad(sums, (uu, tt), cot, retain_graph=True))
        n = shape[0] * shape[1] * shape[2]
        b_fwd, b_fwd_by = bound_ms(n, shape[0], bwd=False)
        b_bwd, b_bwd_by = bound_ms(n, shape[0], bwd=True)
        b_bwd_du, b_bwd_du_by = bound_ms(n, shape[0], bwd=True, need_dt=False)
        queued = {"fwd": host_us_per_call(fwd), "bwd": host_us_per_call(bwd),
                  "bwd_no_dt": host_us_per_call(bwd_du)}
        device: dict = {}
        for name, fn, ms in (("fwd", fwd, k_fwd), ("bwd", bwd, k_bwd),
                             ("bwd_no_dt", bwd_du, k_bwd_du)):
            defer_device_time(f"K1 device time per call at {shape}, {name}", fn, device, name, ms)
        out[shape] = dict(fwd=k_fwd, plain_fwd=p_fwd, bound_fwd=b_fwd, bound_fwd_by=b_fwd_by,
                          bwd=k_bwd, plain_bwd=p_bwd, bound_bwd=b_bwd, bound_bwd_by=b_bwd_by,
                          bwd_no_dt=k_bwd_du, bound_bwd_no_dt=b_bwd_du, device_us=device,
                          queued_us=queued,
                          tile_plan=tuple(K.tile_plan(*shape)))
        print(f"K1 times at {shape} (tiles {tuple(K.tile_plan(*shape))}): fwd {k_fwd:.4f} ms "
              f"(plain {p_fwd:.4f}, bound {b_fwd:.5f} by {b_fwd_by}); bwd {k_bwd:.4f} ms (plain "
              f"{p_bwd:.4f}, bound {b_bwd:.5f} by {b_bwd_by}); bwd without dt {k_bwd_du:.4f} ms "
              f"(bound {b_bwd_du:.5f} by {b_bwd_du_by})")
        print(f"    in a run of 1000 calls queued back to back, us a call (the larger of the "
              f"host's and the card's time): {queued}")
    print("library_ms: no single PyTorch call computes K1's function, so there is no "
          "library yardstick (null)")
    return out


def k3_bound_ms(shape, bwd: bool) -> tuple[float, str]:
    """Least time for K3's work: p read once (and dp written once in the
    backward), or its float32 operations, whichever is larger."""
    b, hp, wp = shape
    padded, interior = b * hp * wp, b * (hp - 2) * (wp - 2)
    if bwd:  # read p and cot, write dp
        nbytes, flops = 2 * padded * 4 + b * 8, K3_BWD_FLOPS_PER_PIXEL * interior
    else:  # read p, write sums
        nbytes, flops = padded * 4 + b * 8, K3_FWD_FLOPS_PER_PIXEL * interior
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_k3() -> dict:
    """K3 at the megapixel block and the training block: ms per wrapper
    call by CUDA events, µs a call in a run of queued calls, and (under
    ``"device_us"`` when :func:`run_device_jobs` runs) device µs and
    device kernels per call."""
    from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3

    out = {}
    for shape in ((1, 1026, 1026), (8, 130, 130)):
        p, cot = k3_case(shape, seed=60)
        args = (D, A, EPS, True)
        # the tensors are bound now: the device-time readings call these after the loop
        fwd = lambda p=p: K3._launch_fwd(p, *args)
        bwd = lambda p=p, cot=cot: K3._launch_bwd(p, cot, *args)
        with torch.no_grad():
            k_fwd = time_cuda(fwd)
            p_fwd = time_cuda(lambda: K3.padded_physics_sums_reference(p, *args))
        k_bwd = time_cuda(bwd)
        pp = p.clone().requires_grad_(True)
        sums = K3.padded_physics_sums_reference(pp, *args)
        p_bwd = time_cuda(lambda: torch.autograd.grad(sums, pp, cot, retain_graph=True))
        b_fwd, b_fwd_by = k3_bound_ms(shape, bwd=False)
        b_bwd, b_bwd_by = k3_bound_ms(shape, bwd=True)
        queued = {"fwd": host_us_per_call(fwd), "bwd": host_us_per_call(bwd)}
        device: dict = {}
        for name, fn, ms in (("fwd", fwd, k_fwd), ("bwd", bwd, k_bwd)):
            defer_device_time(f"K3 device time per call at {shape}, {name}", fn, device, name, ms)
        out[shape] = dict(fwd=k_fwd, plain_fwd=p_fwd, bound_fwd=b_fwd, bound_fwd_by=b_fwd_by,
                          bwd=k_bwd, plain_bwd=p_bwd, bound_bwd=b_bwd, bound_bwd_by=b_bwd_by,
                          queued_us=queued, device_us=device,
                          tile_plan=tuple(K3.tile_plan(shape[0], shape[1] - 2, shape[2] - 2)),
                          copy_bytes=K3.copy_bytes(p))
        print(f"K3 times at {shape} (tiles {out[shape]['tile_plan']}, {out[shape]['copy_bytes']}"
              f"-byte copies): fwd {k_fwd:.4f} ms (plain {p_fwd:.4f}, bound {b_fwd:.5f} by "
              f"{b_fwd_by}); bwd {k_bwd:.4f} ms (plain {p_bwd:.4f}, bound {b_bwd:.5f} by "
              f"{b_bwd_by})")
        print(f"    in a run of 1000 calls queued back to back, us a call (the larger of the "
              f"host's and the card's time): {queued}")
    print("library_ms: no single PyTorch call computes K3's function (null)")
    return out


def check_k3_device_kernels(k3_times: dict) -> None:
    """After :func:`run_device_jobs`: one device kernel a K3 call each way."""
    for shape, row in k3_times.items():
        for name, reading in row["device_us"].items():
            if reading["total"] is None:
                print(f"K3 device kernels a call at {shape}, {name}: not measured")
                continue
            check(len(reading["kernels"]) == 1,
                  f"K3 {name} at {shape} ran {len(reading['kernels'])} device kernels a call")


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
    device: dict = {}
    for name in ("kernel", "library"):
        defer_device_time(f"K2 device time per step(), {name}", fns[name], device, name,
                          statistics.mean(runs[name]))
    # an empty kernel queue: what the host spends on a step when the card does not hold it up
    host = {}
    for name in ("kernel", "library"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fns[name]()
        host[name] = (time.perf_counter() - t0) / 10 * 1e6
        torch.cuda.synchronize()
    print(f"K2 host time of a step() in a run of 10 that the card does not hold up, us: {host}")
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
    out["device_us"] = device
    out["host_us"] = host
    print(f"K2 times over {n} params in {len(params)} tensors, ms per step() (two medians "
          f"each): kernel {runs['kernel']}, plain _foreach {runs['plain']}, "
          f"torch.optim.AdamW(fused=True) {runs['library']}; bound {out['bound']:.5f} ms by "
          f"{out['bound_by']}; {launches_per_step:g} launches per step")
    return out


def check_profiler_cost() -> dict:
    """K1's forward in a run of queued calls once more, now that
    torch.profiler has traced the card in this process: what every timing
    taken after a profile would carry."""
    from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

    u, t, m, _ = make_case((8, 128, 128), seed=100)
    after = host_us_per_call(lambda: K._launch_fwd(u, t, m, D, A, EPS, True))
    print(f"K1 fwd at (8,128,128) in a run of 1000 queued calls after torch.profiler was used in "
          f"this process: {after:.1f} us a call")
    return {"k1_fwd_queued_us_after_profiler": after}


def time_training(optimizer: str) -> float:
    """Steady-state Stage II train img/s at full width: the bench's
    workload (``bench.make_workload``: base 64, 128x128, batch 8, bf16, lr
    1e-4, metrics on) cut to 64 images, one epoch a call."""
    from physics_informed_image_segmentation_tpu_torch import bench

    n = 64
    wl = bench.make_workload("cuda", n_images=n, epochs=1, optimizer=optimizer, calls="epoch")
    rates = []
    for i in range(4):  # the first epoch is warm-up
        seconds, _ = bench.timed_call(wl, torch.device("cuda"))
        if i > 0:
            rates.append(n / seconds)
    rate = statistics.median(rates)
    print(f"Stage II train steady state, {optimizer}: {rate:.1f} img/s (median of {len(rates)} "
          f"epochs of {wl.steps_per_call} steps; base_channels 64, 128x128, "
          f"batch {bench.BATCH_SIZE}, bf16)")
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
    built = build_all(["physics_sums", "adamw", "padded_physics", "conv3x3", "group_norm",
                       "layer_norm"], verbose=True)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    errors = check_kernels()
    errors["adamw"] = check_adamw()
    torch.cuda.synchronize()
    check_unet()
    torch.cuda.synchronize()
    (REPO / "build").mkdir(exist_ok=True)  # git-ignored
    served_model = REPO / "build" / "smoke_unet_pde_regularized.pth"
    try:
        counts = drive_main_path(served_model)
        torch.cuda.synchronize()
        serving = drive_serving(served_model)
    finally:
        served_model.unlink(missing_ok=True)
    torch.cuda.synchronize()
    experiments = drive_experiments(smi)
    torch.cuda.synchronize()
    sweep = drive_sweep(smi)
    torch.cuda.synchronize()
    compat = drive_compat(smi)
    torch.cuda.synchronize()
    k2_counts = drive_adamw_path()
    check_adamw_path_bit_equal()
    check_resume_engine()
    check_resume_train()
    torch.cuda.synchronize()
    errors.update(check_k3())
    check_k3_against_k1()
    errors.update(check_k4())
    errors.update(check_group_norm())
    gn_counts = drive_resnet_norms()
    errors.update(check_layer_norm())
    ln_counts = drive_swin_norms()
    parallel = drive_parallel_paths(smi)
    streaming = drive_streaming(smi)
    probe = drive_probe()
    benches = drive_benches(smi)
    burnin = drive_burnin(smi)
    stream_rows = drive_stream_rows(smi)
    quant = drive_quant(smi)
    quickstart = drive_quickstart(smi)
    times = time_kernels()
    k3_times = time_k3()
    k4_times = time_k4()
    k2_times = time_adamw()
    gn_times = time_group_norm()
    ln_times = time_layer_norm()
    rates = {name: [] for name in ("adamw", "pallas_adamw")}
    for name in ("adamw", "pallas_adamw", "pallas_adamw", "adamw"):
        rates[name].append(time_training(name))
    torch.cuda.synchronize()
    run_device_jobs()
    check_k3_device_kernels(k3_times)
    profiler_left = check_profiler_cost()
    torch.cuda.synchronize()

    main_shape = times[(8, 128, 128)]
    src = f"{PKG}/csrc/physics_sums.cu"
    kernels = [
        {"name": "physics_sums_fwd", "route": "cuda", "source": src,
         "replaces": "physics_informed_image_segmentation_tpu/ops/pallas_physics.py:245",
         "launches": counts["physics_sums_fwd"],
         "sweep_launches": sweep["k1_launches"]["physics_sums_fwd"],
         "compat_launches": compat["counts"]["physics_sums_fwd"],
         "streaming_launches": streaming["counts"]["physics_sums_fwd"],
         "spatial_epochs_launches": parallel["spatial"]["counts"]["physics_sums_fwd"],
         "bench_launches": benches["bench"]["counts"]["physics_sums_fwd"],
         "megapixel_launches": benches["megapixel_bench"]["counts"]["physics_sums_fwd"],
         "burnin_launches": [burnin[r]["k1_launches"][0]["physics_sums_fwd"]
                             for r in ("run_a", "run_b")],
         "stream_rows_launches": stream_rows["counts"]["physics_sums_fwd"],
         "quickstart_launches": quickstart["counts"]["physics_sums_fwd"],
         "max_abs_err": errors["physics_sums_fwd"],
         "ms": main_shape["fwd"], "plain_ms": main_shape["plain_fwd"],
         "bound_ms": main_shape["bound_fwd"], "bound_by": main_shape["bound_fwd_by"],
         "library_ms": None},
        {"name": "physics_sums_bwd", "route": "cuda", "source": src,
         "replaces": "physics_informed_image_segmentation_tpu/ops/pallas_physics.py:262",
         "launches": counts["physics_sums_bwd"],
         "sweep_launches": sweep["k1_launches"]["physics_sums_bwd"],
         "compat_launches": compat["counts"]["physics_sums_bwd"],
         "streaming_launches": streaming["counts"]["physics_sums_bwd"],
         "spatial_epochs_launches": parallel["spatial"]["counts"]["physics_sums_bwd"],
         "bench_launches": benches["bench"]["counts"]["physics_sums_bwd"],
         "megapixel_launches": benches["megapixel_bench"]["counts"]["physics_sums_bwd"],
         "burnin_launches": [burnin[r]["k1_launches"][0]["physics_sums_bwd"]
                             for r in ("run_a", "run_b")],
         "stream_rows_launches": stream_rows["counts"]["physics_sums_bwd"],
         "quickstart_launches": quickstart["counts"]["physics_sums_bwd"],
         "max_abs_err": errors["physics_sums_bwd"],
         "ms": main_shape["bwd"], "plain_ms": main_shape["plain_bwd"],
         "bound_ms": main_shape["bound_bwd"], "bound_by": main_shape["bound_bwd_by"],
         "library_ms": None},
        {"name": "adamw", "route": "cuda", "source": f"{PKG}/csrc/adamw.cu",
         "replaces": "physics_informed_image_segmentation_tpu/train/pallas_optim.py:118",
         "launches": k2_counts["adamw"], "streaming_launches": streaming["counts"]["adamw"],
         "bench_launches": benches["ab_bench"]["counts"]["adamw"],
         "max_abs_err": errors["adamw"],
         "ms": k2_times["kernel"], "plain_ms": k2_times["plain"],
         "bound_ms": k2_times["bound"], "bound_by": k2_times["bound_by"],
         "library_ms": k2_times["library"]},
    ]
    mp = k3_times[(1, 1026, 1026)]
    halo_counts = parallel["halo"]["counts"]
    for direction in ("fwd", "bwd"):
        kernels.append({
            "name": f"padded_physics_{direction}", "route": "cuda",
            "source": f"{PKG}/csrc/padded_physics.cu",
            "replaces": "physics_informed_image_segmentation_tpu/ops/pallas_physics.py:"
                        + ("390" if direction == "fwd" else "405"),
            "launches": halo_counts[f"padded_physics_{direction}"],
            "spatial_epochs_launches":
                parallel["spatial"]["counts"][f"padded_physics_{direction}"],
            "max_abs_err": errors[f"padded_physics_{direction}"],
            "ms": mp[direction], "plain_ms": mp[f"plain_{direction}"],
            "bound_ms": mp[f"bound_{direction}"], "bound_by": mp[f"bound_{direction}_by"],
            "library_ms": None})
    k4_lines = {"conv3x3_fwd": "212", "conv3x3_fwd_paired": "212", "conv3x3_dw": "232"}
    for name, line in k4_lines.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/conv3x3.cu",
            "replaces": f"physics_informed_image_segmentation_tpu/ops/pallas_conv.py:{line}",
            "launches": probe["counts"][name], "max_abs_err": errors[name],
            **k4_times["rows"][name]})
    gn_root = gn_times["root"]
    for direction in ("fwd", "bwd"):
        kernels.append({
            "name": f"group_norm_{direction}", "route": "cuda",
            "source": f"{PKG}/csrc/group_norm.cu",
            "replaces": None, "launches": gn_counts[f"group_norm_{direction}"],
            "max_abs_err": errors[f"group_norm_{direction}"],
            "ms": gn_root[f"{direction}_ms"], "bound_ms": gn_root[f"floor_{direction}_ms"],
            "bound_by": "bytes", "plain_ms": None,
            "library_ms": gn_root[f"plain_{direction}_ms"]})
    print(json.dumps({"group_norm_ms_per_call": gn_times, "card": smi}))
    ln_x4 = ln_times["x4 expand"]
    for direction in ("fwd", "bwd"):
        kernels.append({
            "name": f"layer_norm_{direction}", "route": "cuda",
            "source": f"{PKG}/csrc/layer_norm.cu",
            "replaces": None, "launches": ln_counts[f"layer_norm_{direction}"],
            "max_abs_err": errors[f"layer_norm_{direction}"],
            "ms": ln_x4[f"{direction}_ms"], "bound_ms": ln_x4[f"floor_{direction}_ms"],
            "bound_by": "bytes", "plain_ms": ln_x4[f"plain_{direction}_ms"],
            "library_ms": ln_x4[f"library_{direction}_ms"]})
    print(json.dumps({"layer_norm_ms_per_call": ln_times, "card": smi}))
    mres = parallel["halo"]["res"]
    print(json.dumps({"megapixel_step": {
        "image": mres["image"], "base_channels": 64, "precision": "bf16", "batch": 1,
        "first_step_ms": mres["first_step_ms"], "ms_per_step": mres["ms_per_step"],
        "peak_bytes": mres["peak_bytes"]}, "halo_vs_unsharded": parallel["vs_unsharded"],
        "card": smi}))
    print(json.dumps({"stage2_train_img_per_s": rates, "card": smi}))
    print(json.dumps({"serving": serving, "conv_probe": probe["res"], "card": smi}))
    print(json.dumps({"k1_device_us_per_call": {str(k): v["device_us"] for k, v in times.items()},
                      "k1_ms_per_call": {str(k): {n: v[n] for n in ("fwd", "bwd", "bwd_no_dt")}
                                         for k, v in times.items()},
                      "k1_bound_ms": {str(k): {n: v[f"bound_{n}"] for n in ("fwd", "bwd", "bwd_no_dt")}
                                      for k, v in times.items()},
                      "k1_queued_us_per_call": {str(k): v["queued_us"] for k, v in times.items()},
                      "k2_device_us_per_step": k2_times["device_us"],
                      "k2_host_us_per_step": k2_times["host_us"], **profiler_left,
                      "card": smi}))
    k3 = {str(k): v for k, v in k3_times.items()}
    print(json.dumps({"k3_device_us_per_call": {k: v["device_us"] for k, v in k3.items()},
                      "k3_ms_per_call": {k: {n: v[n] for n in ("fwd", "bwd")}
                                         for k, v in k3.items()},
                      "k3_bound_ms": {k: {n: v[f"bound_{n}"] for n in ("fwd", "bwd")}
                                      for k, v in k3.items()},
                      "k3_queued_us_per_call": {k: v["queued_us"] for k, v in k3.items()},
                      "k3_copy_bytes": {k: v["copy_bytes"] for k, v in k3.items()},
                      "card": smi}))
    print(json.dumps({"k4_device_us_per_call": k4_times["device_us"],
                      "shape": "(8,128,128,64->64) bf16", "card": smi}))
    print(json.dumps({"experiments": experiments}))
    print(json.dumps({"sweep": sweep}))
    print(json.dumps({"compat": compat}))
    print(json.dumps({"benches": benches, "card": smi}))
    print(json.dumps({"burnin": burnin, "stream_rows": stream_rows, "quant": quant,
                      "quickstart": quickstart, "card": smi}))
    spatial = parallel["spatial"]
    print(json.dumps({"spatial_epochs": {k: spatial[k] for k in (
        "counts", "seconds", "peak_bytes", "peak_above_start_bytes", "vs_unsharded")},
        "streaming": streaming, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
