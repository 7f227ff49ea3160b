"""Where a Stage II training step spends its time on the GPU.

    python -m physics_informed_image_segmentation_tpu_torch.utils.profile_step \
        [--steps 8] [--optimizer adamw|pallas_adamw|...]

Trains the full-width U-Net (base_channels 64, 128x128, batch 8, bf16) on
synthetic blobs with the Stage II objective and the named optimizer (a
``create_train_state`` name): one warm-up epoch, then one epoch
unprofiled and one under ``torch.profiler``.  Prints the host wall time
per step, the device's busy time and idle share over that window, the
device time of the fused physics kernels, of the optimizer's kernels,
and the kernels that take the most device time.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..data import DeviceDataset, epoch_batch_indices, make_blobs
from ..models import UNet
from ..train import LossConfig, create_train_state, make_train_epoch_fn


def _device_time(evt) -> float:
    """Self device time of a profiler event in µs (the attribute was renamed)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _busy_us(events) -> tuple[float, float]:
    """(union of device-kernel intervals, first-to-last span), in µs."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=8, help="train steps in the window")
    parser.add_argument("--top", type=int, default=12, help="kernels to list")
    parser.add_argument("--optimizer", default="adamw",
                        help="optimizer name for create_train_state (default: adamw)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA GPU")

    batch = 8
    n = batch * args.steps
    images, masks = make_blobs(n, 128, 128, seed=1)
    data = DeviceDataset.from_numpy(images, masks, "cuda")
    model = UNet(base_channels=64, generator=torch.Generator().manual_seed(0)).cuda()
    state = create_train_state(model, 1e-5, optimizer=args.optimizer)
    cfg = LossConfig(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0,
                     reaction_threshold=0.5, epsilon=0.05)
    epoch_fn = make_train_epoch_fn(cfg, precision="bf16")
    gen = torch.Generator().manual_seed(0)

    def epoch():
        idx, valid = epoch_batch_indices(n, batch, shuffle=True, generator=gen, device="cuda")
        return epoch_fn(state, data.images, data.masks, idx, valid)

    epoch()  # warm-up: cuDNN algorithm choice, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"Stage II train, {args.optimizer}, base_channels 64, 128x128, batch {batch}, bf16, "
          f"{args.steps} steps: "
          f"{wall_plain / args.steps * 1e3:.3f} ms/step wall ({n / wall_plain:.1f} img/s) "
          f"unprofiled, {wall / args.steps * 1e3:.3f} ms/step under the profiler")
    busy, span = _busy_us(prof.events())
    if busy == 0.0:
        print("device time: not measured (the profiler recorded no device kernels)")
        return
    print(f"device busy {busy / args.steps / 1e3:.3f} ms/step: idle share "
          f"{1 - busy / 1e6 / wall_plain:.3f} of the unprofiled wall time, "
          f"{1 - busy / 1e6 / wall:.3f} of the profiled (kernel span {span / 1e3:.3f} ms)")
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and _device_time(e) > 0]
    kernels.sort(key=_device_time, reverse=True)
    total = sum(_device_time(e) for e in kernels)
    k1 = [e for e in kernels if "physics_" in e.key]
    for e in k1:
        print(f"K1 {e.key[:60]}: {_device_time(e) / e.count:.2f} µs/launch device, "
              f"{e.count} launches")
    opt = [e for e in kernels if "adamw_kernel" in e.key or "multi_tensor_apply" in e.key]
    print(f"optimizer ({args.optimizer}) device time: "
          f"{sum(_device_time(e) for e in opt) / args.steps:.1f} µs/step in "
          f"{sum(e.count for e in opt) / args.steps:g} launches/step")
    launches = sum(e.count for e in kernels) / args.steps
    print(f"device time by kernel ({len(kernels)} kernels, {launches:.0f} launches/step, "
          f"{total / args.steps / 1e3:.3f} ms/step):")
    for e in kernels[: args.top]:
        print(f"  {_device_time(e) / total * 100:5.1f}%  {_device_time(e) / args.steps:9.1f} "
              f"µs/step  x{e.count // args.steps:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
