"""Conv probe: the hand-written 3x3 convolution against the library's.

Counterpart of ``scripts/conv_probe.py``.  Times the 64 -> 64, 3x3 SAME
convolution of the U-Net's first level (batch 8, 128x128, bf16 storage,
float32 accumulation) three ways:

  cudnn         ``F.conv2d`` on channels-last bf16 (the library's call)
  cuda          ``ops/conv_kernel.py`` kernels, taps in row-major order
  cuda-paired   the same kernels, taps summed in the paired order

Rows: ``fwd`` (the sum of the convolution) and ``fwdbwd`` (value and
gradients of ``sum(conv**2)`` with respect to x and w).  A timed run is
``--steps`` eager steps between two CUDA events; the figure is the median
of 5 runs after 2 warm-up runs.  Every result line carries the card's name
and power limit.

    python -m physics_informed_image_segmentation_tpu_torch.utils.conv_probe
    python -m physics_informed_image_segmentation_tpu_torch.utils.conv_probe cuda --steps 64
    python -m physics_informed_image_segmentation_tpu_torch.utils.conv_probe --out probe.json

It runs on the GPU and raises without one.  ``--device cpu`` runs the plain
versions at a small size (batch 2, 16x16, 8 channels) on the host's clock:
a check of the control flow, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..ops.conv_kernel import conv3x3_same
from .device import card_line, resolve_device

__all__ = ["IMPLEMENTATIONS", "fwd_flops", "make_inputs", "run_probe", "main"]

BATCH, SIZE, CHANNELS = 8, 128, 64
CPU_BATCH, CPU_SIZE, CPU_CHANNELS = 2, 16, 8
STEPS = 512
WARMUP, TIMED = 2, 5


def fwd_flops(batch: int, size: int, channels: int) -> int:
    """Forward conv FLOPs, 2 * B*H*W * 9*Cin * Cout; the backward adds dx
    and dw, the same each."""
    return 2 * batch * size * size * 9 * channels * channels


def make_inputs(device, batch=BATCH, size=SIZE, channels=CHANNELS, seed=0):
    """x (B, S, S, C) ~ N(0, 1) and w (3, 3, C, C) ~ 0.05 N(0, 1), bf16."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, size, size, channels), generator=g).to(torch.bfloat16)
    w = (torch.randn((3, 3, channels, channels), generator=g) * 0.05).to(torch.bfloat16)
    return x.to(device), w.to(device)


def _cudnn_operands(x, w):
    # NHWC memory seen as NCHW is channels-last already; the weights are
    # laid out once, outside the timed steps
    return x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


# name -> (operands(x, w), conv(*operands)); x is NHWC and w HWIO
IMPLEMENTATIONS = {
    "cudnn": (_cudnn_operands, lambda xn, wo: F.conv2d(xn, wo, padding=1)),
    "cuda": (lambda x, w: (x, w), lambda x, w: conv3x3_same(x, w, False)),
    "cuda-paired": (lambda x, w: (x, w), lambda x, w: conv3x3_same(x, w, True)),
}


def _fwd_step(conv, a, b):
    return conv(a, b).float().sum()


def _fwdbwd_step(conv, a, b):
    loss = conv(a, b).float().square().sum()
    da, db = torch.autograd.grad(loss, (a, b))
    return loss.detach() + da.float().sum() + db.float().sum()


def _time(device: torch.device, step, steps: int) -> float:
    """Median seconds of ``steps`` calls of ``step()`` over ``TIMED`` runs
    after ``WARMUP`` runs: CUDA events on the card, the host's clock on the
    CPU.  Every run's accumulated value must be finite."""

    def run() -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        acc = step()
        for _ in range(steps - 1):
            acc = acc + step()
        if device.type == "cuda":
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        if not torch.isfinite(acc).item():
            raise RuntimeError(f"conv probe: a run summed to {float(acc)}")
        return seconds

    for _ in range(WARMUP):
        run()
    return statistics.median(run() for _ in range(TIMED))


def run_probe(only=None, device=None, steps: int = STEPS) -> dict:
    """Time and print the rows of ``only`` (a name of :data:`IMPLEMENTATIONS`;
    all of them by default).  Returns ``{"device", "card", "shape", "steps",
    "results": {name: {"fwd" | "fwdbwd": {"us_per_step", "tflops"}}}}``."""
    dev = resolve_device(device)
    if steps < 1:
        raise ValueError(f"steps must be at least 1; got {steps}")
    if only is not None and only not in IMPLEMENTATIONS:
        raise ValueError(f"unknown implementation {only!r}; one of {sorted(IMPLEMENTATIONS)}")
    on_card = dev.type == "cuda"
    batch, size, channels = ((BATCH, SIZE, CHANNELS) if on_card
                             else (CPU_BATCH, CPU_SIZE, CPU_CHANNELS))
    card = card_line() if on_card else "cpu (host clock, plain versions: not a device time)"
    x, w = make_inputs(dev, batch, size, channels)
    flops = fwd_flops(batch, size, channels)
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}; x {tuple(x.shape)} "
          f"bf16, w {tuple(w.shape)}; {steps} steps a run", flush=True)

    results = {}
    for name in ([only] if only else list(IMPLEMENTATIONS)):
        operands, conv = IMPLEMENTATIONS[name]
        a, b = operands(x, w)
        ga, gb = (t.detach().requires_grad_(True) for t in (a, b))
        row = {}
        with torch.no_grad():
            sec_fwd = _time(dev, lambda: _fwd_step(conv, a, b), steps)
        sec_fwdbwd = _time(dev, lambda: _fwdbwd_step(conv, ga, gb), steps)
        for label, sec, mult in (("fwd", sec_fwd, 1), ("fwdbwd", sec_fwdbwd, 3)):
            per_step = sec / steps
            row[label] = {"us_per_step": per_step * 1e6, "tflops": flops * mult / per_step / 1e12}
            print(f"{name:12s} {label:7s} {per_step * 1e6:10.2f} us/step "
                  f"{row[label]['tflops']:8.3f} TF/s  [{card}]", flush=True)
        results[name] = row

    if "cudnn" in results:
        for name, row in results.items():
            if name == "cudnn":
                continue
            for label in ("fwd", "fwdbwd"):
                ratio = results["cudnn"][label]["us_per_step"] / row[label]["us_per_step"]
                print(f"{name} vs cudnn ({label}): {ratio:.3f}x  [{card}]", flush=True)
    return {"device": "gpu" if on_card else "cpu", "card": card,
            "shape": [batch, size, size, channels], "steps": steps, "results": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("only", nargs="?", choices=sorted(IMPLEMENTATIONS), default=None,
                    help="time one implementation (default: all, with ratios against cudnn)")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=STEPS, help=f"eager steps a run (default {STEPS})")
    ap.add_argument("--out", default=None, help="write the results to this JSON file")
    args = ap.parse_args(argv)
    res = run_probe(args.only, device=args.device, steps=args.steps)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
        print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
