"""int8 against bf16 for the U-Net's 3x3 convolutions on the card.

Counterpart of the JAX repo's ``scripts/quant_probe.py``, the probe that
``docs/DESIGN.md`` cites for declining int8 serving (on a TPU).  The same
question here, int8 only:

1. *Correctness.*  An int8 x int8 -> int32 3x3 SAME convolution
   (:func:`int8_conv3x3_same`: an NHWC im2col from the nine shifted slices
   of the zero-padded int8 input, then ``torch._int_mm`` with the weight
   matrix stored column-major, K contiguous: the layout cuBLASLt's int8
   tensor-core kernels read B in, free to choose for a constant operand)
   against the
   float64 convolution of the same small integers, at the JAX probe's
   (2,16,16,8) -> 16 with values in [-4, 4].  The error must be 0.
2. *Speed,* at the U-Net's four stage shapes at batch 128, NHWC
   (:data:`SHAPES`), four rows each:

   * ``bf16_conv``: the convolution the port's ``Predictor`` runs, bf16
     ``F.conv2d`` through cuDNN on NCHW tensors, the U-Net's layout (bias
     left out, as in the JAX probe);
   * ``int8_conv``: the int8 path end to end as the JAX probe times it:
     int8 operands already on the card, the im2col included, quantisation
     not timed;
   * ``int8_gemm`` and ``bf16_gemm``: the product alone at the im2col's
     shape (M = B*H*W, K = 9*Cin, N = Cout), ``torch._int_mm`` against a
     bf16 ``torch.matmul`` on the same matrices: the ceiling of an im2col
     path.

   Each row is the median of 20 calls bracketed by CUDA events after 3
   warm-up calls, with its TOP/s (or TFLOP/s) and its share of the card's
   dense peak (``utils.measure``, source printed beside it).  Each case's
   buffers are freed before the next.

No kernel is written for this: the JAX probe's int8 convolution is XLA's
``lax.conv_general_dilated``, not a Pallas kernel, and stock PyTorch is its
counterpart.  ``torch._int_mm`` needs M > 16 and K and N multiples of 8; a
case that does not qualify raises with its shape (there is no fallback).

    python -m physics_informed_image_segmentation_tpu_torch.scripts.quant_probe
    python -m physics_informed_image_segmentation_tpu_torch.scripts.quant_probe --shapes 3

On the GPU by default, raising without one; ``--device cpu`` (small
``--batch``) checks the control flow on the host's clock.  Prints one JSON
line for the check and one a shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.measure import PEAK_INT8_OPS, PEAK_SOURCE, device_facts

__all__ = ["CASE", "SHAPES", "im2col3x3", "weight_matrix", "int8_conv3x3_same",
           "conv3x3_reference", "check_int8_conv", "time_shape", "main"]

CASE = (2, 16, 16, 8, 16)  # B, H, W, Cin, Cout of the correctness case
CASE_RANGE = 4
SHAPES = [
    (128, 128, 128, 64, 64),   # enc1
    (128, 64, 64, 128, 128),   # enc2
    (128, 32, 32, 256, 256),   # enc3
    (128, 16, 16, 512, 512),   # enc4 / bottleneck
]
WARMUP, REPS = 3, 20


def _check_int_mm_shape(m: int, k: int, n: int) -> None:
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"torch._int_mm needs M > 16 and K, N multiples of 8; this case has "
                         f"M={m}, K={k}, N={n}")


def im2col3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, 9*C): each pixel's 3x3 SAME neighbourhood,
    taps in row-major order, channels innermost (zero padding)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)],
                     dim=-1).reshape(b * h * w, 9 * c)


def weight_matrix(k: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the (9*Cin, Cout) matrix of the im2col
    product, stored column-major (K contiguous)."""
    return k.reshape(9 * k.shape[2], k.shape[3]).t().contiguous().t()


def int8_conv3x3_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """int8 (B, H, W, Cin) x int8 HWIO (3, 3, Cin, Cout) -> int32 (B, H, W,
    Cout), a 3x3 SAME stride-1 convolution summed exactly in int32."""
    if x.dtype != torch.int8 or k.dtype != torch.int8:
        raise TypeError(f"int8 operands expected; got {x.dtype}, {k.dtype}")
    b, h, w, cin = x.shape
    cout = k.shape[-1]
    if tuple(k.shape) != (3, 3, cin, cout):
        raise ValueError(f"weights {tuple(k.shape)} do not fit input channels {cin}")
    _check_int_mm_shape(b * h * w, 9 * cin, cout)
    return torch._int_mm(im2col3x3(x), weight_matrix(k)).reshape(b, h, w, cout)


def conv3x3_reference(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The same convolution in float64 (NHWC, HWIO): the plain version."""
    out = F.conv2d(x.double().permute(0, 3, 1, 2), k.double().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def check_int8_conv(device, case=CASE, seed: int = 0) -> float:
    """Max |int8 conv - float64 conv| on integers in [-4, 4]; raises unless 0."""
    b, h, w, cin, cout = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-CASE_RANGE, CASE_RANGE + 1, (b, h, w, cin), generator=g,
                      dtype=torch.int8).to(device)
    k = torch.randint(-CASE_RANGE, CASE_RANGE + 1, (3, 3, cin, cout), generator=g,
                      dtype=torch.int8).to(device)
    ref = conv3x3_reference(x, k)
    err = float((int8_conv3x3_same(x, k).double() - ref).abs().max())
    if err != 0.0:
        raise RuntimeError(f"int8 conv {case}: max |error| against float64 {err}, expected 0")
    return err


def _timer(device: torch.device) -> Callable:
    """``ms(fn)``: median milliseconds of ``fn()`` over :data:`REPS` calls
    after :data:`WARMUP` (CUDA events on the card, the host clock on the CPU)."""
    def ms(fn, reps: int = REPS) -> float:
        for _ in range(WARMUP):
            fn()
        times = []
        for _ in range(reps):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    return ms


def time_shape(shape, device, reps: int = REPS, seed: int = 0) -> dict:
    """The four rows at one (B, H, W, Cin, Cout); its buffers are freed after."""
    b, h, w, cin, cout = shape
    m, kk, n = b * h * w, 9 * cin, cout
    _check_int_mm_shape(m, kk, n)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    ms = _timer(dev)
    xq = torch.randint(-127, 128, (b, h, w, cin), generator=g, device=dev, dtype=torch.int8)
    kq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device=dev, dtype=torch.int8)
    xb = torch.randn((b, cin, h, w), generator=g, device=dev, dtype=torch.bfloat16)
    wb = torch.randn((cout, cin, 3, 3), generator=g, device=dev, dtype=torch.bfloat16)
    times = {"bf16_conv": ms(lambda: F.conv2d(xb, wb, padding=1), reps),
             "int8_conv": ms(lambda: int8_conv3x3_same(xq, kq), reps)}
    del xb, wb
    a8, b8 = im2col3x3(xq), weight_matrix(kq)
    del xq
    times["int8_gemm"] = ms(lambda: torch._int_mm(a8, b8), reps)
    a16, b16 = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    del a8
    times["bf16_gemm"] = ms(lambda: torch.matmul(a16, b16), reps)
    del a16, b16, kq, b8
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return {"m": m, "k": kk, "n": n, "ops": 2.0 * m * kk * n, "ms": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--shapes", type=int, nargs="*", default=None,
                    help=f"indices into the {len(SHAPES)} stage shapes (default: all)")
    ap.add_argument("--batch", type=int, default=SHAPES[0][0])
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    facts = device_facts(dev)
    on_card = dev.type == "cuda"
    err = check_int8_conv(dev)
    print(json.dumps({"check": "int8 x int8 -> int32 3x3 SAME conv against float64",
                      "case": list(CASE), "values": [-CASE_RANGE, CASE_RANGE],
                      "max_abs_err": err, **facts}), flush=True)
    peaks = {"int8": PEAK_INT8_OPS.get(facts["device_kind"]),
             "bf16": facts["peak_flops_assumed"]}
    for i in (range(len(SHAPES)) if args.shapes is None else args.shapes):
        shape = (args.batch, *SHAPES[i][1:])
        res = time_shape(shape, dev, args.reps)
        rows = {}
        for row, t in res["ms"].items():
            rate = res["ops"] / (t * 1e-3)
            peak = peaks["int8" if row.startswith("int8") else "bf16"] if on_card else None
            rows[row] = {"ms": t, "ops_per_s": rate, "share_of_peak": rate / peak if peak else None}
        print(json.dumps({
            "shape": list(shape), "layout": "int8 NHWC / bf16 conv NCHW (the U-Net's)",
            "m": res["m"], "k": res["k"], "n": res["n"], "ops": res["ops"], "rows": rows,
            "int8_over_bf16_speed": {
                "conv": res["ms"]["bf16_conv"] / res["ms"]["int8_conv"],
                "gemm": res["ms"]["bf16_gemm"] / res["ms"]["int8_gemm"]},
            "peak_int8_ops_per_s": peaks["int8"] if on_card else None,
            "peak_bf16_flops": peaks["bf16"] if on_card else None,
            "peak_source": PEAK_SOURCE if on_card else None, **facts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
