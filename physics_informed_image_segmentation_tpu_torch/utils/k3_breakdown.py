"""Where the time of the halo-padded physics kernels (K3) goes on the GPU.

    python -m physics_informed_image_segmentation_tpu_torch.utils.k3_breakdown [--reps 50]

Builds ``csrc/padded_physics.cu`` as it is, with tiles of up to 64 rows
allowed, and variants of that copy with one piece of the forward taken
out: the last block's finish (``nofinish``), the fence and the ticket with
it (``noticket``), the computation (``nocompute``), the copies into shared
memory (``noload``).  Prints the device time per call (``torch.profiler``,
the mean over ``--reps`` calls) of each forward at tile heights 16, 32 and
64, and of the backward at 16 and 32 (64 rows would pass its 48 KB of
shared memory), at the megapixel block (1,1026,1026) and the training
block (8,130,130), with the card's name and power limit.  A variant
computes wrong sums: only its time means anything.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .cuda_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from .profile_step import _device_time

D, A, EPS = 5.0, 0.5, 0.05
SHAPES = ((1, 1026, 1026), (8, 130, 130))

# name -> (text of csrc/padded_physics.cu, what replaces it; every occurrence)
_VARIANTS = {
    "nofinish": ("  if (!is_last) return;\n", "  return;\n"),
    "noticket": ("      __threadfence();\n      is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;",
                 "      is_last = 0;"),
    "nocompute": ("  if (col >= tile.cols || r_begin >= r_end) return;", "  return;"),
    "noload": ("  copy_rows<1>(", "  if (false) copy_rows<1>("),
}


def _sources() -> dict:
    base = (CSRC_DIR / "padded_physics.cu").read_text()
    base = base.replace("constexpr int kMaxTileH = 32;", "constexpr int kMaxTileH = 64;")
    out = {"kernel": base}
    for name, (old, new) in _VARIANTS.items():
        if old not in base:
            raise RuntimeError(f"variant {name}: csrc/padded_physics.cu no longer holds {old!r}")
        out[name] = base.replace(old, new)
    return out


def _build(sources: dict) -> dict:
    """One nvcc per source, all started together; ``{name: CDLL}``."""
    out_dir = BUILD_DIR / "k3_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
                                        str(src)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.padded_physics_fwd.argtypes = [p, p, p, p, i, i, i, i, d, d, d, i, p]
        lib.padded_physics_fwd.restype = i
        lib.padded_physics_bwd.argtypes = [p, p, p, i, i, i, i, d, d, d, i, p]
        lib.padded_physics_bwd.restype = i
        libs[name] = lib
    return libs


def _device_us(fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_time(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=50, help="calls per reading")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_breakdown needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    libs = _build(_sources())
    ws = torch.zeros(1 << 20, device="cuda")  # the ticket (its first word) and the partials
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for shape in SHAPES:
        g = torch.Generator().manual_seed(0)
        p = (0.02 + 0.96 * torch.rand(shape, generator=g)).cuda()
        cot = torch.randn((shape[0], 2), generator=g).cuda()
        b, h, w = shape[0], shape[1] - 2, shape[2] - 2
        sums, dp = torch.empty((b, 2), device="cuda"), torch.empty_like(p)
        for tile_h in (16, 32, 64):
            row = {"shape": list(shape), "tile_h": tile_h}
            for name, lib in libs.items():
                ws.zero_()  # a variant without the finish leaves the ticket counted up
                row[f"fwd_{name}"] = _device_us(lambda lib=lib: lib.padded_physics_fwd(
                    p.data_ptr(), ws.data_ptr() + 16, ws.data_ptr(), sums.data_ptr(), b, h, w,
                    tile_h, D, A, EPS, 1, stream), args.reps)
            if tile_h <= 32:
                row["bwd_kernel"] = _device_us(lambda: libs["kernel"].padded_physics_bwd(
                    p.data_ptr(), cot.data_ptr(), dp.data_ptr(), b, h, w, tile_h, D, A, EPS, 1,
                    stream), args.reps)
            print(f"{shape} tile_h {tile_h}: " + ", ".join(
                f"{k} {v:.2f} us" for k, v in row.items() if k not in ("shape", "tile_h")),
                flush=True)
            rows.append(row)
    print(json.dumps({"k3_breakdown_device_us": rows, "card": card}))


if __name__ == "__main__":
    main()
