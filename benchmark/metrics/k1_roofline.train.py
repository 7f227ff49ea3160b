"""K1, the fused physics sums (``ops/physics_kernel.py``,
``csrc/physics_sums.cu``), against its byte bound: the bytes each launch
must move (``yardstick.k1_bytes``, from the batch's shapes) over the
bandwidth, summed over the window's launches, over the device time of
the kernels named ``physics_fwd`` and ``physics_bwd``."""

import re

from benchmark.yardstick import k1_bytes

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
KERNELS = {"physics_fwd": False, "physics_bwd": True}  # name -> backward
# the trace names a kernel by its signature, with its namespace:
# "(anonymous namespace)::physics_fwd(float const*, ...)"
_NAME = re.compile(r"^(?:\(anonymous namespace\)::)?(physics_fwd|physics_bwd)(?:\(|$)")


def _kind(name):
    m = _NAME.match(name)
    return m.group(1) if m else None


def read(ctx):
    w = ctx.work
    if ctx.trace is None or ctx.peak is None:
        return None
    launches = [(e - s, _kind(n)) for s, e, n in ctx.trace.kernels(lambda n: _kind(n) is not None)]
    spent = sum(t for t, _ in launches)
    if not launches or spent <= 0:
        return None
    nbytes = sum(k1_bytes(w["batch"], w["size"], w["size"], KERNELS[k]) for _, k in launches)
    return 100.0 * nbytes / ctx.peak["bytes"] / spent
