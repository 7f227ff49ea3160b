"""TransUNet's ResNetV2 norms (``models/transunet.py`` through
``ops/group_norm.py``: each GroupNorm with its residual add and ReLU, the
kernels of ``csrc/group_norm.cu``) against their byte floor: the bytes any
implementation must move for the window's norms over the bandwidth, over
the device time of the kernels named ``group_norm_fwd_stats``,
``group_norm_fwd_apply``, ``group_norm_bwd_sums`` and
``group_norm_bwd_apply``.  None where no such kernel ran.

The floor counts, at each of the ResNet's norms with ``n = B C H W`` of
its map: forward (each training step and validation batch) 2n bytes for
the bf16 input read and 2n for the output written, but only the input at
``gn_proj``; backward (each training step) 2n each for the gradient in,
the input and the gradient out, but only the input and the gradient out at
``gn_proj``.  Residual reads and ``gn_proj``'s output are left out, so that
fusing them away cannot push the reading past 100%.  Every norm is assumed
to take the kernels (52 at the published block units)."""

from __future__ import annotations

import re

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BF16_BYTES = 2
# the trace names a kernel by its signature: "void (anonymous
# namespace)::group_norm_fwd_apply<__nv_bfloat16, float, true, true>(...)"
_NAME = re.compile(r"(?:^|[\s:])group_norm_(?:fwd_stats|fwd_apply|bwd_sums|bwd_apply)(?:<|\(|$)")


def norm_sites(model: dict, s: int) -> list[tuple[int, int, bool]]:
    """``(channels, side, is gn_proj)`` of every GroupNorm of the ResNetV2
    described by ``model`` (the configuration's model group) on ``s`` x
    ``s`` images, in the order the forward calls them: the root, then each
    unit's gn_proj (first units), gn1, gn2, gn3."""
    w = model["width"]
    side = s // 2  # root: 7x7 stride 2
    sites = [(w, side, False)]
    side = (side - 3) // 2 + 1  # max pool 3x3 stride 2, no padding
    cin = w
    for i, units in enumerate(model["block_units"]):
        cout, cmid, stride = 4 * w * 2 ** i, w * 2 ** i, 1 if i == 0 else 2
        for u in range(units):
            out = (side - 1) // stride + 1 if u == 0 else side
            if u == 0 and (stride != 1 or cin != cout):
                sites.append((cout, out, True))
            sites += [(cmid, side, False), (cmid, out, False), (cout, out, False)]
            side = out
        cin = cout
    return sites


def floor_bytes(model: dict, s: int, b: int, train_steps: int, val_batches: int) -> float:
    """The bytes the window's norms must move (module docstring)."""
    total = 0.0
    for c, side, proj in norm_sites(model, s):
        n = b * c * side * side
        fwd = BF16_BYTES * n * (1 if proj else 2)
        bwd = BF16_BYTES * n * (2 if proj else 3)
        total += (train_steps + val_batches) * fwd + train_steps * bwd
    return total


def read(ctx):
    w = ctx.work
    if ctx.trace is None or ctx.peak is None or "model" not in w:
        return None
    spent = sum(e - s for s, e, _ in ctx.trace.kernels(lambda n: _NAME.search(n) is not None))
    if spent <= 0:
        return None
    nbytes = floor_bytes(w["model"], w["size"], w["batch"], w["train_steps"], w["val_batches"])
    return 100.0 * nbytes / ctx.peak["bytes"] / spent
