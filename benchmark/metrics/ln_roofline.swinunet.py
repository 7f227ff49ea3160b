"""Swin-Unet's 38 LayerNorms (``models/swin_unet.py`` through
``ops/layer_norm.py``, the kernels of ``csrc/layer_norm.cu``) against their
byte floor: the bytes any implementation must move for the window's norms
over the bandwidth, over the device time of the kernels named
``layer_norm_fwd``, ``layer_norm_bwd`` and ``layer_norm_bwd_params``.
None where no such kernel ran.

The floor counts, at each norm with ``n`` elements (batch x tokens x
width) and the types bf16 autocast gives the site: forward (each training
step and validation batch) the input read in its type and the output
written in its type; backward (each training step) the input and the
output's gradient read and the input's gradient written, each in its type.
The types: the patch embedding's and each ``PatchExpand``'s norm read bf16
and write float32 (the stream); the ×4 expand's reads and writes bf16;
every other norm reads the float32 stream and writes bf16 for a linear.
gamma and beta are left out."""

from __future__ import annotations

import re

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
BF16, F32 = 2, 4
# the trace names a kernel by its signature: "void (anonymous
# namespace)::layer_norm_fwd<__nv_bfloat16, float, 96>(...)"
_NAME = re.compile(r"(?:^|[\s:])layer_norm_(?:fwd|bwd|bwd_params)(?:<|\(|$)")


def norm_sites(model: dict, s: int) -> list[tuple[int, int, int, int]]:
    """``(width, tokens an image, input bytes, output bytes)`` of every
    LayerNorm of the Swin-Unet described by ``model`` (the configuration's
    model group) on ``s`` x ``s`` images, in the order the forward calls
    them."""
    e, depths = model["embed_dim"], model["depths"]
    stages = len(depths)
    side = [s // model["patch_size"] // 2 ** i for i in range(stages)]
    sites = [(e, side[0] ** 2, BF16, F32)]  # patch embedding
    for i in range(stages):
        sites += [(e * 2 ** i, side[i] ** 2, F32, BF16)] * (2 * depths[i])  # norm1, norm2
        if i < stages - 1:  # PatchMerging
            sites.append((4 * e * 2 ** i, side[i + 1] ** 2, F32, BF16))
    sites.append((e * 2 ** (stages - 1), side[-1] ** 2, F32, BF16))  # norm
    sites.append((e * 2 ** (stages - 2), side[-2] ** 2, BF16, F32))  # layers_up[0]
    for j in range(stages - 2, -1, -1):  # the decoder's stages
        sites += [(e * 2 ** j, side[j] ** 2, F32, BF16)] * (2 * depths[j])
        if j > 0:  # PatchExpand
            sites.append((e * 2 ** (j - 1), side[j - 1] ** 2, BF16, F32))
    sites.append((e, side[0] ** 2, F32, BF16))  # norm_up
    sites.append((e, (4 * side[0]) ** 2, BF16, BF16))  # the x4 expand
    return sites


def floor_bytes(model: dict, s: int, b: int, train_steps: int, val_batches: int) -> float:
    """The bytes the window's norms must move (module docstring)."""
    total = 0.0
    for c, tokens, x_bytes, y_bytes in norm_sites(model, s):
        n = b * tokens * c
        fwd = n * (x_bytes + y_bytes)
        bwd = n * (2 * x_bytes + y_bytes)
        total += (train_steps + val_batches) * fwd + train_steps * bwd
    return total


def read(ctx):
    w = ctx.work
    if ctx.trace is None or ctx.peak is None or "embed_dim" not in w.get("model", {}):
        return None
    spent = sum(e - s for s, e, _ in ctx.trace.kernels(lambda n: _NAME.search(n) is not None))
    if spent <= 0:
        return None
    nbytes = floor_bytes(w["model"], w["size"], w["batch"], w["train_steps"], w["val_batches"])
    return 100.0 * nbytes / ctx.peak["bytes"] / spent
