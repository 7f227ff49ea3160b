"""The plain U-Net of the reference repository, as functions of a parameter dict.

Written from ``seemapoudel58/Physics_informed_image_segmentation``'s
``src/unet.py``: a four-level encoder c -> 2c -> 4c -> 8c with 2x2 max
pooling, an 8c bottleneck, 2x2 stride-2 transposed convolutions with
channel-concatenated skips, DoubleConv = conv3x3 -> ReLU -> (Dropout2d) ->
conv3x3 -> ReLU, graded dropout 0 / d/2 / d by depth, a 1x1 output
convolution and a sigmoid.  The parameter names are that model's
``state_dict`` keys.

Float32 throughout, unless ``quant`` asks for a lower precision of the
convolutions' operands (the benchmark's controls): ``"bf16"`` or ``"fp8"``
(e4m3, one scale a tensor) rounds each convolution's input and weight,
computes in float32 and rounds its output to bfloat16; the gradients that
flow back through those roundings are rounded alike (bf16, or fp8 e5m2).

Dropout draws one keep/drop per (sample, channel) from the generator it is
given: a float32 ``(B, C, 1, 1)`` tensor filled by ``bernoulli_(1 - p)``,
block by block in the forward's order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["param_shapes", "init_params", "forward", "BLOCKS"]

# (name, input channels, output channels, dropout) in units of the base width
# and the model's dropout d, in the forward's order
BLOCKS = (
    ("enc1", "in", 1, 0.0), ("enc2", 1, 2, 0.5), ("enc3", 2, 4, 1.0), ("enc4", 4, 8, 1.0),
    ("bottleneck", 8, 8, 1.0), ("dec4", 16, 8, 1.0), ("dec3", 8, 4, 0.5), ("dec2", 4, 2, 0.5),
    ("dec1", 2, 1, 0.0),
)
UPS = (("up4", 8, 8), ("up3", 8, 4), ("up2", 4, 2), ("up1", 2, 1))


def _blocks(c: int, cin: int, d: float):
    for name, i, o, p in BLOCKS:
        yield name, (cin if i == "in" else i * c), o * c, d * p


def param_shapes(c: int, cin: int = 1, cout: int = 1, dropout: float = 0.2) -> dict:
    """Parameter name -> shape, in the order the benchmark fills them."""
    shapes = {}
    for name, i, o, p in _blocks(c, cin, dropout):
        second = 3 if p > 0 else 2  # Sequential(conv, act, [Dropout2d], conv, act)
        shapes[f"{name}.conv.0.weight"] = (o, i, 3, 3)
        shapes[f"{name}.conv.0.bias"] = (o,)
        shapes[f"{name}.conv.{second}.weight"] = (o, o, 3, 3)
        shapes[f"{name}.conv.{second}.bias"] = (o,)
    for name, i, o in UPS:
        shapes[f"{name}.weight"] = (i * c, o * c, 2, 2)
        shapes[f"{name}.bias"] = (o * c,)
    shapes["out_conv.weight"] = (cout, c, 1, 1)
    shapes["out_conv.bias"] = (cout,)
    return shapes


def init_params(shapes: dict, generator: torch.Generator, device) -> dict:
    """He-normal weights (std sqrt(2 / fan-in), the fan-in of a transposed
    convolution being its input channels) and biases of std 0.01, made
    from ``generator`` in two large calls: one normal draw for all, one
    scale for all."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    stds = []
    for name, shape in shapes.items():
        if name.endswith("bias"):
            stds.append(0.01)
        elif name.startswith("up"):
            stds.append((2.0 / shape[0]) ** 0.5)
        else:
            stds.append((2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5)
    flat = torch.randn(sum(sizes), generator=generator, device=device, dtype=torch.float32)
    flat *= torch.repeat_interleave(torch.tensor(stds, device=device),
                                    torch.tensor(sizes, device=device))
    return {name: t.view(shape) for (name, shape), t in
            zip(shapes.items(), torch.split(flat, sizes))}


def _rounded(x: torch.Tensor, kind: str, backward: bool = False) -> torch.Tensor:
    if kind == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if kind == "fp8":  # e4m3 forward, e5m2 backward, one scale a tensor
        fmt, top = ((torch.float8_e5m2, 57344.0) if backward
                    else (torch.float8_e4m3fn, 448.0))
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(fmt).to(x.dtype) * scale
    raise ValueError(f"unknown precision {kind!r}")


class _Round(torch.autograd.Function):
    """Round to a lower precision in the forward, and the gradient that
    flows back through it in the same precision's backward format."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return _rounded(x, kind)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, ctx.kind, backward=True), None


def _conv(fn, x, w, b, quant, **kw):
    if quant is None:
        return fn(x, w, b, **kw)
    out = fn(_Round.apply(x, quant), _Round.apply(w, quant), b, **kw)
    return _Round.apply(out, "bf16")


def forward(params: dict, x: torch.Tensor, *, base: int, dropout: float = 0.2,
            generator: Optional[torch.Generator] = None, train: bool = False,
            quant: Optional[str] = None, logits: bool = False) -> torch.Tensor:
    """(B, 1, H, W) images -> (B, 1, H, W) probabilities (or logits).

    ``train`` applies dropout with masks drawn from ``generator``."""

    def block(name, h, p):
        second = 3 if p > 0 else 2
        h = F.relu(_conv(F.conv2d, h, params[f"{name}.conv.0.weight"],
                         params[f"{name}.conv.0.bias"], quant, padding=1))
        if train and p > 0:
            keep = torch.empty((h.shape[0], h.shape[1], 1, 1), device=h.device,
                               dtype=torch.float32).bernoulli_(1.0 - p, generator=generator)
            h = h * keep / (1.0 - p)
        return F.relu(_conv(F.conv2d, h, params[f"{name}.conv.{second}.weight"],
                            params[f"{name}.conv.{second}.bias"], quant, padding=1))

    def up(name, h):
        return _conv(F.conv_transpose2d, h, params[f"{name}.weight"], params[f"{name}.bias"],
                     quant, stride=2)

    p = {name: pr for name, _, _, pr in _blocks(base, 1, dropout)}
    e1 = block("enc1", x, p["enc1"])
    e2 = block("enc2", F.max_pool2d(e1, 2), p["enc2"])
    e3 = block("enc3", F.max_pool2d(e2, 2), p["enc3"])
    e4 = block("enc4", F.max_pool2d(e3, 2), p["enc4"])
    b = block("bottleneck", F.max_pool2d(e4, 2), p["bottleneck"])
    d4 = block("dec4", torch.cat([up("up4", b), e4], 1), p["dec4"])
    d3 = block("dec3", torch.cat([up("up3", d4), e3], 1), p["dec3"])
    d2 = block("dec2", torch.cat([up("up2", d3), e2], 1), p["dec2"])
    d1 = block("dec1", torch.cat([up("up1", d2), e1], 1), p["dec1"])
    z = _conv(F.conv2d, d1, params["out_conv.weight"], params["out_conv.bias"], quant)
    return z if logits else torch.sigmoid(z)
