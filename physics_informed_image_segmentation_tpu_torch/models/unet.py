"""U-Net for PDE-constrained cell segmentation (PyTorch, NCHW).

Counterpart of ``physics_informed_image_segmentation_tpu/models/unet.py``,
with the same topology, channel plan, dropout schedule and activations:

* 4-level encoder c→2c→4c→8c with 2×2 max-pool downsampling,
* an 8c-channel bottleneck (not 16c),
* ConvTranspose(k=2, s=2) upsampling + channel-concat skip connections,
* DoubleConv = Conv3×3 → act → (spatial Dropout) → Conv3×3 → act, with
  no normalisation layers,
* graded dropout 0 / 0.5·d / d by depth,
* 1×1 output conv + sigmoid (or tanh rescaled to (0, 1)),
* 7 intermediate activations; one PReLU weight is shared by both convs
  of a block.

The module is NCHW and its ``state_dict`` keys are the reference keys
(``enc1.conv.0.weight``, ``up4.weight``, ``out_conv.bias``, ...): a
DoubleConv is ``Sequential(conv, act[, Dropout2d], conv, act)`` with the
same activation module at both places.  20,543,809 parameters at
``base_channels=64``.

Dropout draws from an explicit ``torch.Generator`` passed to
``forward``, or takes masks drawn beforehand (:func:`draw_dropout_masks`),
as a forward under ``torch.func.vmap`` must.  The output conv runs in the
autocast type and is cast to float32 before the output activation, so the
probability map (and every loss computed on it) is float32 (float64 for a
float64 model).

``remat=True`` (the JAX package's ``nn.remat(DoubleConv)``) keeps only each
block's input for the backward pass and recomputes its activations there
(``torch.utils.checkpoint``, non-reentrant, which carries the autocast
state into the recompute): less activation memory for about one more
forward of each block.  A recompute must reuse the forward's dropout
masks, and ``checkpoint`` restores only the global RNG states, not an
explicit ``torch.Generator``: so the masks of a training forward are drawn
before any block runs (:func:`draw_dropout_masks`, the same draws in the
same order) and handed to the checkpointed blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["UNet", "DoubleConv", "count_parameters", "draw_dropout_masks", "mish",
           "ACTIVATIONS"]

ACTIVATIONS = {
    "relu": nn.ReLU,
    "leaky_relu": lambda: nn.LeakyReLU(0.01),
    "leakyrelu": lambda: nn.LeakyReLU(0.01),
    "elu": lambda: nn.ELU(alpha=1.0),
    "gelu": lambda: nn.GELU(approximate="none"),
    "swish": nn.SiLU,
    "silu": nn.SiLU,
    "mish": nn.Mish,
}


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation, ``x * tanh(softplus(x))``, on a tensor (the
    function of ``nn.Mish``)."""
    return x * torch.tanh(torch.nn.functional.softplus(x))


class PReLU(nn.Module):
    """``x if x >= 0 else w * x`` with one learnable weight (init 0.25),
    applied in the input's type so it works under autocast."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def _make_activation(name: str) -> nn.Module:
    lower = name.lower()
    if lower == "prelu":
        return PReLU()
    if lower not in ACTIVATIONS:
        raise ValueError(
            f"Unsupported activation: {name}. Must be one of: relu, leaky_relu, "
            "elu, gelu, swish/silu, mish, prelu"
        )
    return ACTIVATIONS[lower]()


def draw_keep(rows: int, channels: int, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A (rows, channels, 1, 1) float32 keep mask of ``Dropout2d(p)``,
    drawn from ``generator``."""
    keep = torch.empty((rows, channels, 1, 1), device=device, dtype=torch.float32)
    return keep.bernoulli_(1.0 - p, generator=generator)


def spatial_dropout(
    x: torch.Tensor, p: float, generator: Optional[torch.Generator],
    batch_rows: Optional[tuple[int, int]] = None, keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Channel-wise dropout (``Dropout2d`` semantics) drawing its mask from
    ``generator``: one keep/drop per (sample, channel), broadcast over H, W.

    ``batch_rows=(global_batch, offset)``: ``x`` holds samples ``offset``
    onwards of a batch of ``global_batch`` sharded over ranks; the mask of
    the whole batch is drawn (every rank's generator is in the same state)
    and this rank's rows are taken, so a sharded run draws the masks of
    the unsharded one.  ``keep``: a mask drawn beforehand
    (:func:`draw_dropout_masks`), used instead of a draw.
    """
    if keep is None:
        b = x.shape[0]
        total, offset = (b, 0) if batch_rows is None else batch_rows
        keep = draw_keep(total, x.shape[1], p, generator, x.device)[offset:offset + b]
    return x * (keep / (1.0 - p)).to(x.dtype)


def draw_dropout_masks(model: "UNet", batch: int, generator: Optional[torch.Generator],
                       device) -> dict:
    """The keep masks a training forward of ``model`` on ``batch`` images
    draws from ``generator``, drawn now and in the same order, keyed by
    block name: ``model(x, dropout_masks=...)`` with them computes what
    ``model(x, generator)`` would have, and leaves ``generator`` where that
    forward leaves it."""
    return {
        name: draw_keep(batch, blk.conv[0].out_channels, blk.dropout, generator, device)
        for name, blk in model.named_children()
        if isinstance(blk, DoubleConv) and blk.dropout > 0
    }


class DoubleConv(nn.Module):
    """Conv3×3 → act → (spatial dropout) → Conv3×3 → act."""

    def __init__(self, in_channels: int, features: int, dropout: float = 0.0,
                 activation: str = "relu"):
        super().__init__()
        act = _make_activation(activation)
        layers = [nn.Conv2d(in_channels, features, 3, padding=1), act]
        if dropout > 0:
            layers.append(nn.Dropout2d(dropout))
        layers += [nn.Conv2d(features, features, 3, padding=1), act]
        self.conv = nn.Sequential(*layers)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None):
        act = self.conv[1]
        x = act(self.conv[0](x))
        if self.dropout > 0 and self.training:
            x = spatial_dropout(x, self.dropout, generator, keep=keep)
        return act(self.conv[-2](x))


class UNet(nn.Module):
    """Standard U-Net, NCHW: ``(B, C_in, H, W)`` → probabilities ``(B, C_out, H, W)``.

    ``param_init``: ``"lecun"`` (the JAX package's default: truncated-normal
    kernels with variance 1/fan_in, zero biases) or ``"torch"`` (torch's
    own Conv2d/ConvTranspose2d family: uniform kernels with variance
    1/(3·fan), uniform ±1/√fan biases).  ``generator`` makes the init
    reproducible.  ``remat``: recompute each block's activations in the
    backward pass of a training forward (module docstring); the parameters
    and ``state_dict`` keys are the same either way.
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        base_channels: int = 64,
        dropout: float = 0.2,
        output_activation: str = "sigmoid",
        intermediate_activation: str = "relu",
        param_init: str = "lecun",
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ):
        super().__init__()
        if output_activation.lower() not in ("sigmoid", "tanh"):
            raise ValueError(
                f"Unsupported output_activation: {output_activation}. "
                "Must be 'sigmoid' or 'tanh'"
            )
        if param_init not in ("lecun", "torch"):
            raise ValueError(
                f"Unsupported param_init: {param_init!r}. Must be 'lecun' or 'torch'"
            )
        self.output_activation = output_activation.lower()
        self.remat = remat
        c, d, act = base_channels, dropout, intermediate_activation
        self.enc1 = DoubleConv(in_channels, c, 0.0, act)
        self.enc2 = DoubleConv(c, c * 2, d * 0.5, act)
        self.enc3 = DoubleConv(c * 2, c * 4, d, act)
        self.enc4 = DoubleConv(c * 4, c * 8, d, act)
        self.bottleneck = DoubleConv(c * 8, c * 8, d, act)
        self.up4 = nn.ConvTranspose2d(c * 8, c * 8, 2, stride=2)
        self.dec4 = DoubleConv(c * 16, c * 8, d, act)
        self.up3 = nn.ConvTranspose2d(c * 8, c * 4, 2, stride=2)
        self.dec3 = DoubleConv(c * 8, c * 4, d * 0.5, act)
        self.up2 = nn.ConvTranspose2d(c * 4, c * 2, 2, stride=2)
        self.dec2 = DoubleConv(c * 4, c * 2, d * 0.5, act)
        self.up1 = nn.ConvTranspose2d(c * 2, c, 2, stride=2)
        self.dec1 = DoubleConv(c * 2, c, 0.0, act)
        self.out_conv = nn.Conv2d(c, out_channels, 1)
        self.pool = nn.MaxPool2d(2)
        self.reset_parameters(param_init, generator)

    @torch.no_grad()
    def reset_parameters(self, param_init: str = "lecun",
                         generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            w = m.weight
            receptive = w.shape[2] * w.shape[3]
            if isinstance(m, nn.ConvTranspose2d):  # weight (in, out, kh, kw)
                fan_in, torch_fan = w.shape[0] * receptive, w.shape[1] * receptive
            else:  # weight (out, in, kh, kw)
                fan_in = torch_fan = w.shape[1] * receptive
            if param_init == "lecun":
                # flax lecun_normal: truncated to ±2σ of the unit normal,
                # rescaled so the variance is exactly 1/fan_in
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                m.bias.zero_()
            else:
                bound = 1.0 / math.sqrt(torch_fan)
                w.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
        for m in self.modules():
            if isinstance(m, PReLU):
                m.weight.fill_(0.25)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[dict] = None) -> torch.Tensor:
        """``dropout_masks``: keep masks by block name, drawn beforehand
        (:func:`draw_dropout_masks`); dropout then draws nothing from
        ``generator``."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        if remat and dropout_masks is None:
            dropout_masks = draw_dropout_masks(self, x.shape[0], generator, x.device)
        keep = dropout_masks or {}

        def block(name, h):
            blk, k = getattr(self, name), keep.get(name)
            if remat:
                # the masks are drawn already: the block draws nothing, so
                # no RNG state needs saving for its recompute
                return checkpoint(blk, h, None, k, use_reentrant=False,
                                  preserve_rng_state=False)
            return blk(h, generator, k)

        e1 = block("enc1", x)
        e2 = block("enc2", self.pool(e1))
        e3 = block("enc3", self.pool(e2))
        e4 = block("enc4", self.pool(e3))
        b = block("bottleneck", self.pool(e4))
        d4 = block("dec4", torch.cat([self.up4(b), e4], dim=1))
        d3 = block("dec3", torch.cat([self.up3(d4), e3], dim=1))
        d2 = block("dec2", torch.cat([self.up2(d3), e2], dim=1))
        d1 = block("dec1", torch.cat([self.up1(d2), e1], dim=1))
        out = self.out_conv(d1)
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        if self.output_activation == "sigmoid":
            return torch.sigmoid(out)
        return (torch.tanh(out) + 1.0) / 2.0


def count_parameters(model: nn.Module) -> int:
    """Number of trainable parameters (a shared PReLU weight counts once)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
