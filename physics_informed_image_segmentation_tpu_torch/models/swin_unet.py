"""Swin-Unet, Swin-T with window 7 (PyTorch): NCHW at its interface, tokens inside.

Cao et al., "Swin-Unet: Unet-like Pure Transformer for Medical Image
Segmentation" (arXiv:2105.05537), as its code has it
(``HuCaoFighting/Swin-Unet``: ``networks/vision_transformer.py::SwinUnet``,
``networks/swin_transformer_unet_skip_expand_decoder_sys.py::SwinTransformerSys``,
``configs/swin_tiny_patch4_window7_224_lite.yaml``), with the blocks of Liu
et al., "Swin Transformer" (arXiv:2103.14030).  The module names are that
code's, so the ``state_dict`` keys are too
(``swin_unet.layers.{i}.blocks.{j}.attn.relative_position_bias_table``,
``swin_unet.layers.{i}.downsample.reduction.weight``,
``swin_unet.layers_up.{i}.upsample.expand.weight``, ``swin_unet.up.expand.weight``,
``swin_unet.output.weight``, ...), with the buffers ``relative_position_index``
and, in a shifted block, ``attn_mask``.

* A 1-channel image is repeated to 3 channels.  ``patch_embed``: a 4×4
  stride-4 convolution to ``embed_dim``, flattened to tokens, LayerNorm.
* Encoder: four stages (``layers``) of ``depths`` Swin blocks at widths
  ``embed_dim·2^i`` with ``num_heads[i]`` heads; stages 0–2 end in
  ``PatchMerging`` (the 2×2 neighbours concatenated, LayerNorm(4C),
  Linear(4C, 2C) without bias); a final LayerNorm (``norm``).  The skips
  are the inputs of the four stages.
* A Swin block: ``x + DropPath(proj(WA(shift(norm1(x)))))``, then ``x +
  DropPath(fc2(GELU(fc1(norm2(x)))))`` with the exact GELU.  Odd blocks
  roll the map by −⌊window/2⌋ before ``window_partition`` and back after
  ``window_reverse``; a stage whose side is no larger than the window takes
  window = side and no shift.  WA is ``softmax(q kᵀ / √d + B + M) v`` over
  each window's N = window² tokens: B gathered from
  ``relative_position_bias_table`` ((2·window − 1)² × heads) through
  ``relative_position_index``, M the shifted block's ``attn_mask`` (−100
  between tokens of different regions of the rolled map, else 0).
* Decoder: ``layers_up[0]`` is ``PatchExpand`` (Linear(C, 2C) without bias,
  a 2×2 rearrangement to C/2 channels, LayerNorm); ``layers_up[i]``, i ≥ 1,
  concatenates skip 3 − i, maps it back with ``concat_back_dim[i]``
  (Linear(2C, C)), runs ``depths[3 − i]`` Swin blocks and, but for the last,
  a ``PatchExpand``.  Then ``norm_up``, ``FinalPatchExpand_X4`` (Linear(C,
  16C) without bias, a 4×4 rearrangement, LayerNorm) and ``output``, a 1×1
  convolution without bias to ``out_channels`` logits, cast to float32
  before the sigmoid.
* Stochastic depth: rates rising linearly from 0 to ``drop_path_rate``
  over the encoder's blocks; each decoder stage reuses its encoder stage's.
  The keep masks are per sample, float32 ``bernoulli_(1 − p)`` drawn from
  the ``generator`` given to ``forward``, in the order the blocks run
  (encoder, then decoder), each block's attention branch before its MLP
  branch; a block of rate 0 draws none.  Dropout and attention dropout are
  0, as published.

Window attention is one ``F.scaled_dot_product_attention(q, k, v,
attn_mask=B + M)`` a block, the windows folded into the heads: q, k, v are
(batch, windows·heads, N, d) and the bias (1, windows·heads, N, N), one
copy broadcast over the batch, stored with its rows padded to 8 elements
so the memory-efficient kernel takes it without padding it again.  On
CUDA the call is restricted to the fused backends (``FUSED_ATTENTION``),
which return the bias's gradient too, so the table learns through the
fused backward; a call the math backend would take raises instead.  On the
CPU, where the fused backends refuse a bias that needs a gradient, the
same function is one plain path with an explicit softmax.  Under bf16
autocast the residual stream stays float32 (the outputs of ``reduction``
and ``concat_back_dim``, which become the stream, are cast back to it).
The 38 LayerNorms are ``ops.layer_norm.LayerNorm``: on the card one
hand-written kernel each way, which reads the input in its own type,
keeps float32 statistics and writes the output in the type its site's
role gives: float32 where it becomes the stream (the patch embedding's
norm, ``PatchExpand``'s), the compute type where only a linear or the
output convolution reads it (``norm1``, ``norm2``, ``PatchMerging``'s,
``norm``, ``norm_up``, the ×4 expand's), rounded once, where the linear
would round it; on the CPU the kernels' plain version.

Departures from the published model: ``out_channels`` logits through a
sigmoid (the published head gives ``num_classes`` to a softmax); random
weights where the published run loads ImageNet Swin-T ones.

``attention_counts`` totals the window-attention calls (14 a forward at
the published depths) and their query-key ``pairs`` (batch × windows ×
heads × N²); ``window_counts`` totals the ``windows`` attended (batch ×
windows a call) and the calls with a ``shifted`` map.  Under
``torch.profiler`` the forward opens ``piis.transformer`` (patch embedding,
the four stages, the final norm) and ``piis.decoder`` (``layers_up``, the
skips' concatenation and ``concat_back_dim``, ``norm_up``, the ×4 expand,
``output``); inside either, ``piis.window`` around each block's roll,
partition and bias assembly and around its reverse and roll back,
``piis.attention`` around each attention call alone, and ``piis.resample``
around each ``PatchMerging``, ``PatchExpand`` and ``FinalPatchExpand_X4``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import sdpa_kernel

from ..ops.layer_norm import LayerNorm
from ..utils.profiling import span
from .transunet import FUSED_ATTENTION, Mlp

__all__ = ["SwinUnet", "SwinTransformerSys", "relative_position_index", "shift_mask",
           "window_partition", "window_reverse"]

BIAS_ALIGN = 8  # elements: the memory-efficient kernel's alignment of a bias row


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) → (B·H/w·W/w, w, w, C), windows in row-major order."""
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: → (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.view(-1, h // w, wd // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, wd, c)


def relative_position_index(w: int) -> torch.Tensor:
    """(w², w²): the row of the bias table for each query–key pair of a
    window, (Δrow + w − 1)·(2w − 1) + Δcol + w − 1."""
    rows, cols = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    coords = torch.stack([rows.flatten(), cols.flatten()])  # 2, N
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def shift_mask(side: int, w: int, shift: int) -> torch.Tensor:
    """(windows, w², w²): −100 between tokens of different regions of the
    map rolled by −``shift``, else 0; the regions are the three slices
    ``(0, −w), (−w, −shift), (−shift, None)`` on each axis."""
    regions = torch.zeros(1, side, side, 1)
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for i, hs in enumerate(slices):
        for j, ws in enumerate(slices):
            regions[:, hs, ws, :] = 3 * i + j
    labels = window_partition(regions, w).view(-1, w * w)
    diff = labels[:, None, :] - labels[:, :, None]
    return torch.zeros_like(diff).masked_fill_(diff != 0, -100.0)


def _stream(y: torch.Tensor) -> torch.Tensor:
    """``y`` in the residual stream's type: float32 at least."""
    return y.to(torch.promote_types(y.dtype, torch.float32))


def _drop_path(x: torch.Tensor, p: float, training: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth: each sample's branch kept with probability 1 − p
    (a float32 keep mask drawn from ``generator``) and scaled by 1/(1 − p)."""
    if not training or p == 0.0:
        return x
    keep = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device,
                       dtype=torch.float32)
    keep.bernoulli_(1.0 - p, generator=generator)
    return x * (keep.to(torch.promote_types(x.dtype, torch.float32)) / (1.0 - p))


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self, mask: Optional[torch.Tensor], windows: int, dtype: torch.dtype) -> torch.Tensor:
        """B + M as (1, windows·heads, N, N) in ``dtype``, each row stored
        in a multiple of ``BIAS_ALIGN`` elements."""
        n, h = self.window_size ** 2, self.num_heads
        table = self.relative_position_bias_table
        b = table[self.relative_position_index.view(-1)].view(n, n, h).permute(2, 0, 1)
        if mask is not None:
            b = b + mask[:, None]
        padded = -(-n // BIAS_ALIGN) * BIAS_ALIGN
        out = torch.empty(windows, h, n, padded, device=table.device, dtype=dtype)[..., :n]
        return out.copy_(b).view(1, windows * h, n, n)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, batch: int,
                counts: dict) -> torch.Tensor:
        """(batch·windows, N, C) window tokens → the same, after ``proj``."""
        bw, n, c = x.shape
        h, windows = self.num_heads, bw // batch
        d = c // h
        # (3, batch, windows·heads, N, d): the windows folded into the heads
        qkv = self.qkv(x).view(batch, windows, n, 3, h, d).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv.reshape(3, batch, windows * h, n, d).unbind(0)
        with span("piis.attention"):
            if q.is_cuda:
                with sdpa_kernel(FUSED_ATTENTION):
                    o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            else:
                s = (q * d ** -0.5) @ k.transpose(-2, -1) + bias
                o = torch.softmax(s, dim=-1) @ v
        counts["calls"] += 1
        counts["pairs"] += batch * windows * h * n * n
        o = o.view(batch, windows, h, n, d).permute(0, 1, 3, 2, 4).reshape(bw, n, c)
        return self.proj(o)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, resolution: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float, drop_path: float):
        super().__init__()
        if resolution <= window_size:  # the published rule: one window, no shift
            window_size, shift_size = resolution, 0
        self.resolution, self.window_size, self.shift_size = resolution, window_size, shift_size
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, out="compute")
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim, out="compute")
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = shift_mask(resolution, window_size, shift_size) if shift_size else None
        self.register_buffer("attn_mask", mask)

    def forward(self, x, generator, counts, window_counts):
        side, w, s = self.resolution, self.window_size, self.shift_size
        b, length, c = x.shape
        h = self.norm1(x)
        windows = (side // w) ** 2
        with span("piis.window"):
            h = h.view(b, side, side, c)
            if s:
                h = torch.roll(h, (-s, -s), (1, 2))
            h = window_partition(h, w).view(-1, w * w, c)
            bias = self.attn.bias(self.attn_mask, windows, h.dtype)
        h = self.attn(h, bias, b, counts)
        with span("piis.window"):
            h = window_reverse(h.view(-1, w, w, c), w, side, side)
            if s:
                h = torch.roll(h, (s, s), (1, 2))
            h = h.reshape(b, length, c)
        window_counts["windows"] += b * windows
        window_counts["shifted"] += 1 if s else 0
        x = x + _drop_path(h, self.drop_path, self.training, generator)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + _drop_path(h, self.drop_path, self.training, generator)


class PatchMerging(nn.Module):
    def __init__(self, resolution: int, dim: int):
        super().__init__()
        self.resolution = resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(4 * dim, out="compute")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, side², C) → (B, side²/4, 2C)."""
        with span("piis.resample"):
            b, _, c = x.shape
            x = x.view(b, self.resolution, self.resolution, c)
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], -1).view(b, -1, 4 * c)
            return _stream(self.reduction(self.norm(x)))


class PatchExpand(nn.Module):
    """``dim_scale`` 2: Linear(C, 2C), a 2×2 rearrangement to C/2 channels
    and LayerNorm(C/2); ``dim_scale`` 4 (``FinalPatchExpand_X4``):
    Linear(C, 16C), a 4×4 rearrangement to C channels and LayerNorm(C).
    ``norm_out`` is the norm's role: ``"stream"`` where the output joins
    the skip and the stream, ``"compute"`` where only the output
    convolution reads it."""

    def __init__(self, resolution: int, dim: int, dim_scale: int = 2,
                 norm_out: str = "stream"):
        super().__init__()
        self.resolution, self.dim_scale = resolution, dim_scale
        out = dim // 2 if dim_scale == 2 else dim
        self.expand = nn.Linear(dim, out * dim_scale ** 2, bias=False)
        self.norm = LayerNorm(out, out=norm_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, side², C) → (B, (scale·side)², C_out): 'b h w (p1 p2 c) -> b
        (h p1) (w p2) c'."""
        with span("piis.resample"):
            side, p = self.resolution, self.dim_scale
            x = self.expand(x)
            b, _, c = x.shape
            x = x.view(b, side, side, p, p, c // p ** 2).permute(0, 1, 3, 2, 4, 5)
            return self.norm(x.reshape(b, -1, c // p ** 2))


class FinalPatchExpand_X4(PatchExpand):  # noqa: N801 (the published name)
    def __init__(self, resolution: int, dim: int):
        super().__init__(resolution, dim, dim_scale=4, norm_out="compute")


class BasicLayer(nn.Module):
    """``depth`` Swin blocks (even ones unshifted) at one resolution, then
    ``downsample`` (encoder) or ``upsample`` (decoder) if given."""

    def __init__(self, dim: int, resolution: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, drop_path: list, downsample: bool = False,
                 upsample: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, resolution, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2, mlp_ratio, drop_path[i])
            for i in range(depth))
        if downsample:
            self.downsample = PatchMerging(resolution, dim)
        if upsample:
            self.upsample = PatchExpand(resolution, dim)

    def forward(self, x, generator, counts, window_counts):
        for block in self.blocks:
            x = block(x, generator, counts, window_counts)
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        if hasattr(self, "upsample"):
            x = self.upsample(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, out="stream")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the norm reads rows of embed_dim: one copy of the convolution's
        # (bf16 under autocast) output into token order
        return self.norm(self.proj(x).flatten(2).transpose(1, 2).contiguous())


class SwinTransformerSys(nn.Module):
    """The published network: ``patch_embed``, ``layers``, ``norm``,
    ``layers_up``, ``concat_back_dim``, ``norm_up``, ``up``, ``output``."""

    def __init__(self, img_size: int, patch_size: int, in_chans: int, num_classes: int,
                 embed_dim: int, depths: tuple, num_heads: tuple, window_size: int,
                 mlp_ratio: float, drop_path_rate: float):
        super().__init__()
        stages = len(depths)
        side = img_size // patch_size
        self.patches_resolution = side
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        dpr = [r.item() for r in torch.linspace(0, drop_path_rate, sum(depths))]

        def rates(i):
            return dpr[sum(depths[:i]):sum(depths[:i + 1])]

        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, side // 2 ** i, depths[i], num_heads[i], window_size,
                       mlp_ratio, rates(i), downsample=i < stages - 1)
            for i in range(stages))
        self.layers_up = nn.ModuleList()
        self.concat_back_dim = nn.ModuleList()
        for i in range(stages):
            j = stages - 1 - i  # the encoder stage this one mirrors
            dim, res = embed_dim * 2 ** j, side // 2 ** j
            if i == 0:
                self.layers_up.append(PatchExpand(res, dim))
                self.concat_back_dim.append(nn.Identity())
            else:
                self.layers_up.append(BasicLayer(dim, res, depths[j], num_heads[j], window_size,
                                                 mlp_ratio, rates(j), upsample=i < stages - 1))
                self.concat_back_dim.append(nn.Linear(2 * dim, dim))
        self.norm = LayerNorm(embed_dim * 2 ** (stages - 1), out="compute")
        self.norm_up = LayerNorm(embed_dim, out="compute")
        self.up = FinalPatchExpand_X4(side, embed_dim)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    def forward_features(self, x, generator, counts, window_counts):
        x = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer(x, generator, counts, window_counts)
        return self.norm(x), skips

    def forward_up_features(self, x, skips, generator, counts, window_counts):
        for i, layer in enumerate(self.layers_up):
            if i == 0:
                x = layer(x)
            else:
                x = _stream(self.concat_back_dim[i](torch.cat([x, skips[-1 - i]], -1)))
                x = layer(x, generator, counts, window_counts)
        return self.norm_up(x)

    def up_x4(self, x: torch.Tensor) -> torch.Tensor:
        side = self.patches_resolution
        b, _, c = x.shape
        x = self.up(x).view(b, 4 * side, 4 * side, c).permute(0, 3, 1, 2)
        return self.output(x)


class SwinUnet(nn.Module):
    """Swin-Unet, NCHW: ``(B, C_in, img, img)`` → probabilities ``(B,
    out_channels, img, img)``.  The defaults are the published tiny widths;
    ``img_size`` (a multiple of patch × window × 2^(stages − 1), 224 at
    the defaults) fixes the shift masks and so the input side.  ``generator``
    makes the initialisation reproducible (module docstring)."""

    def __init__(self, img_size: int = 896, in_channels: int = 1, out_channels: int = 1,
                 generator: Optional[torch.Generator] = None, *, embed_dim: int = 96,
                 depths: tuple = (2, 2, 2, 2), num_heads: tuple = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 patch_size: int = 4):
        super().__init__()
        unit = self.side_unit(patch_size, window_size, len(depths))
        if img_size % unit:
            raise ValueError(f"img_size {img_size} is not a multiple of {unit} "
                             f"(patch {patch_size} x window {window_size} x 2^{len(depths) - 1})")
        if in_channels not in (1, 3):
            raise ValueError(f"in_channels must be 1 or 3, not {in_channels}")
        self.img_size = img_size
        self.swin_unet = SwinTransformerSys(img_size, patch_size, 3, out_channels, embed_dim,
                                            tuple(depths), tuple(num_heads), window_size,
                                            mlp_ratio, drop_path_rate)
        self.attention_counts = {"calls": 0, "pairs": 0}
        self.window_counts = {"windows": 0, "shifted": 0}
        self.reset_parameters(generator)

    @staticmethod
    def side_unit(patch_size: int = 4, window_size: int = 7, stages: int = 4) -> int:
        """The input side's unit, patch × window × 2^(stages − 1): every
        stage's map is then a whole number of windows (224 at the defaults)."""
        return patch_size * window_size * 2 ** (stages - 1)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The published ``_init_weights``: every Linear's weight and every
        bias table trunc-normal(0.02) within ±2 (timm's bounds), Linear
        biases 0, LayerNorms 1 and 0; the convolutions keep torch's
        defaults (kaiming-uniform(√5) kernels, uniform ±1/√fan-in bias),
        all drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-2.0, b=2.0,
                                      generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.shape[2:] != (self.img_size, self.img_size):
            raise ValueError(f"SwinUnet({self.img_size}) takes {self.img_size}² images, "
                             f"not {tuple(x.shape[2:])}")
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        net, counts, windows = self.swin_unet, self.attention_counts, self.window_counts
        with span("piis.transformer"):
            x, skips = net.forward_features(x, generator, counts, windows)
        with span("piis.decoder"):
            out = net.up_x4(net.forward_up_features(x, skips, generator, counts, windows))
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        return torch.sigmoid(out)
