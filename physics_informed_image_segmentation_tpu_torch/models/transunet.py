"""TransUNet, R50-ViT-B/16 (PyTorch): NCHW at its interface, NHWC inside the decoder.

Chen et al., "TransUNet: Transformers Make Strong Encoders for Medical
Image Segmentation" (arXiv:2102.04306), as its code has it
(``Beckschen/TransUNet``: ``networks/vit_seg_configs.py::get_r50_b16_config``,
``networks/vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``).
The module names are that code's, so the ``state_dict`` keys are too
(``transformer.embeddings.hybrid_model.root.conv.weight``,
``transformer.encoder.layer.{i}.attn.query.weight``,
``decoder.blocks.{i}.conv1.0.weight``, ``segmentation_head.0.weight``, ...).

* A 1-channel image is repeated to 3 channels.
* ResNetV2 encoder: weight-standardised convolutions (``StdConv2d``: the
  weight less its mean, over its population standard deviation over
  (cin, kh, kw) with 1e-5 under the root) and GroupNorm, each GroupNorm
  with its residual add and ReLU one call of ``ops.group_norm``'s kernels
  on the card.  Root: 7×7 stride 2, GroupNorm(32, eps 1e-6), ReLU (skip
  3), then a 3×3 stride-2 max pool with no padding.  Body: bottleneck
  blocks of (3, 4, 9) units; the first block's output is zero-padded at the
  bottom and right to a quarter of the input side (skip 2: 255² → 256² at
  1024²), and the main path goes on unpadded; the second block's output is
  skip 1.
* Embeddings: a 1×1 convolution to the hidden width, flattened to tokens
  (a 64×64 grid at 1024²: 4096 tokens), a learned position table, dropout.
* Encoder: pre-LN blocks (LayerNorm eps 1e-6): ``x + out(attn(LN(x)))``,
  then ``x + drop(fc2(drop(gelu(fc1(LN(x))))))`` with exact GELU; a final
  LayerNorm.  Attention is ``softmax(q kᵀ / sqrt(d_head)) v`` through
  ``F.scaled_dot_product_attention``, restricted to the fused backends
  (cuDNN, flash, memory-efficient; on the CPU, flash): a query of the math
  backend raises instead of forming the (B, heads, N, N) scores.
* Decoder: the tokens back to a (B, hidden, g, g) map, ``conv_more`` (3×3,
  BatchNorm, ReLU) to 512 channels, then four blocks of bilinear ×2
  upsampling (``align_corners=True``), concatenation with the skip, and
  two (3×3, BatchNorm, ReLU).
* Head: a 3×3 convolution to ``out_channels`` at full resolution; its
  logits are cast to float32 before the sigmoid.

The decoder runs channels-last (NHWC) from ``conv_more`` to the head: the
tokens' map is a channels-last view, and each skip is made channels-last
before its concatenation, so cuDNN takes its NHWC convolutions without
transposing the activations and BatchNorm its channels-last kernels, which
split a channel's reduction over many blocks where the NCHW ones give each
channel one.  With one output channel the head's NHWC output is also a
contiguous NCHW tensor.  Parameters keep their NCHW storage.

Departures from the published model: ``out_channels`` logits through a
sigmoid (the published head gives 2 classes to a softmax); random weights
where the published run loads ImageNet-21k ones, and so a trunc-normal
(0.02) position table where it loads a pretrained one.

Dropout is elementwise, its keep masks drawn as float32 ``bernoulli_(1 -
p)`` from the ``generator`` given to ``forward``, in this order: the
embeddings' mask, then, block by block, the mask after the GELU and the
mask after fc2.  ``attention_counts`` totals the attention calls and
their query-key ``pairs`` (batch × heads × queries × keys);
``layout_counts`` totals the inputs of the ten decoder and head
convolutions that were channels-last (``nhwc``) and those that were not
(``nchw``); ``norm_counts`` totals the ResNet's GroupNorm calls (52 a
forward at the published block units) that took the hand-written kernels
(``fused``: ``ops/group_norm.py``, every call on the card, which raises on
a map they do not take) and those that took their plain PyTorch version
(``plain``: every call on the CPU).

Under ``torch.profiler`` the forward opens the spans ``piis.resnet`` (root
and body), ``piis.transformer`` (embeddings, blocks, final norm) with
``piis.attention`` (each attention call) inside it, and ``piis.decoder``
(``conv_more``, the blocks, the head).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.group_norm import group_norm_act
from ..utils.profiling import span

__all__ = ["TransUNet"]

FUSED_ATTENTION = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                   SDPBackend.EFFICIENT_ATTENTION]
HEAD_CHANNELS = 512  # conv_more's output width, a constant of the published decoder


def _dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout with a float32 keep mask drawn from ``generator``."""
    keep = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    keep.bernoulli_(1.0 - p, generator=generator)
    return x * keep.mul_(1.0 / (1.0 - p)).to(x.dtype)


class StdConv2d(nn.Conv2d):
    """A convolution with a weight-standardised kernel and no bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (w - mean) / sqrt(var + 1e-5) over (cin, kh, kw) is a LayerNorm of
        # each output channel's row: one kernel each way, where var_mean and
        # its arithmetic launch kernels the profiler links to no host
        # operation on the card
        w = self.weight
        w = F.layer_norm(w.reshape(w.shape[0], -1), (w[0].numel(),), eps=1e-5)
        return F.conv2d(x, w.view_as(self.weight), None, self.stride, self.padding)


def _std(cin: int, cout: int, k: int, stride: int = 1) -> StdConv2d:
    return StdConv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class PreActBottleneck(nn.Module):
    """1×1 → GN → ReLU → 3×3 (stride) → GN → ReLU → 1×1 → GN, plus the
    input (or its strided 1×1 projection with one group a channel), ReLU.
    Each GN with what follows it is one :func:`group_norm_act`: gn1's and
    gn2's outputs keep the convolution's type (the next convolution reads
    them), gn_proj's is float32, and so is gn3's where it is the next
    unit's residual, with a bf16 copy for the next unit's convolutions
    (``last``: the block's last unit, whose output only convolutions and a
    skip read, keeps the convolution's type and makes no copy)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = _std(cin, cmid, 1)
        self.gn2 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = _std(cmid, cmid, 3, stride)
        self.gn3 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv3 = _std(cmid, cout, 1)
        if stride != 1 or cin != cout:
            self.downsample = _std(cin, cout, 1, stride)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor, counts: dict, x_low: Optional[torch.Tensor] = None,
                last: bool = False):
        """``(y, y_low)``: the unit's output, and where the kernels wrote it
        in float32 from bf16 maps, its bf16 copy for the next unit's
        convolutions (else None).  ``x_low``: the input's bf16 copy, read by
        the convolutions in place of ``x`` (the residual)."""
        conv_in = x if x_low is None else x_low
        residual = x
        if hasattr(self, "downsample"):
            residual = group_norm_act(self.downsample(conv_in), self.gn_proj, counts, relu=False)
        y = group_norm_act(self.conv1(conv_in), self.gn1, counts, keep_dtype=True)
        y = group_norm_act(self.conv2(y), self.gn2, counts, keep_dtype=True)
        if last:
            return group_norm_act(self.conv3(y), self.gn3, counts, residual=residual,
                                  keep_dtype=True), None
        return group_norm_act(self.conv3(y), self.gn3, counts, residual=residual, low_copy=True)


class ResNetV2(nn.Module):
    """Root and three bottleneck blocks; ``forward`` returns the last
    block's output and the skips in the decoder's order.  The root's and
    each block's output keep the convolution's type: the max pool, the
    next block's convolutions, the token embedding and the skips'
    concatenation read them, and the convolutions after all of these cast
    to it first."""

    def __init__(self, block_units: tuple, width: int):
        super().__init__()
        self.root = nn.ModuleDict(OrderedDict([
            ("conv", StdConv2d(3, width, 7, stride=2, padding=3, bias=False)),
            ("gn", nn.GroupNorm(32, width, eps=1e-6)),
        ]))
        blocks = []
        for i, (units, cin, cout, cmid, stride) in enumerate(zip(
                block_units, (width, 4 * width, 8 * width), (4 * width, 8 * width, 16 * width),
                (width, 2 * width, 4 * width), (1, 2, 2))):
            unit = [(f"unit{u}", PreActBottleneck(cin if u == 1 else cout, cout, cmid,
                                                  stride if u == 1 else 1))
                    for u in range(1, units + 1)]
            blocks.append((f"block{i + 1}", nn.Sequential(OrderedDict(unit))))
        self.body = nn.Sequential(OrderedDict(blocks))

    def forward(self, x: torch.Tensor, counts: dict):
        side = x.shape[2]
        x = group_norm_act(self.root.conv(x), self.root.gn, counts, keep_dtype=True)
        features = [x]
        x = F.max_pool2d(x, 3, 2)
        for i, block in enumerate(self.body):
            x_low = None
            for u, unit in enumerate(block):
                x, x_low = unit(x, counts, x_low, last=u == len(block) - 1)
            if i < len(self.body) - 1:
                pad = side // 4 // (i + 1) - x.shape[2]  # 1 after the first block, else 0
                features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return x, features[::-1]


class Embeddings(nn.Module):
    """The ResNet (``hybrid_model``), then its output as tokens: a 1×1
    convolution, the position table, dropout."""

    def __init__(self, img_size: int, hidden: int, block_units: tuple, width: int,
                 dropout: float):
        super().__init__()
        grid = img_size // 16
        self.hybrid_model = ResNetV2(block_units, width)
        self.patch_embeddings = nn.Conv2d(16 * width, hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, grid * grid, hidden))
        self.dropout = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The ResNet's output (B, 16·width, g, g) → (B, g², hidden) tokens."""
        x = self.patch_embeddings(x).flatten(2).transpose(1, 2) + self.position_embeddings
        if self.training and self.dropout > 0:
            x = _dropout(x, self.dropout, generator)
        return x


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, counts: dict) -> torch.Tensor:
        b, n, hidden = x.shape

        def heads(t):
            return t.view(b, n, self.heads, hidden // self.heads).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        with span("piis.attention"), sdpa_kernel(FUSED_ATTENTION):
            o = F.scaled_dot_product_attention(q, k, v)
        counts["calls"] += 1
        counts["pairs"] += b * self.heads * n * n
        return self.out(o.transpose(1, 2).reshape(b, n, hidden))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)


class Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, dropout: float):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp_dim)
        self.attn = Attention(hidden, heads)
        self.dropout = dropout

    def forward(self, x, generator, counts):
        x = x + self.attn(self.attention_norm(x), counts)
        drop = self.training and self.dropout > 0
        h = F.gelu(self.ffn.fc1(self.ffn_norm(x)))
        if drop:
            h = _dropout(h, self.dropout, generator)
        h = self.ffn.fc2(h)
        if drop:
            h = _dropout(h, self.dropout, generator)
        return x + h


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, mlp_dim: int, dropout: float):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp_dim, dropout) for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, x, generator, counts):
        for block in self.layer:
            x = block(x, generator, counts)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    """The published container of the embeddings and the encoder."""

    def __init__(self, embeddings: Embeddings, encoder: Encoder):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
                         nn.ReLU())


def _counted(x: torch.Tensor, counts: dict) -> torch.Tensor:
    """``x``, a convolution's input, counted in ``counts`` by its layout."""
    counts["nhwc" if x.is_contiguous(memory_format=torch.channels_last) else "nchw"] += 1
    return x


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin + skip, cout)
        self.conv2 = _conv_bn_relu(cout, cout)

    def forward(self, x, skip, counts):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip is not None:
            # cat keeps the layout of its inputs only when they share it
            x = torch.cat([x, skip.contiguous(memory_format=torch.channels_last)], dim=1)
        x = self.conv1(_counted(x, counts))
        return self.conv2(_counted(x, counts))


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, channels: tuple, skips: tuple):
        super().__init__()
        self.conv_more = _conv_bn_relu(hidden, HEAD_CHANNELS)
        ins = (HEAD_CHANNELS,) + tuple(channels[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s) for i, o, s in zip(ins, channels, skips))

    def forward(self, tokens, features, counts):
        b, n, hidden = tokens.shape
        g = math.isqrt(n)
        # a channels-last view of the tokens, with channels-last strides at
        # any batch (a transpose and reshape give a batch of one a stride
        # that convolutions read as NCHW)
        x = tokens.reshape(b, g, g, hidden).permute(0, 3, 1, 2)
        x = self.conv_more(_counted(x, counts))
        for i, block in enumerate(self.blocks):
            x = block(x, features[i] if i < len(features) else None, counts)
        return x


class TransUNet(nn.Module):
    """TransUNet R50-ViT-B/16, NCHW: ``(B, C_in, img, img)`` → probabilities
    ``(B, out_channels, img, img)``.  The defaults are the published
    widths; ``img_size`` (a multiple of 16) fixes the position table's
    ``(img_size / 16)²`` rows and so the input side.  108,271,121
    parameters at 1024² (105,275,921 at 224²).  ``generator`` makes the
    initialisation reproducible (module docstring)."""

    def __init__(self, img_size: int = 1024, in_channels: int = 1, out_channels: int = 1,
                 dropout: float = 0.1, generator: Optional[torch.Generator] = None, *,
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, block_units: tuple = (3, 4, 9), width: int = 64,
                 decoder_channels: tuple = (256, 128, 64, 16)):
        super().__init__()
        if img_size % 16:
            raise ValueError(f"img_size {img_size} is not a multiple of 16")
        if in_channels not in (1, 3):
            raise ValueError(f"in_channels must be 1 or 3, not {in_channels}")
        self.img_size = img_size
        self.transformer = Transformer(
            Embeddings(img_size, hidden_size, tuple(block_units), width, dropout),
            Encoder(hidden_size, num_layers, num_heads, mlp_dim, dropout))
        # the published n_skip = 3: the fourth block has no skip
        self.decoder = DecoderCup(hidden_size, tuple(decoder_channels),
                                  (8 * width, 4 * width, width, 0))
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], out_channels, 3, padding=1), nn.Identity())
        self.attention_counts = {"calls": 0, "pairs": 0}
        self.layout_counts = {"nhwc": 0, "nchw": 0}
        self.norm_counts = {"fused": 0, "plain": 0}
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's defaults (kaiming-uniform(√5) kernels, uniform ±1/√fan-in
        biases, unit norms) drawn from ``generator``, then the published
        MLP init (xavier-uniform weights, normal(1e-6) biases) and a
        trunc-normal(0.02) position table."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(m.weight[0].numel())
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
        for block in self.transformer.encoder.layer:
            for fc in (block.ffn.fc1, block.ffn.fc2):
                nn.init.xavier_uniform_(fc.weight, generator=generator)
                nn.init.normal_(fc.bias, std=1e-6, generator=generator)
        nn.init.trunc_normal_(self.transformer.embeddings.position_embeddings, std=0.02,
                              a=-0.04, b=0.04, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.shape[2:] != (self.img_size, self.img_size):
            raise ValueError(f"TransUNet({self.img_size}) takes {self.img_size}² images, "
                             f"not {tuple(x.shape[2:])}")
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        emb = self.transformer.embeddings
        with span("piis.resnet"):
            x, features = emb.hybrid_model(x, self.norm_counts)
        with span("piis.transformer"):
            tokens = self.transformer.encoder(emb(x, generator), generator,
                                              self.attention_counts)
        with span("piis.decoder"):
            x = self.decoder(tokens, features, self.layout_counts)
            out = self.segmentation_head(_counted(x, self.layout_counts))
        out = out.to(torch.promote_types(out.dtype, torch.float32))
        return torch.sigmoid(out)
