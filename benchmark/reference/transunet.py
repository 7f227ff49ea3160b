"""The plain TransUNet R50-ViT-B/16, as functions of a parameter dict.

Written from Chen et al., arXiv:2102.04306, and its code
(``Beckschen/TransUNet``: ``networks/vit_seg_configs.py::get_r50_b16_config``,
``networks/vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``).
The parameter names are that model's ``state_dict`` keys.

* A 1-channel image is repeated to 3 channels.
* ResNetV2: every convolution weight-standardised, ``(w - mean) /
  sqrt(var + 1e-5)`` over (cin, kh, kw) with the population variance, no
  bias.  Root: 7x7 stride 2 pad 3, GroupNorm(32, eps 1e-6), ReLU (a skip),
  max pool 3x3 stride 2 with no padding.  A bottleneck unit: ``relu(gn1(1x1
  x))``, ``relu(gn2(3x3 stride))``, ``gn3(1x1)``, plus ``x`` or
  ``gn_proj(1x1 stride x)`` (one group a channel, eps 1e-5), ReLU.  Blocks
  of ``block_units`` units, widths 4w, 8w, 16w, the second and third
  starting with stride 2.  The first and second block's outputs are skips,
  the first zero-padded at the bottom and right to a quarter of the input's
  side.
* Tokens: a 1x1 convolution with bias to the hidden width, flattened, plus
  the position table, dropout.  Each block, pre-LN (eps 1e-6):
  ``x + out(softmax(q k^T / sqrt(d_head)) v)`` over ``num_heads`` heads, then
  ``x + drop(fc2(drop(gelu(fc1(LN x)))))`` with the exact GELU; a final
  LayerNorm.
* Decoder: the tokens as a (B, hidden, g, g) map, a 3x3 convolution without
  bias to 512 channels, BatchNorm (momentum 0.1, eps 1e-5), ReLU; four
  blocks of bilinear x2 upsampling with the corners aligned, the skip
  concatenated (none for the fourth), two (3x3 convolution, BatchNorm,
  ReLU).  Head: a 3x3 convolution with bias to ``n_classes`` logits.

Departures from the published code, all of the benchmark's Stage II setup:
``n_classes`` logits for a sigmoid (the published head gives 2 for a
softmax); the Stage II objective and AdamW (:mod:`.transunet_steps`) in
place of Dice + cross-entropy and SGD; random weights from the seed where
the published run loads ImageNet-21k ones, and a trunc-normal(0.02)
position table where it loads a pretrained one.

Float32 throughout (TF32 off: :func:`.steps.no_tf32`), with the norms
written from means and variances.  Attention is plain matrix products and a
softmax, ``ATTN_ROWS`` query rows at a time; BatchNorm takes the statistics
of the whole batch.  Every ResNet unit, transformer block and decoder stage
runs under ``torch.utils.checkpoint`` when a gradient is wanted, so that a
batch of eight 1024x1024 images fits on one card in float32.  ``quant``
asks for a lower precision of every convolution's and matrix product's
operands as in :mod:`.unet`: ``"fp8"`` rounds each to e4m3 (one scale a
tensor) and the product to bfloat16.

Dropout is elementwise, each keep mask a float32 ``bernoulli_(1 - p)`` drawn
from the generator in this order: the tokens' mask, then block by block the
mask after the GELU and the mask after fc2.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .unet import _Round

__all__ = ["param_shapes", "init_params", "init_buffers", "forward", "ATTN_ROWS",
           "HEAD_CHANNELS"]

ATTN_ROWS = 1024  # query rows a piece of the attention
HEAD_CHANNELS = 512
EMB = "transformer.embeddings."
RESNET = EMB + "hybrid_model."


def _units(model: dict):
    """``(prefix, cin, cout, cmid, stride)`` of every bottleneck unit."""
    w = model["width"]
    for i, n in enumerate(model["block_units"]):
        cin, cout, cmid = (w, 4 * w, w) if i == 0 else (4 * w * 2 ** (i - 1), 4 * w * 2 ** i,
                                                        w * 2 ** i)
        for u in range(1, n + 1):
            yield (f"{RESNET}body.block{i + 1}.unit{u}.", cin if u == 1 else cout, cout, cmid,
                   (1 if i == 0 else 2) if u == 1 else 1)


def _decoder(model: dict):
    """``(prefix, cin, cout)`` of every 3x3 convolution with a BatchNorm."""
    w, dec = model["width"], model["decoder_channels"]
    skips = (8 * w, 4 * w, w, 0)
    yield "decoder.conv_more.", model["hidden_size"], HEAD_CHANNELS
    for i, (cin, cout) in enumerate(zip((HEAD_CHANNELS,) + tuple(dec[:-1]), dec)):
        yield f"decoder.blocks.{i}.conv1.", cin + skips[i], cout
        yield f"decoder.blocks.{i}.conv2.", cout, cout


def param_shapes(model: dict, image_size: int) -> dict:
    """Parameter name -> shape, in the order the weights are drawn."""
    w, hid, mlp = model["width"], model["hidden_size"], model["mlp_dim"]
    s = {f"{RESNET}root.conv.weight": (w, 3, 7, 7), f"{RESNET}root.gn.weight": (w,),
         f"{RESNET}root.gn.bias": (w,)}
    for p, cin, cout, cmid, stride in _units(model):
        s.update({f"{p}conv1.weight": (cmid, cin, 1, 1), f"{p}gn1.weight": (cmid,),
                  f"{p}gn1.bias": (cmid,), f"{p}conv2.weight": (cmid, cmid, 3, 3),
                  f"{p}gn2.weight": (cmid,), f"{p}gn2.bias": (cmid,),
                  f"{p}conv3.weight": (cout, cmid, 1, 1), f"{p}gn3.weight": (cout,),
                  f"{p}gn3.bias": (cout,)})
        if stride != 1 or cin != cout:
            s.update({f"{p}downsample.weight": (cout, cin, 1, 1), f"{p}gn_proj.weight": (cout,),
                      f"{p}gn_proj.bias": (cout,)})
    s[f"{EMB}patch_embeddings.weight"] = (hid, 16 * w, 1, 1)
    s[f"{EMB}patch_embeddings.bias"] = (hid,)
    s[f"{EMB}position_embeddings"] = (1, (image_size // 16) ** 2, hid)
    for i in range(model["num_layers"]):
        p = f"transformer.encoder.layer.{i}."
        for norm in ("attention_norm", "ffn_norm"):
            s[f"{p}{norm}.weight"] = s[f"{p}{norm}.bias"] = (hid,)
        for lin in ("query", "key", "value", "out"):
            s[f"{p}attn.{lin}.weight"], s[f"{p}attn.{lin}.bias"] = (hid, hid), (hid,)
        s[f"{p}ffn.fc1.weight"], s[f"{p}ffn.fc1.bias"] = (mlp, hid), (mlp,)
        s[f"{p}ffn.fc2.weight"], s[f"{p}ffn.fc2.bias"] = (hid, mlp), (hid,)
    s["transformer.encoder.encoder_norm.weight"] = (hid,)
    s["transformer.encoder.encoder_norm.bias"] = (hid,)
    for p, cin, cout in _decoder(model):
        s.update({f"{p}0.weight": (cout, cin, 3, 3), f"{p}1.weight": (cout,),
                  f"{p}1.bias": (cout,)})
    s["segmentation_head.0.weight"] = (model["n_classes"], model["decoder_channels"][-1], 3, 3)
    s["segmentation_head.0.bias"] = (model["n_classes"],)
    return s


def init_buffers(model: dict, device) -> dict:
    """Every BatchNorm's running mean 0 and variance 1, and its count 0."""
    out = {}
    for p, _, cout in _decoder(model):
        out[f"{p}1.running_mean"] = torch.zeros(cout, device=device)
        out[f"{p}1.running_var"] = torch.ones(cout, device=device)
        out[f"{p}1.num_batches_tracked"] = torch.zeros((), device=device, dtype=torch.long)
    return out


def _is_norm(name: str) -> bool:
    """A GroupNorm's, LayerNorm's or BatchNorm's (a decoder stage's ``1``) parameter."""
    module = name.rsplit(".", 2)[-2]
    return module.startswith("gn") or module.endswith("_norm") or module == "1"


def init_params(shapes: dict, generator: torch.Generator, device) -> dict:
    """The published initialisation, from ``generator`` in two large calls
    (one uniform draw for all, one normal draw for the MLP biases):
    kernels uniform within 1/sqrt(fan-in) and biases alike (torch's
    defaults), the MLP's kernels xavier-uniform and biases normal(1e-6),
    norms 1 and 0, the position table trunc-normal(0.02) within 2 sigma."""
    names = list(shapes)
    sizes = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    mlp_b = [n for n in names if n.endswith(("fc1.bias", "fc2.bias"))]
    norms = [n for n in names if _is_norm(n)]
    drawn = [n for n in names if n not in mlp_b and n not in norms]
    u = torch.rand(sum(sizes[n] for n in drawn), generator=generator, device=device)
    g = torch.randn(sum(sizes[n] for n in mlp_b), generator=generator, device=device)
    out = {}
    for n, t in zip(drawn, torch.split(u, [sizes[n] for n in drawn])):
        if n.endswith("position_embeddings"):  # inverse CDF of the normal within +-2 sigma
            lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
            t = torch.erfinv(2 * (lo + t * (hi - lo)) - 1) * (0.02 * math.sqrt(2))
        else:
            w = shapes[n.rsplit(".", 1)[0] + ".weight"]
            fan_in = int(torch.Size(w[1:]).numel())
            if n.endswith(("fc1.weight", "fc2.weight")):
                bound = math.sqrt(6.0 / (w[0] + w[1]))
            else:
                bound = 1.0 / math.sqrt(fan_in)
            t = (2 * t - 1) * bound
        out[n] = t.view(shapes[n])
    for n, t in zip(mlp_b, torch.split(g, [sizes[n] for n in mlp_b])):
        out[n] = (t * 1e-6).view(shapes[n])
    for n in norms:
        fill = 1.0 if n.endswith("weight") else 0.0
        out[n] = torch.full(shapes[n], fill, device=device)
    return {n: out[n] for n in names}


def _q(x, quant):
    return x if quant is None else _Round.apply(x, quant)


def _out(y, quant):
    return y if quant is None else _Round.apply(y, "bf16")


def _conv(x, w, b=None, quant=None, std=False, **kw):
    if std:
        mean = w.mean((1, 2, 3), keepdim=True)
        var = ((w - mean) ** 2).mean((1, 2, 3), keepdim=True)
        w = (w - mean) / torch.sqrt(var + 1e-5)
    return _out(F.conv2d(_q(x, quant), _q(w, quant), b, **kw), quant)


def _linear(x, w, b, quant=None):
    return _out(_q(x, quant) @ _q(w, quant).t(), quant) + b


def _matmul(a, b, quant=None):
    return _out(_q(a, quant) @ _q(b, quant), quant)


def _group_norm(x, groups, w, b, eps):
    n, c = x.shape[:2]
    h = x.reshape(n, groups, -1)
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    h = ((h - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return h * w.view(1, c, 1, 1) + b.view(1, c, 1, 1)


def _layer_norm(x, w, b, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _batch_norm(x, w, b, rm, rv, train, momentum=0.1, eps=1e-5):
    """(y, running mean, running variance): the batch's statistics in
    training (the running variance updated with the unbiased one), the
    running ones otherwise."""
    c = x.shape[1]
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x - mean.view(1, c, 1, 1)) ** 2).mean((0, 2, 3))
        n = x.numel() // c
        rm = (1 - momentum) * rm + momentum * mean.detach()
        rv = (1 - momentum) * rv + momentum * var.detach() * (n / (n - 1))
    else:
        mean, var = rm, rv
    y = (x - mean.view(1, c, 1, 1)) / torch.sqrt(var.view(1, c, 1, 1) + eps)
    return y * w.view(1, c, 1, 1) + b.view(1, c, 1, 1), rm, rv


def _keep(shape, p, generator, device):
    keep = torch.empty(shape, device=device, dtype=torch.float32)
    return keep.bernoulli_(1.0 - p, generator=generator)


def _ckpt(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _unit(P, p, stride, quant, x):
    y = F.relu(_group_norm(_conv(x, P[f"{p}conv1.weight"], quant=quant, std=True), 32,
                           P[f"{p}gn1.weight"], P[f"{p}gn1.bias"], 1e-6))
    y = F.relu(_group_norm(_conv(y, P[f"{p}conv2.weight"], quant=quant, std=True,
                                 stride=stride, padding=1), 32,
                           P[f"{p}gn2.weight"], P[f"{p}gn2.bias"], 1e-6))
    y = _group_norm(_conv(y, P[f"{p}conv3.weight"], quant=quant, std=True), 32,
                    P[f"{p}gn3.weight"], P[f"{p}gn3.bias"], 1e-6)
    if f"{p}downsample.weight" in P:
        cout = P[f"{p}downsample.weight"].shape[0]
        x = _group_norm(_conv(x, P[f"{p}downsample.weight"], quant=quant, std=True,
                              stride=stride), cout, P[f"{p}gn_proj.weight"],
                        P[f"{p}gn_proj.bias"], 1e-5)
    return F.relu(x + y)


def _root(P, quant, x):
    x = _conv(x, P[f"{RESNET}root.conv.weight"], quant=quant, std=True, stride=2, padding=3)
    return F.relu(_group_norm(x, 32, P[f"{RESNET}root.gn.weight"], P[f"{RESNET}root.gn.bias"],
                              1e-6))


def _attention(P, p, heads, quant, x):
    b, n, hid = x.shape
    d = hid // heads

    def split(t):
        return t.view(b, n, heads, d).transpose(1, 2)

    q = split(_linear(x, P[f"{p}attn.query.weight"], P[f"{p}attn.query.bias"], quant))
    k = split(_linear(x, P[f"{p}attn.key.weight"], P[f"{p}attn.key.bias"], quant))
    v = split(_linear(x, P[f"{p}attn.value.weight"], P[f"{p}attn.value.bias"], quant))
    rows = []
    for r in range(0, n, ATTN_ROWS):
        s = _matmul(q[:, :, r:r + ATTN_ROWS], k.transpose(2, 3), quant) / math.sqrt(d)
        rows.append(_matmul(torch.softmax(s, dim=-1), v, quant))
    o = torch.cat(rows, dim=2).transpose(1, 2).reshape(b, n, hid)
    return _linear(o, P[f"{p}attn.out.weight"], P[f"{p}attn.out.bias"], quant)


def _block(P, p, heads, p_drop, quant, x, keep1, keep2):
    x = x + _attention(P, p, heads, quant,
                       _layer_norm(x, P[f"{p}attention_norm.weight"], P[f"{p}attention_norm.bias"]))
    h = _layer_norm(x, P[f"{p}ffn_norm.weight"], P[f"{p}ffn_norm.bias"])
    h = F.gelu(_linear(h, P[f"{p}ffn.fc1.weight"], P[f"{p}ffn.fc1.bias"], quant))
    if keep1 is not None:
        h = h * keep1 / (1.0 - p_drop)
    h = _linear(h, P[f"{p}ffn.fc2.weight"], P[f"{p}ffn.fc2.bias"], quant)
    if keep2 is not None:
        h = h * keep2 / (1.0 - p_drop)
    return x + h


def _conv_bn_relu(P, B, p, train, quant, x):
    y, rm, rv = _batch_norm(_conv(x, P[f"{p}0.weight"], quant=quant, padding=1),
                            P[f"{p}1.weight"], P[f"{p}1.bias"], B[f"{p}1.running_mean"],
                            B[f"{p}1.running_var"], train)
    return F.relu(y), rm, rv


def _decoder_block(P, B, i, train, quant, x, skip):
    x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    x, rm1, rv1 = _conv_bn_relu(P, B, f"decoder.blocks.{i}.conv1.", train, quant, x)
    x, rm2, rv2 = _conv_bn_relu(P, B, f"decoder.blocks.{i}.conv2.", train, quant, x)
    return x, rm1, rv1, rm2, rv2


def forward(params: dict, buffers: dict, x: torch.Tensor, model: dict, *, train: bool,
            dropout_generator: Optional[torch.Generator] = None,
            quant: Optional[str] = None) -> tuple[torch.Tensor, dict]:
    """(B, 1 or 3, S, S) images -> ((B, n_classes, S, S) logits, buffers).

    ``model`` gives ``num_heads``, ``dropout`` and ``block_units`` (the
    configuration's model group).  ``train``: dropout with masks from
    ``dropout_generator`` and BatchNorm on the batch's statistics; the
    returned buffers hold the running statistics after this forward (the
    given ones, unchanged, without ``train``)."""
    P, B, out_buffers = params, buffers, dict(buffers)
    side = x.shape[2]
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    h = _ckpt(lambda t: _root(P, quant, t), x)
    skips = [h]
    h = F.max_pool2d(h, 3, 2)
    units = list(_units(model))
    for i, n in enumerate(model["block_units"]):
        block, units = units[:n], units[n:]
        for p, _, _, _, stride in block:
            h = _ckpt(lambda t, p=p, s=stride: _unit(P, p, s, quant, t), h)
        if i < len(model["block_units"]) - 1:
            pad = side // 4 // (i + 1) - h.shape[2]
            skips.append(F.pad(h, (0, pad, 0, pad)))
    p_drop = model["dropout"] if train else 0.0
    t = _conv(h, P[f"{EMB}patch_embeddings.weight"], P[f"{EMB}patch_embeddings.bias"], quant)
    t = t.flatten(2).transpose(1, 2) + P[f"{EMB}position_embeddings"]
    if p_drop > 0:
        t = t * _keep(t.shape, p_drop, dropout_generator, t.device) / (1.0 - p_drop)
    b, n, hid = t.shape
    mlp = P["transformer.encoder.layer.0.ffn.fc1.weight"].shape[0]
    for i in range(model["num_layers"]):
        keep1 = keep2 = None
        if p_drop > 0:
            keep1 = _keep((b, n, mlp), p_drop, dropout_generator, t.device)
            keep2 = _keep((b, n, hid), p_drop, dropout_generator, t.device)
        t = _ckpt(lambda u, k1, k2, i=i: _block(P, f"transformer.encoder.layer.{i}.",
                                                  model["num_heads"], p_drop, quant, u, k1, k2),
                  t, keep1, keep2)
    t = _layer_norm(t, P["transformer.encoder.encoder_norm.weight"],
                    P["transformer.encoder.encoder_norm.bias"])
    g = math.isqrt(n)
    h, rm, rv = _ckpt(lambda u: _conv_bn_relu(P, B, "decoder.conv_more.", train, quant, u),
                      t.transpose(1, 2).reshape(b, hid, g, g))
    stats = {"decoder.conv_more.": (rm, rv)}
    skips = skips[::-1]
    for i in range(len(model["decoder_channels"])):
        skip = skips[i] if i < len(skips) else None
        h, rm1, rv1, rm2, rv2 = _ckpt(
            lambda u, s, i=i: _decoder_block(P, B, i, train, quant, u, s), h, skip)
        stats[f"decoder.blocks.{i}.conv1."] = (rm1, rv1)
        stats[f"decoder.blocks.{i}.conv2."] = (rm2, rv2)
    logits = _conv(h, P["segmentation_head.0.weight"], P["segmentation_head.0.bias"], quant,
                   padding=1)
    if train:
        for p, (rm, rv) in stats.items():
            out_buffers[f"{p}1.running_mean"] = rm
            out_buffers[f"{p}1.running_var"] = rv
            if f"{p}1.num_batches_tracked" in out_buffers:
                out_buffers[f"{p}1.num_batches_tracked"] = out_buffers[
                    f"{p}1.num_batches_tracked"] + 1
    return logits, out_buffers
