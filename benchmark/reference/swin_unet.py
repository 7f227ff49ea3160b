"""The plain Swin-Unet (Swin-T, window 7), as functions of a parameter dict.

Written from Cao et al., arXiv:2105.05537, and its code
(``HuCaoFighting/Swin-Unet``: ``networks/vision_transformer.py::SwinUnet``,
``networks/swin_transformer_unet_skip_expand_decoder_sys.py``,
``configs/swin_tiny_patch4_window7_224_lite.yaml``), with Swin Transformer's
blocks (Liu et al., arXiv:2103.14030).  The parameter names are that
model's ``state_dict`` keys (``swin_unet.`` and the module path).

* A 1-channel image is repeated to 3 channels.  Patch embedding: a
  ``patch_size`` x ``patch_size`` convolution with bias at that stride to
  ``embed_dim``, flattened to tokens, LayerNorm (eps 1e-5, as every norm).
* Four encoder stages of ``depths`` blocks at widths ``embed_dim * 2^i``.
  A block: ``x + dp(proj(attn(shift(LN x))))``, then ``x +
  dp(fc2(gelu(fc1(LN x))))``, exact GELU.  Odd blocks roll the map by
  ``-(window // 2)`` on both axes, split it into window x window windows,
  attend within each and put the windows back and roll by ``+(window //
  2)``; a stage whose side is at most the window uses one window of the
  whole side and no roll.  Attention per window and head:
  ``softmax((q / sqrt(d)) k^T + B + M) v``, B the bias table's row
  ``(dr + w - 1) * (2w - 1) + dc + w - 1`` for each query-key offset (dr,
  dc), M -100 between tokens whose rolled positions lie in different
  regions of the three slices ``(0, -w), (-w, -s), (-s, None)`` on each
  axis, else 0.  Stages 0-2 end in patch merging: the 2x2 neighbours
  ``x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]``
  concatenated, LayerNorm, a linear to twice the width without bias.  A
  final LayerNorm.  The inputs of the four stages are the skips.
* Decoder: patch expansion of the bottleneck (a linear to twice the width
  without bias, each token's channels split 2x2 into four tokens of a
  quarter of them, LayerNorm); then for each shallower stage, the skip
  concatenated on channels, a linear back to the stage's width, the
  stage's depth of blocks with its heads and drop-path rates, and, but for
  the last, a patch expansion.  A LayerNorm, the x4 expansion (a linear to
  16 times the width without bias, each token split 4x4, LayerNorm) and a
  1x1 convolution without bias to ``n_classes`` logits.
* Stochastic depth: rates ``linspace(0, drop_path_rate, sum(depths))`` over
  the encoder's blocks, each decoder stage with its encoder stage's.  Each
  keep mask is one float32 ``bernoulli_(1 - p)`` a sample, drawn from the
  generator in the order the blocks run (encoder, then decoder), the
  attention branch's before the MLP branch's; a block of rate 0 draws none.

Departures from the published code, all of the benchmark's Stage II setup:
``n_classes`` logits for a sigmoid (the published head gives 9 for a
softmax); the Stage II objective and AdamW (:mod:`.swinunet_steps`) in
place of Dice + cross-entropy and SGD; random weights from the seed where
the published run loads ImageNet Swin-T ones.

Float32 throughout (TF32 off: :func:`.steps.no_tf32`), with the norms
written from means and variances and attention as plain products and a
softmax over the (windows, heads, N, N) scores.  Every block, every
resampling step and the head run under ``torch.utils.checkpoint`` when a
gradient is wanted, so that a batch of eight 896x896 images fits on one
card in float32.  ``quant`` asks for a lower precision of every
convolution's and matrix product's operands as in :mod:`.unet`: ``"fp8"``
rounds each to e4m3 (one scale a tensor) and the product to bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .unet import _Round

__all__ = ["param_shapes", "init_params", "forward", "stages", "relative_index", "region_mask"]

P = "swin_unet."


def stages(model: dict, image_size: int) -> list[dict]:
    """Each encoder stage: its ``dim``, map ``side``, ``depth``, ``heads``,
    ``window``, whether its odd blocks ``shift``, and its blocks' drop-path
    ``rates``."""
    depths, side = model["depths"], image_size // model["patch_size"]
    dpr = [r.item() for r in torch.linspace(0, model["drop_path_rate"], sum(depths))]
    out = []
    for i, depth in enumerate(depths):
        s, w = side // 2 ** i, model["window_size"]
        out.append({"dim": model["embed_dim"] * 2 ** i, "side": s, "depth": depth,
                    "heads": model["num_heads"][i], "window": min(w, s), "shift": s > w,
                    "rates": dpr[sum(depths[:i]):sum(depths[:i + 1])]})
    return out


def _blocks(prefix: str, st: dict, mlp: int) -> dict:
    s, w, c = {}, st["window"], st["dim"]
    for j in range(st["depth"]):
        p = f"{prefix}blocks.{j}."
        s.update({f"{p}norm1.weight": (c,), f"{p}norm1.bias": (c,),
                  f"{p}attn.relative_position_bias_table": ((2 * w - 1) ** 2, st["heads"]),
                  f"{p}attn.qkv.weight": (3 * c, c), f"{p}attn.qkv.bias": (3 * c,),
                  f"{p}attn.proj.weight": (c, c), f"{p}attn.proj.bias": (c,),
                  f"{p}norm2.weight": (c,), f"{p}norm2.bias": (c,),
                  f"{p}mlp.fc1.weight": (mlp * c, c), f"{p}mlp.fc1.bias": (mlp * c,),
                  f"{p}mlp.fc2.weight": (c, mlp * c), f"{p}mlp.fc2.bias": (c,)})
    return s


def param_shapes(model: dict, image_size: int) -> dict:
    """Parameter name -> shape, in the model's module order."""
    e, mlp, st = model["embed_dim"], int(model["mlp_ratio"]), stages(model, image_size)
    ps = model["patch_size"]
    s = {f"{P}patch_embed.proj.weight": (e, 3, ps, ps), f"{P}patch_embed.proj.bias": (e,),
         f"{P}patch_embed.norm.weight": (e,), f"{P}patch_embed.norm.bias": (e,)}
    for i, stage in enumerate(st):
        s.update(_blocks(f"{P}layers.{i}.", stage, mlp))
        if i < len(st) - 1:
            c = stage["dim"]
            s.update({f"{P}layers.{i}.downsample.reduction.weight": (2 * c, 4 * c),
                      f"{P}layers.{i}.downsample.norm.weight": (4 * c,),
                      f"{P}layers.{i}.downsample.norm.bias": (4 * c,)})
    n = len(st)
    for i in range(n):
        stage = st[n - 1 - i]
        c, p = stage["dim"], f"{P}layers_up.{i}."
        if i == 0:
            s.update({f"{p}expand.weight": (2 * c, c), f"{p}norm.weight": (c // 2,),
                      f"{p}norm.bias": (c // 2,)})
            continue
        s.update(_blocks(p, stage, mlp))
        if i < n - 1:
            s.update({f"{p}upsample.expand.weight": (2 * c, c),
                      f"{p}upsample.norm.weight": (c // 2,), f"{p}upsample.norm.bias": (c // 2,)})
    for i in range(1, n):
        c = st[n - 1 - i]["dim"]
        s[f"{P}concat_back_dim.{i}.weight"], s[f"{P}concat_back_dim.{i}.bias"] = (c, 2 * c), (c,)
    top = st[-1]["dim"]
    s.update({f"{P}norm.weight": (top,), f"{P}norm.bias": (top,), f"{P}norm_up.weight": (e,),
              f"{P}norm_up.bias": (e,), f"{P}up.expand.weight": (16 * e, e),
              f"{P}up.norm.weight": (e,), f"{P}up.norm.bias": (e,),
              f"{P}output.weight": (model["n_classes"], e, 1, 1)})
    return s


def _kind(name: str) -> str:
    """``norm`` (a LayerNorm's), ``conv`` (the patch embedding's and the
    head's), ``bias`` (a linear's), else ``normal`` (linear weights and the
    bias tables)."""
    module = name.rsplit(".", 2)[-2]
    if "norm" in module:
        return "norm"
    if name.startswith((f"{P}patch_embed.proj.", f"{P}output.")):
        return "conv"
    if name.endswith(".bias"):
        return "bias"
    return "normal"


def init_params(shapes: dict, generator: torch.Generator, device) -> dict:
    """The published initialisation, from ``generator`` in two calls (one
    normal draw for the linears' weights and the bias tables, then one
    uniform draw for the convolutions): trunc-normal(0.02) within +-2
    (timm's bounds: in effect a normal), linear biases 0, norms 1 and 0,
    convolutions uniform within 1/sqrt(fan-in) (torch's defaults)."""
    names = list(shapes)
    sizes = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    kinds = {n: _kind(n) for n in names}
    normal = [n for n in names if kinds[n] == "normal"]
    conv = [n for n in names if kinds[n] == "conv"]
    g = torch.randn(sum(sizes[n] for n in normal), generator=generator, device=device)
    u = torch.rand(sum(sizes[n] for n in conv), generator=generator, device=device)
    out = {}
    for n, t in zip(normal, torch.split(g, [sizes[n] for n in normal])):
        out[n] = (t * 0.02).clamp_(-2.0, 2.0).view(shapes[n])
    for n, t in zip(conv, torch.split(u, [sizes[n] for n in conv])):
        w = shapes[n.rsplit(".", 1)[0] + ".weight"]
        out[n] = ((2 * t - 1) / math.sqrt(int(torch.Size(w[1:]).numel()))).view(shapes[n])
    for n in names:
        if kinds[n] == "norm":
            out[n] = torch.full(shapes[n], 1.0 if n.endswith("weight") else 0.0, device=device)
        elif kinds[n] == "bias":
            out[n] = torch.zeros(shapes[n], device=device)
    return {n: out[n] for n in names}


def relative_index(w: int) -> torch.Tensor:
    """(w^2, w^2): the bias table's row for each query-key pair of a window."""
    row, col = torch.arange(w * w) // w, torch.arange(w * w) % w
    return ((row[:, None] - row[None, :] + w - 1) * (2 * w - 1)
            + (col[:, None] - col[None, :] + w - 1))


def _partition(x, w):
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _reverse(x, w, side):
    c = x.shape[-1]
    x = x.view(-1, side // w, side // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, side, side, c)


def region_mask(side: int, w: int, s: int) -> torch.Tensor:
    """(windows, w^2, w^2) float32: the published ``attn_mask``, -100
    between tokens of the rolled map's different regions, else 0."""
    img = torch.zeros(1, side, side, 1)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = _partition(img, w)[..., 0]
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def _roll(x, s):
    return torch.roll(x, shifts=(s, s), dims=(1, 2))


def _relative_bias(table, w):
    n = w * w
    return table[relative_index(w).to(table.device).view(-1)].view(n, n, -1).permute(2, 0, 1)


def _q(x, quant):
    return x if quant is None else _Round.apply(x, quant)


def _out(y, quant):
    return y if quant is None else _Round.apply(y, "bf16")


def _linear(x, w, b=None, quant=None):
    y = _out(_q(x, quant) @ _q(w, quant).t(), quant)
    return y if b is None else y + b


def _matmul(a, b, quant=None):
    return _out(_q(a, quant) @ _q(b, quant), quant)


def _layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _attention(Q, p, heads, w, mask, quant, x):
    """(B*nW, N, C) windows -> the same after ``proj``."""
    bw, n, c = x.shape
    d = c // heads
    qkv = _linear(x, Q[f"{p}qkv.weight"], Q[f"{p}qkv.bias"], quant)
    qkv = qkv.reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    a = _matmul(q, k.transpose(-2, -1), quant)
    a = a + _relative_bias(Q[f"{p}relative_position_bias_table"], w).unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        a = (a.view(bw // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)).view(-1, heads,
                                                                                       n, n)
    o = _matmul(torch.softmax(a, dim=-1), v, quant).transpose(1, 2).reshape(bw, n, c)
    return _linear(o, Q[f"{p}proj.weight"], Q[f"{p}proj.bias"], quant)


def _block(Q, p, st, shifted, rate, quant, x, keep1, keep2):
    b, length, c = x.shape
    side, w = st["side"], st["window"]
    s = w // 2 if shifted else 0
    h = _layer_norm(x, Q[f"{p}norm1.weight"], Q[f"{p}norm1.bias"]).view(b, side, side, c)
    mask = None
    if s:
        h = _roll(h, -s)
        mask = region_mask(side, w, s).to(x.device, x.dtype)
    h = _attention(Q, f"{p}attn.", st["heads"], w, mask, quant, _partition(h, w))
    h = _reverse(h, w, side)
    if s:
        h = _roll(h, s)
    h = h.reshape(b, length, c)
    x = x + (h if keep1 is None else h * keep1 / (1.0 - rate))
    h = _layer_norm(x, Q[f"{p}norm2.weight"], Q[f"{p}norm2.bias"])
    h = _linear(F.gelu(_linear(h, Q[f"{p}mlp.fc1.weight"], Q[f"{p}mlp.fc1.bias"], quant)),
                Q[f"{p}mlp.fc2.weight"], Q[f"{p}mlp.fc2.bias"], quant)
    return x + (h if keep2 is None else h * keep2 / (1.0 - rate))


def _merge(Q, p, side, quant, x):
    b, _, c = x.shape
    x = x.view(b, side, side, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    x = _layer_norm(x.view(b, -1, 4 * c), Q[f"{p}norm.weight"], Q[f"{p}norm.bias"])
    return _linear(x, Q[f"{p}reduction.weight"], None, quant)


def _expand(Q, p, side, scale, quant, x):
    x = _linear(x, Q[f"{p}expand.weight"], None, quant)
    b, _, c = x.shape
    x = x.view(b, side, side, scale, scale, c // scale ** 2).permute(0, 1, 3, 2, 4, 5)
    return _layer_norm(x.reshape(b, -1, c // scale ** 2), Q[f"{p}norm.weight"],
                       Q[f"{p}norm.bias"])


def _head(Q, side, quant, x):
    x = _layer_norm(x, Q[f"{P}norm_up.weight"], Q[f"{P}norm_up.bias"])
    x = _expand(Q, f"{P}up.", side, 4, quant, x)
    b, _, c = x.shape
    x = x.view(b, 4 * side, 4 * side, c).permute(0, 3, 1, 2)
    return _out(F.conv2d(_q(x, quant), _q(Q[f"{P}output.weight"], quant)), quant)


def _keep(b, p, generator, device):
    if p == 0.0:
        return None
    keep = torch.empty((b, 1, 1), device=device, dtype=torch.float32)
    return keep.bernoulli_(1.0 - p, generator=generator)


def _ckpt(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stage_blocks(Q, prefix, st, quant, x, train, generator):
    for j in range(st["depth"]):
        rate = st["rates"][j] if train else 0.0
        k1 = _keep(x.shape[0], rate, generator, x.device)
        k2 = _keep(x.shape[0], rate, generator, x.device)
        x = _ckpt(lambda t, a, b, j=j, r=rate: _block(Q, f"{prefix}blocks.{j}.", st,
                                                      j % 2 == 1 and st["shift"], r, quant, t, a,
                                                      b),
                  x, k1, k2)
    return x


def forward(params: dict, x: torch.Tensor, model: dict, *, train: bool,
            drop_path_generator: Optional[torch.Generator] = None,
            quant: Optional[str] = None) -> torch.Tensor:
    """(B, 1 or 3, S, S) images -> (B, n_classes, S, S) logits.

    ``model`` is the configuration's model group (``embed_dim``,
    ``depths``, ``num_heads``, ``window_size``, ``patch_size``,
    ``mlp_ratio``, ``drop_path_rate``).  ``train``: stochastic depth with
    masks from ``drop_path_generator``."""
    Q = params
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    st = stages(model, x.shape[2])
    ps = model["patch_size"]
    t = _out(F.conv2d(_q(x, quant), _q(Q[f"{P}patch_embed.proj.weight"], quant),
                      Q[f"{P}patch_embed.proj.bias"], stride=ps), quant)
    t = _layer_norm(t.flatten(2).transpose(1, 2), Q[f"{P}patch_embed.norm.weight"],
                    Q[f"{P}patch_embed.norm.bias"])
    skips = []
    for i, stage in enumerate(st):
        skips.append(t)
        t = _stage_blocks(Q, f"{P}layers.{i}.", stage, quant, t, train, drop_path_generator)
        if i < len(st) - 1:
            t = _ckpt(lambda u, i=i, s=stage["side"]: _merge(Q, f"{P}layers.{i}.downsample.", s,
                                                              quant, u), t)
    t = _layer_norm(t, Q[f"{P}norm.weight"], Q[f"{P}norm.bias"])
    n = len(st)
    for i in range(n):
        stage = st[n - 1 - i]
        p = f"{P}layers_up.{i}."
        if i == 0:
            t = _ckpt(lambda u, p=p, s=stage["side"]: _expand(Q, p, s, 2, quant, u), t)
            continue
        t = _linear(torch.cat([t, skips[n - 1 - i]], -1), Q[f"{P}concat_back_dim.{i}.weight"],
                    Q[f"{P}concat_back_dim.{i}.bias"], quant)
        t = _stage_blocks(Q, p, stage, quant, t, train, drop_path_generator)
        if i < n - 1:
            t = _ckpt(lambda u, p=p, s=stage["side"]: _expand(Q, f"{p}upsample.", s, 2, quant, u),
                      t)
    return _ckpt(lambda u: _head(Q, st[0]["side"], quant, u), t)
