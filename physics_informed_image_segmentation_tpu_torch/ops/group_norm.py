"""GroupNorm, residual add and ReLU: the hand-written CUDA kernels and their plain version.

``y = act((x - mu_g) * rstd_g * gamma_c + beta_c [+ r])``, the norms of
TransUNet's ResNetV2 (``models/transunet.py``): the root and gn1, gn2 with
a ReLU, gn3 with the unit's residual and a ReLU, gn_proj with neither.  No
TPU kernel has this role (``csrc/group_norm.cu`` says why it exists).

:func:`group_norm_act` is what the model calls, and always through
:class:`GroupNormAct`, with no option:

* on CUDA tensors, the kernels.  They take ``x`` bf16 or float32,
  NCHW-contiguous and 16-byte aligned, float32 ``gamma`` and ``beta``, and
  a residual (if any) a float32 map of the same shape and layout, and
  raise with :func:`kernel_refusals`' reasons on anything else (float64,
  channels-last, an offset view): the card never falls back to PyTorch's
  ``group_norm``.  The output is bf16 where the site asks to keep ``x``'s
  type (its consumers cast to bf16 first), else float32 (the residual
  stream), which is what autocast's float32 ``group_norm`` gives;
* on CPU tensors, :func:`group_norm_act_fwd_plain` and
  :func:`group_norm_act_bwd_plain`: the kernels' arithmetic in plain
  PyTorch (statistics and sums in float64, the two backward passes as the
  kernels split them), in any floating type, which the CPU tests hold
  against autograd of ``nn.GroupNorm``, the add and ``F.relu``, and the
  model's CPU tests against the JAX package.

On the residual stream (a bf16 ``x``, a float32 ``y``) a site may ask for
``y``'s bf16 copy as well (``low_copy``), for the convolutions that read
``y`` and would cast it; the backward adds that copy's gradient to ``y``'s.

Saved for the backward: the input in its own type, mean and rstd per
(sample, group) in float32, and, where a residual and a ReLU meet, one byte
an element saying which elements the ReLU passed.  No float32 copy of the
input or of the output is kept.

``launch_counts`` counts the wrapper's calls of the kernels (each is two
device kernels): ``group_norm_fwd`` a forward, ``group_norm_bwd`` a
backward; :func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from .conv_kernel import _aligned, _on_device, _stream

__all__ = [
    "GroupNormAct",
    "group_norm_act",
    "group_norm_act_bwd_plain",
    "group_norm_act_fwd_plain",
    "kernel_refusals",
    "launch_counts",
    "reset_launch_counts",
]

launch_counts = {"group_norm_fwd": 0, "group_norm_bwd": 0}

_KERNEL_TYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("group_norm")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.group_norm_splits.argtypes = [ll]
    lib.group_norm_splits.restype = i
    lib.group_norm_fwd.argtypes = [p] * 10 + [i, i, ll, i, f, i, i, i, p]
    lib.group_norm_fwd.restype = i
    lib.group_norm_bwd.argtypes = [p] * 13 + [i, i, ll, i, i, i, i, i, p]
    lib.group_norm_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _splits(length: int) -> int:
    """Blocks the library splits a segment of ``length`` elements over."""
    return _library().group_norm_splits(length)


def kernel_refusals(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                    residual: Optional[torch.Tensor], out_dtype: torch.dtype) -> list[str]:
    """Why the kernels would not take these operands (empty: they would).
    Each condition is checked on its own, so a CPU tensor names every
    reason besides its device."""
    why = []
    if x.device.type != "cuda":
        why.append(f"device {x.device.type}")
    if x.dtype not in _KERNEL_TYPES or out_dtype not in (x.dtype, torch.float32):
        why.append(f"type {x.dtype} to {out_dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        why.append("not an NCHW-contiguous map")
    elif not _aligned(x):
        why.append("not 16-byte aligned")
    if any(t is None or t.dtype != torch.float32 for t in (weight, bias)):
        why.append("gamma and beta not float32")
    if residual is not None and (residual.shape != x.shape or residual.device != x.device
                                 or residual.dtype != torch.float32 or not residual.is_contiguous()
                                 or not _aligned(residual)):
        why.append("residual not a float32 map of x's shape and layout")
    return why


def group_norm_act(x: torch.Tensor, norm: nn.GroupNorm, counts: dict,
                   residual: Optional[torch.Tensor] = None, relu: bool = True,
                   keep_dtype: bool = False, low_copy: bool = False):
    """``act(norm(x) [+ residual])`` by :class:`GroupNormAct`: the kernels
    on the card, their plain version on the CPU (module docstring).

    ``keep_dtype``: the output keeps ``x``'s type (a site whose consumers
    all cast to it first); otherwise it is at least float32.
    ``low_copy``: return ``(y, y_low)``, ``y_low`` being ``y`` rounded to
    bf16 where a float32 ``y`` is made from a bf16 ``x`` (for the
    convolutions that read ``y``, which would cast it so), else None.
    ``counts`` gains one ``"fused"`` (the kernels) or ``"plain"``."""
    out_dtype = x.dtype if keep_dtype else torch.promote_types(x.dtype, torch.float32)
    counts["fused" if x.is_cuda else "plain"] += 1
    keep_mask = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, norm.weight, norm.bias, residual))
    low = low_copy and x.dtype == torch.bfloat16 and out_dtype == torch.float32
    out = GroupNormAct.apply(x, norm.weight, norm.bias, residual, norm.num_groups, norm.eps,
                             relu, out_dtype, keep_mask, low)
    if low_copy:
        return out if low else (out, None)
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_fwd(x, weight, bias, residual, groups, eps, relu, out_dtype, keep_mask, low_copy):
    n, c, h, w = x.shape
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    y_low = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) if low_copy else None
    mask = (torch.empty(x.shape, dtype=torch.uint8, device=x.device)
            if keep_mask and residual is not None and relu else None)
    mean, rstd = torch.empty((2, n, groups), dtype=torch.float32, device=x.device)
    partials = torch.empty((n * groups * _splits(c // groups * h * w), 2), dtype=torch.float64,
                           device=x.device)
    with _on_device(x.device):
        err = _library().group_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(residual), y.data_ptr(),
            _ptr(y_low), _ptr(mask), mean.data_ptr(), rstd.data_ptr(), partials.data_ptr(), n, c,
            h * w, groups, eps, int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            int(relu), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"group_norm_fwd launch failed: CUDA error {err}")
    launch_counts["group_norm_fwd"] += 1
    return y, y_low, mean, rstd, mask


def _launch_bwd(dy, dy_low, x, mask, mean, rstd, weight, bias, groups, relu, residual):
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    dr = torch.empty(x.shape, dtype=torch.float32, device=x.device) if residual else None
    dgamma, dbeta = torch.empty((2, c), dtype=torch.float32, device=x.device)
    partials = torch.empty((n * c * _splits(h * w), 2), dtype=torch.float64, device=x.device)
    with _on_device(x.device):
        err = _library().group_norm_bwd(
            dy.data_ptr(), _ptr(dy_low), x.data_ptr(), _ptr(mask), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), _ptr(dr), dgamma.data_ptr(),
            dbeta.data_ptr(), partials.data_ptr(), n, c, h * w, groups,
            int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16), int(residual),
            int(relu), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"group_norm_bwd launch failed: CUDA error {err}")
    launch_counts["group_norm_bwd"] += 1
    return dx, dgamma, dbeta, dr


def _nchw(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, NCHW-contiguous and 16-byte aligned (the kernels
    read it in 16-byte vectors); itself where it already is."""
    if t.dtype != dtype:
        t = t.to(dtype)
    if t.is_contiguous() and (not t.is_cuda or _aligned(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _stats_and_xhat(x, mean, rstd, groups):
    """xhat in the statistics' type (float32, or float64 for float64 x)."""
    n = x.shape[0]
    t = (x.reshape(n, groups, -1).to(mean.dtype) - mean[..., None]) * rstd[..., None]
    return t.reshape(x.shape)


def _affine(t, weight, bias):
    return t * weight.to(t.dtype)[:, None, None] + bias.to(t.dtype)[:, None, None]


def group_norm_act_fwd_plain(x, weight, bias, residual, groups, eps, relu, out_dtype,
                             keep_mask, low_copy=False):
    """The forward kernels' arithmetic: ``(y, y_low, mean, rstd, mask)``, with
    ``y_low`` ``y`` rounded to bf16 (``low_copy``) or None.  The
    statistics are summed in float64 and kept in float32 (float64 for a
    float64 ``x``); the mask is kept only where a residual and a ReLU meet."""
    n = x.shape[0]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xs = x.reshape(n, groups, -1).to(torch.float64)
    mean64 = xs.mean(-1)
    var = (xs * xs).mean(-1) - mean64 * mean64
    mean = mean64.to(acc)
    rstd = (1.0 / torch.sqrt(var.clamp_min(0.0) + eps)).to(acc)
    z = _affine(_stats_and_xhat(x, mean, rstd, groups), weight, bias)
    if residual is not None:
        z = z + residual.to(acc)
    mask = None
    if relu:
        if keep_mask and residual is not None:
            mask = z > 0
        z = torch.where(z <= 0, torch.zeros_like(z), z)
    y = z.to(out_dtype)
    return y, y.to(torch.bfloat16) if low_copy else None, mean, rstd, mask


def group_norm_act_bwd_plain(dy, dy_low, x, mask, mean, rstd, weight, bias, groups, relu,
                             residual):
    """The backward kernels' arithmetic: ``(dx, dgamma, dbeta, dr)``, the
    gradient of ``y`` being ``dy`` plus ``dy_low`` (the bf16 copy's; or None).  Pass
    one sums, per (sample, channel), the masked gradient g and g * xhat (in
    float64); pass two forms each group's means of g gamma and of
    g gamma xhat from them, and dx = rstd (g gamma - mean(g gamma) -
    xhat mean(g gamma xhat)).  Without a residual the ReLU's mask is
    recomputed from x and the statistics."""
    n, c = x.shape[:2]
    t = _stats_and_xhat(x, mean, rstd, groups)
    g = dy.to(t.dtype)
    if dy_low is not None:
        g = g + dy_low.to(t.dtype)
    if relu:
        passed = mask if mask is not None else _affine(t, weight, bias) > 0
        g = torch.where(passed, g, torch.zeros_like(g))
    s1 = g.to(torch.float64).sum((2, 3))
    s2 = (g * t).to(torch.float64).sum((2, 3))
    w64 = weight.to(torch.float64)
    length = x[0].numel() // groups
    c1 = ((s1 * w64).reshape(n, groups, -1).sum(-1) / length).to(t.dtype)
    c2 = ((s2 * w64).reshape(n, groups, -1).sum(-1) / length).to(t.dtype)
    per_channel = lambda v: v.repeat_interleave(c // groups, 1)[..., None, None]  # noqa: E731
    w = weight.to(t.dtype)[:, None, None]
    dx = per_channel(rstd) * (g * w - per_channel(c1) - t * per_channel(c2))
    dr = g.to(torch.promote_types(x.dtype, torch.float32)) if residual else None
    return dx.to(x.dtype), s2.sum(0).to(weight.dtype), s1.sum(0).to(bias.dtype), dr


class GroupNormAct(torch.autograd.Function):
    """``act(group_norm(x) [+ residual])`` with its own backward: the
    kernels on CUDA tensors, their plain version on CPU tensors.  ``x`` is
    (N, C, H, W); ``out_dtype`` is ``y``'s type (the residual is float32);
    ``keep_mask``: keep what a backward needs (False under ``no_grad``);
    ``low_copy``: return ``(y, y_low)``, ``y_low`` being ``y`` rounded to
    bf16 (the kernels make it from a bf16 ``x`` into a float32 ``y`` only)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, groups, eps, relu, out_dtype, keep_mask,
                low_copy=False):
        args = (x, weight, bias, residual, groups, eps, relu, out_dtype, keep_mask, low_copy)
        if x.is_cuda:
            why = kernel_refusals(x, weight, bias, residual, out_dtype)
            if why:
                raise ValueError("GroupNormAct's kernels do not take these operands: "
                                 + "; ".join(why))
            y, y_low, mean, rstd, mask = _launch_fwd(*args)
        elif x.device.type == "cpu":
            y, y_low, mean, rstd, mask = group_norm_act_fwd_plain(*args)
        else:
            raise ValueError(f"GroupNormAct takes CUDA or CPU tensors; got {x.device}")
        ctx.save_for_backward(x, weight, bias, mean, rstd, mask)
        ctx.groups, ctx.relu, ctx.residual = groups, relu, residual is not None
        ctx.out_dtype = out_dtype
        ctx.set_materialize_grads(False)
        return (y, y_low) if low_copy else y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dy_low=None):
        x, weight, bias, mean, rstd, mask = ctx.saved_tensors
        if dy is None:  # only the bf16 copy was read
            dy, dy_low = dy_low, None
        if dy is None:
            return (None,) * 10
        # a gradient may arrive in any layout (a skip's is channels-last) or
        # as an offset view
        dy = _nchw(dy, ctx.out_dtype)
        if dy_low is not None:
            dy_low = _nchw(dy_low, torch.bfloat16)
        args = (dy, dy_low, x, mask, mean, rstd, weight, bias, ctx.groups, ctx.relu,
                ctx.residual)
        if x.is_cuda:
            dx, dgamma, dbeta, dr = _launch_bwd(*args)
        else:
            dx, dgamma, dbeta, dr = group_norm_act_bwd_plain(*args)
        return dx, dgamma, dbeta, dr, None, None, None, None, None, None
