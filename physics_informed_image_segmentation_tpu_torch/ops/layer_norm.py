"""LayerNorm over the last dimension: the hand-written CUDA kernels and their plain version.

``y = (x - mu) * rstd * gamma + beta`` over each row of ``C`` elements,
the norms of Swin-Unet (``models/swin_unet.py``).  No TPU kernel has this
role (``csrc/layer_norm.cu`` says why it exists).

The model's norms are :class:`LayerNorm` modules: ``nn.LayerNorm`` with
its parameters, initialisation and ``state_dict`` names, whose output type
is the site's role, given when the module is built:

* ``"stream"``: the output becomes the residual stream, float32 at least
  (the patch embedding's norm, ``PatchExpand``'s);
* ``"compute"``: only a linear or a convolution reads the output, so it
  comes in the type autocast gives their input on the input's device (bf16
  under bf16 autocast), else in the input's type (a block's ``norm1`` and
  ``norm2``, ``PatchMerging``'s, the final ``norm``, ``norm_up``, the ×4
  expand's).

Either way the input is read in its own type: bf16 or float32.  Through
:class:`LayerNormFn`:

* on CUDA tensors, the kernels.  They take rows of ``C`` in
  :data:`WIDTHS` (96 · 2^k up to 1536) bf16 or float32 contiguous
  elements, 16-byte aligned, float32 ``gamma`` and ``beta``, and a bf16 or
  float32 output, and raise with :func:`kernel_refusals`' reasons on
  anything else (float64, non-contiguous rows, misalignment, another
  width): the card never falls back to PyTorch's ``layer_norm``;
* on CPU tensors, :func:`layer_norm_fwd_plain` and
  :func:`layer_norm_bwd_plain`: the kernels' arithmetic in plain PyTorch
  (float32 statistics, float64 for a float64 input), in any floating
  type, which the CPU tests hold against autograd of ``nn.LayerNorm`` and
  the model's CPU tests against the benchmark's reference.

Saved for the backward: the input in its own type, and mean and rstd per
row in float32.  The gradient of ``y`` comes in ``y``'s type and ``dx``
leaves in ``x``'s.

``launch_counts`` counts the wrapper's calls of the kernels:
``layer_norm_fwd`` a forward (one device kernel), ``layer_norm_bwd`` a
backward (two: the rows, then the parameters' gradients);
:func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from .conv_kernel import _aligned, _on_device, _stream

__all__ = [
    "LayerNorm",
    "LayerNormFn",
    "ROLES",
    "WIDTHS",
    "kernel_refusals",
    "launch_counts",
    "layer_norm_bwd_plain",
    "layer_norm_fwd_plain",
    "output_dtype",
    "reset_launch_counts",
]

launch_counts = {"layer_norm_fwd": 0, "layer_norm_bwd": 0}

WIDTHS = (96, 192, 384, 768, 1536)  # the widths csrc/layer_norm.cu is built for
ROLES = ("stream", "compute")
_KERNEL_TYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("layer_norm")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.layer_norm_bwd_blocks.argtypes = [ll, i, i, i]
    lib.layer_norm_bwd_blocks.restype = i
    lib.layer_norm_fwd.argtypes = [p] * 6 + [ll, i, f, i, i, p]
    lib.layer_norm_fwd.restype = i
    lib.layer_norm_bwd.argtypes = [p] * 9 + [ll, i, i, i, p]
    lib.layer_norm_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_blocks(rows: int, c: int, in_bf16: int, out_bf16: int) -> int:
    """Blocks the backward kernel walks the rows with (its scratch's rows)."""
    return _library().layer_norm_bwd_blocks(rows, c, in_bf16, out_bf16)


def output_dtype(x: torch.Tensor, role: str) -> torch.dtype:
    """The output type of a norm of ``role`` on ``x`` (module docstring)."""
    if role == "stream":
        return torch.promote_types(x.dtype, torch.float32)
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


def kernel_refusals(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    out_dtype: torch.dtype) -> list[str]:
    """Why the kernels would not take these operands (empty: they would).
    Each condition is checked on its own, so a CPU tensor names every
    reason besides its device."""
    why = []
    if x.device.type != "cuda":
        why.append(f"device {x.device.type}")
    if x.dtype not in _KERNEL_TYPES or out_dtype not in _KERNEL_TYPES:
        why.append(f"type {x.dtype} to {out_dtype}")
    if x.dim() == 0 or x.shape[-1] not in WIDTHS:
        why.append(f"width {x.shape[-1] if x.dim() else None} not one of {WIDTHS}")
    if not x.is_contiguous() or x.numel() == 0:
        why.append("rows not contiguous")
    elif not _aligned(x):
        why.append("not 16-byte aligned")
    if any(t.dtype != torch.float32 or t.shape != x.shape[-1:] or not t.is_contiguous()
           or not _aligned(t) for t in (weight, bias)):
        why.append("gamma and beta not 16-byte aligned float32 of the row's width")
    return why


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dim, eps)`` (its parameters, initialisation and
    ``state_dict`` names) through :class:`LayerNormFn`; ``out`` is the
    site's role, ``"stream"`` or ``"compute"``, which sets the output's
    type (module docstring)."""

    def __init__(self, dim: int, eps: float = 1e-5, *, out: str):
        if out not in ROLES:
            raise ValueError(f"out must be one of {ROLES}, not {out!r}")
        super().__init__(dim, eps=eps)
        self.out = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return LayerNormFn.apply(x, self.weight, self.bias, self.eps, output_dtype(x, self.out))

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, out={self.out}"


def _launch_fwd(x, weight, bias, eps, out_dtype):
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean, rstd = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    with _on_device(x.device):
        err = _library().layer_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), rows, c, eps, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed: CUDA error {err}")
    launch_counts["layer_norm_fwd"] += 1
    return y, mean, rstd


def _launch_bwd(dy, x, mean, rstd, weight):
    c = x.shape[-1]
    rows = x.numel() // c
    in_bf16, out_bf16 = int(x.dtype == torch.bfloat16), int(dy.dtype == torch.bfloat16)
    dx = torch.empty_like(x)
    dgamma, dbeta = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with _on_device(x.device):
        partials = torch.empty((_bwd_blocks(rows, c, in_bf16, out_bf16), 2, c),
                               dtype=torch.float32, device=x.device)
        err = _library().layer_norm_bwd(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), partials.data_ptr(), rows, c,
            in_bf16, out_bf16, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"layer_norm_bwd launch failed: CUDA error {err}")
    launch_counts["layer_norm_bwd"] += 1
    return dx, dgamma, dbeta


def _rows(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous and 16-byte aligned (the kernels read
    it in vectors); itself where it already is."""
    if t.dtype != dtype:
        t = t.to(dtype)
    if t.is_contiguous() and (not t.is_cuda or _aligned(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def layer_norm_fwd_plain(x, weight, bias, eps, out_dtype):
    """The forward kernel's arithmetic: ``(y, mean, rstd)``, the statistics
    of each of the ``x.numel() // C`` rows in float32 (float64 for a
    float64 ``x``): the mean, then the mean squared deviation from it."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xs = x.reshape(-1, x.shape[-1]).to(acc)
    mean = xs.mean(-1)
    d = xs - mean[:, None]
    rstd = torch.rsqrt((d * d).mean(-1) + eps)
    y = (d * rstd[:, None]) * weight.to(acc) + bias.to(acc)
    return y.reshape(x.shape).to(out_dtype), mean, rstd


def layer_norm_bwd_plain(dy, x, mean, rstd, weight):
    """The backward kernels' arithmetic: ``(dx, dgamma, dbeta)``, with
    ``g = dy * gamma`` and xhat per row, dx = rstd (g - mean(g) - xhat
    mean(g xhat)); dgamma and dbeta the sums of dy xhat and dy over the
    rows."""
    c = x.shape[-1]
    t = (x.reshape(-1, c).to(mean.dtype) - mean[:, None]) * rstd[:, None]
    d = dy.reshape(-1, c).to(mean.dtype)
    g = d * weight.to(mean.dtype)
    c1 = g.mean(-1, keepdim=True)
    c2 = (g * t).mean(-1, keepdim=True)
    dx = rstd[:, None] * (g - c1 - t * c2)
    return (dx.reshape(x.shape).to(x.dtype), (d * t).sum(0).to(weight.dtype),
            d.sum(0).to(weight.dtype))


class LayerNormFn(torch.autograd.Function):
    """LayerNorm of ``x``'s last dimension with its own backward: the
    kernels on CUDA tensors, their plain version on CPU tensors;
    ``out_dtype`` is ``y``'s type."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        if x.is_cuda:
            why = kernel_refusals(x, weight, bias, out_dtype)
            if why:
                raise ValueError("LayerNormFn's kernels do not take these operands: "
                                 + "; ".join(why))
            y, mean, rstd = _launch_fwd(x, weight, bias, eps, out_dtype)
        elif x.device.type == "cpu":
            y, mean, rstd = layer_norm_fwd_plain(x, weight, bias, eps, out_dtype)
        else:
            raise ValueError(f"LayerNormFn takes CUDA or CPU tensors; got {x.device}")
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.out_dtype = out_dtype
        ctx.set_materialize_grads(False)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        if dy is None:
            return None, None, None, None, None
        dy = _rows(dy, ctx.out_dtype)  # a gradient may arrive as a strided view
        if x.is_cuda:
            dx, dgamma, dbeta = _launch_bwd(dy, x, mean, rstd, weight)
        else:
            dx, dgamma, dbeta = layer_norm_bwd_plain(dy, x, mean, rstd, weight)
        return dx, dgamma, dbeta, None, None
