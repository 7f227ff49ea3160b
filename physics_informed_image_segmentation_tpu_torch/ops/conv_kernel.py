"""3x3 SAME convolution, NHWC: the hand-written CUDA kernels and their plain version.

Counterpart of ``physics_informed_image_segmentation_tpu/ops/pallas_conv.py``
(``conv3x3_same``): a 3x3, stride-1, zero-padded convolution computed as the
sum over the nine taps of ``shift(x) @ W[t]``, with float32 accumulation
and the result in ``x``'s type, forward and backward.  The U-Net does not
call it (its convolutions are cuDNN's); :mod:`..utils.conv_probe` times it
against ``F.conv2d``.

``paired`` selects the order in which the tap products are summed (the
centre tap, then the pairs (0,8), (1,7), (2,6), (3,5), each pair's
``2*Cin`` products summed together first) instead of the taps in row-major
order.  On the TPU that variant deepens the contraction; here it is only
another order of float32 summation (``csrc/conv3x3.cu`` says more).

Dispatch is by the device of the tensors, with no fallback:

* CUDA tensors go to the kernels (:class:`Conv3x3Same`), built on first
  use: the forward kernel computes the output and, in the backward, the
  input gradient (the cotangent convolved with the taps reversed and
  in/out transposed); the dW kernels compute the weight gradient.  A kernel
  that fails to build or launch raises;
* CPU tensors go to :func:`conv3x3_same_reference`, plain PyTorch
  differentiated by autograd.

The kernels take float32 or bfloat16, contiguous tensors, any H and W, any
Cout, and any Cin up to what the forward's shared memory holds (the
wrapper raises beyond).  bfloat16 tensors whose Cin is a multiple of 16
run on the tensor cores (Cin <= 432 in row-major order, <= 336 paired);
float32, and bfloat16 with another Cin, multiply on the CUDA cores
(Cin <= 237, <= 188 paired).  The public function keeps the JAX package's
contract and raises for a W that is not a power of two.

``launch_counts`` counts kernel launches: ``conv3x3_fwd`` and
``conv3x3_fwd_paired`` once per forward-kernel launch (outputs and input
gradients alike), ``conv3x3_dw`` once per weight gradient;
:func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = [
    "Conv3x3Same",
    "conv3x3_same",
    "conv3x3_same_reference",
    "launch_counts",
    "reset_launch_counts",
]

launch_counts = {"conv3x3_fwd": 0, "conv3x3_fwd_paired": 0, "conv3x3_dw": 0}

# Tap pairs of the paired order; tap 4 is the centre (taps in row-major order).
_PAIRS = ((0, 8), (1, 7), (2, 6), (3, 5))
_CENTER = 4
# shared memory a block can use on sm_90
_MAX_SHARED_BYTES = 232448


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_fwd_shared_bytes.argtypes = [p, i, i, i]
    lib.conv3x3_fwd_shared_bytes.restype = i
    lib.conv3x3_dw_blocks.argtypes = [p, p, i, i, i, i, i]
    lib.conv3x3_dw_blocks.restype = i
    lib.conv3x3_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.conv3x3_fwd.restype = i
    lib.conv3x3_dw_partials.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.conv3x3_dw_partials.restype = i
    lib.conv3x3_dw_finish.argtypes = [p, p, i, i, i, p]
    lib.conv3x3_dw_finish.restype = i
    return lib


def _check_pair(x: torch.Tensor, other: torch.Tensor, x_name: str, other_name: str) -> None:
    """What the kernels take: two contiguous tensors of one floating type
    (float32 or bfloat16) on one device, ``x`` of shape (B, H, W, C)."""
    if x.dim() != 4:
        raise ValueError(f"{x_name} must be (B, H, W, C); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{x_name} must be float32 or bfloat16; got {x.dtype}")
    if other.dtype != x.dtype:
        raise TypeError(f"{other_name} is {other.dtype} but {x_name} is {x.dtype}")
    if other.device != x.device:
        raise ValueError(f"{other_name} is on {other.device} but {x_name} is on {x.device}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{x_name} and {other_name} must be contiguous")
    if min(x.shape) < 1:
        raise ValueError(f"{x_name} must not be empty; got {tuple(x.shape)}")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"{x_name} has 2^31 pixels or more: {tuple(x.shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(x: torch.Tensor, w9: torch.Tensor, paired: bool) -> torch.Tensor:
    """``x`` (B, H, W, Cin) and ``w9`` (9, Cin, Cout) of one type → (B, H, W, Cout)."""
    _check_pair(x, w9, "x", "w9")
    b, h, w, cin = x.shape
    if w9.shape[:2] != (9, cin):
        raise ValueError(f"w9 must be (9, {cin}, Cout); got {tuple(w9.shape)}")
    cout = w9.shape[2]
    lib = _library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    shared = lib.conv3x3_fwd_shared_bytes(x.data_ptr(), cin, int(paired), is_bf16)
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"Cin = {cin} needs {shared} bytes of shared memory in the forward kernel, "
            f"more than the {_MAX_SHARED_BYTES} a block can use"
        )
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    # the runtime launches on the current device, which must own the stream
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd(
            x.data_ptr(), w9.data_ptr(), out.data_ptr(), b, h, w, cin, cout, int(paired),
            is_bf16, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_fwd launch failed: CUDA error {err}")
    launch_counts["conv3x3_fwd_paired" if paired else "conv3x3_fwd"] += 1
    return out


def _launch_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x`` (B, H, W, Cin) and ``g`` (B, H, W, Cout) of one type → (9, Cin, Cout) float32."""
    _check_pair(x, g, "x", "g")
    if g.shape[:3] != x.shape[:3]:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} differ in (B, H, W)")
    b, h, w, cin = x.shape
    cout = g.shape[3]
    lib = _library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    # blocks that walk the pixel tiles, each writing one (9, Cin, Cout)
    # float32 partial (147,456 bytes at 64 -> 64); the library bounds them
    n_blocks = lib.conv3x3_dw_blocks(x.data_ptr(), g.data_ptr(), b, h, w, cin, is_bf16)
    partials = torch.empty((n_blocks, 9, cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((9, cin, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        err = lib.conv3x3_dw_partials(
            x.data_ptr(), g.data_ptr(), partials.data_ptr(), b, h, w, cin, cout, n_blocks,
            is_bf16, stream,
        )
        if err == 0:
            err = lib.conv3x3_dw_finish(partials.data_ptr(), dw.data_ptr(), n_blocks, cin, cout,
                                        stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_dw launch failed: CUDA error {err}")
    launch_counts["conv3x3_dw"] += 1
    return dw


class Conv3x3Same(torch.autograd.Function):
    """``conv(x, w)`` on CUDA, forward and backward by kernel.  ``x`` is
    (B, H, W, Cin), ``w`` (3, 3, Cin, Cout); ``w`` is cast to ``x``'s type."""

    @staticmethod
    def forward(ctx, x, w, paired):
        if not (x.is_cuda and w.is_cuda):
            raise ValueError("Conv3x3Same takes CUDA tensors")
        if w.dim() != 4 or w.shape[:2] != (3, 3):
            raise ValueError(f"w must be (3, 3, Cin, Cout); got {tuple(w.shape)}")
        x = x.contiguous()
        w9 = w.reshape(9, w.shape[2], w.shape[3]).to(x.dtype).contiguous()
        ctx.save_for_backward(x, w9)
        ctx.paired = paired
        ctx.w_meta = (w.shape, w.dtype)
        return _launch_fwd(x, w9, paired)

    @staticmethod
    def backward(ctx, g):
        x, w9 = ctx.saved_tensors
        w_shape, w_dtype = ctx.w_meta
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # a SAME conv of g with the taps reversed and in/out transposed
            dx = _launch_fwd(g, w9.flip(0).transpose(1, 2).contiguous(), ctx.paired)
        if ctx.needs_input_grad[1]:
            dw = _launch_dw(x, g).reshape(w_shape).to(w_dtype)
        return dx, dw, None


def conv3x3_same_reference(x: torch.Tensor, w: torch.Tensor, paired: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernels: nine shifted slices of the
    zero-padded ``x``, each contracted with ``W[t]`` in float32 and summed
    in the variant's tap order, rounded once to ``x``'s type.  Autograd
    differentiates it."""
    b, h, wd, cin = x.shape
    w9 = w.reshape(9, cin, w.shape[3]).to(x.dtype).to(torch.float32)
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))

    def shifted(t: int) -> torch.Tensor:
        dy, dx = divmod(t, 3)
        return xp[:, dy:dy + h, dx:dx + wd, :]

    if paired:
        acc = shifted(_CENTER) @ w9[_CENTER]
        for t, u in _PAIRS:
            acc = acc + torch.cat([shifted(t), shifted(u)], dim=-1) @ torch.cat([w9[t], w9[u]])
    else:
        acc = shifted(0) @ w9[0]
        for t in range(1, 9):
            acc = acc + shifted(t) @ w9[t]
    return acc.to(x.dtype)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, paired: bool = False) -> torch.Tensor:
    """3x3 stride-1 SAME convolution, NHWC.

    Args:
      x: (B, H, W, C_in), float32 or bfloat16; W must be a power of two
        (the JAX package's contract; the CUDA kernel itself takes any W).
      w: (3, 3, C_in, C_out) (HWIO); cast to ``x``'s type.
      paired: sum the taps in the paired order.

    CUDA tensors launch the kernels; CPU tensors take the plain version.
    """
    width = x.shape[2]
    if width < 1 or width & (width - 1):
        raise ValueError(f"conv3x3_same requires power-of-two W, got {width}")
    if x.is_cuda:
        return Conv3x3Same.apply(x, w, paired)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_same takes CUDA or CPU tensors; got {x.device}")
    return conv3x3_same_reference(x, w, paired)
