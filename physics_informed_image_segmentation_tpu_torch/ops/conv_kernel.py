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
wrapper raises beyond).  The library picks one of three kernel sets by what
the operands are (:func:`kernel_set` says which), and nothing lets a call
fall from one set to another:

* ``"wgmma"``: bfloat16, 16-byte aligned, Cout a multiple of 64 and Cin 64
  or 128 (forward and dx) or a multiple of 64 (dW).  Persistent blocks,
  TMA loads into a ring of tiles, ``wgmma``; the forward keeps the nine
  taps' weights in shared memory, dW the nine taps' sums in registers; dx
  reads the weights transposed in the kernel;
* ``"wmma"``: the other bfloat16 operands whose Cin is a multiple of 16
  (Cin <= 432 in row-major order, <= 336 paired);
* ``"cuda-cores"``: float32, and bfloat16 with another Cin (Cin <= 237,
  <= 188 paired).

The public function keeps the JAX package's contract and raises for a W
that is not a power of two.

``launch_counts`` counts kernel launches: ``conv3x3_fwd`` and
``conv3x3_fwd_paired`` once per forward-kernel launch (outputs and input
gradients alike), ``conv3x3_dw`` once per weight gradient;
:func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = [
    "Conv3x3Same",
    "conv3x3_same",
    "conv3x3_same_reference",
    "kernel_set",
    "launch_counts",
    "reset_launch_counts",
]

launch_counts = {"conv3x3_fwd": 0, "conv3x3_fwd_paired": 0, "conv3x3_dw": 0}

# Tap pairs of the paired order; tap 4 is the centre (taps in row-major order).
_PAIRS = ((0, 8), (1, 7), (2, 6), (3, 5))
_CENTER = 4
# shared memory a block can use on sm_90
_MAX_SHARED_BYTES = 232448
# the library's numbers for its kernel sets
_KERNEL_SETS = ("cuda-cores", "wmma", "wgmma")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_fwd_kernel_set.argtypes = [i, i, i, i]
    lib.conv3x3_fwd_kernel_set.restype = i
    lib.conv3x3_dw_kernel_set.argtypes = [i, i, i, i]
    lib.conv3x3_dw_kernel_set.restype = i
    lib.conv3x3_fwd_shared_bytes.argtypes = [i, i, i, i, i]
    lib.conv3x3_fwd_shared_bytes.restype = i
    lib.conv3x3_dw_blocks.argtypes = [i, i, i, i, i, i, i]
    lib.conv3x3_dw_blocks.restype = i
    lib.conv3x3_fwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.conv3x3_fwd.restype = i
    lib.conv3x3_dw.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.conv3x3_dw.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_shared_bytes(cin: int, cout: int, paired: bool, is_bf16: int, aligned: int) -> int:
    """The forward's shared memory in the set that will run.  The answer
    depends on these arguments only, so the library is asked once for each
    and not once a call."""
    return _library().conv3x3_fwd_shared_bytes(cin, cout, int(paired), is_bf16, aligned)


@functools.lru_cache(maxsize=None)
def _dw_blocks(b: int, h: int, w: int, cin: int, cout: int, is_bf16: int, aligned: int,
               device_index: int) -> int:
    """Partials that dW writes for these operands on this device (the wgmma
    set has one block an SM); asked once for each, as above."""
    with torch.cuda.device(device_index):
        return _library().conv3x3_dw_blocks(b, h, w, cin, cout, is_bf16, aligned)


def _aligned(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


@functools.lru_cache(maxsize=None)
def _fwd_kernel_set(cin: int, cout: int, is_bf16: int, aligned: int) -> str:
    return _KERNEL_SETS[_library().conv3x3_fwd_kernel_set(cin, cout, is_bf16, aligned)]


def kernel_set(x: torch.Tensor, other: torch.Tensor, dw: bool = False) -> str:
    """The kernel set that CUDA operands take: ``"wgmma"``, ``"wmma"`` or
    ``"cuda-cores"``.  The forward's operands are ``x`` (B, H, W, Cin) and
    ``w9`` (9, Cin, Cout); dW's (``dw=True``) are ``x`` and ``g``
    (B, H, W, Cout)."""
    key = (x.shape[3], other.shape[-1], int(x.dtype == torch.bfloat16), _aligned(x, other))
    if dw:
        return _KERNEL_SETS[_library().conv3x3_dw_kernel_set(*key)]
    return _fwd_kernel_set(*key)


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


def _on_device(device: torch.device):
    """The runtime launches on the current device, which must own the
    stream: a context that makes ``device`` current unless it is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch_fwd(x: torch.Tensor, w9: torch.Tensor, paired: bool,
                transposed: bool = False) -> torch.Tensor:
    """``x`` (B, H, W, Cin) and ``w9`` (9, Cin, Cout) of one type → (B, H, W, Cout).

    ``transposed`` (the wgmma set only, see :func:`_launch_dx`): ``w9`` is
    (9, Cout, Cin) and tap t multiplies by the transpose of ``w9[8 - t]``."""
    _check_pair(x, w9, "x", "w9")
    b, h, w, cin = x.shape
    cin_axis, cout_axis = (2, 1) if transposed else (1, 2)
    if w9.dim() != 3 or w9.shape[0] != 9 or w9.shape[cin_axis] != cin:
        want = f"(9, Cout, {cin})" if transposed else f"(9, {cin}, Cout)"
        raise ValueError(f"w9 must be {want}; got {tuple(w9.shape)}")
    cout = w9.shape[cout_axis]
    is_bf16 = int(x.dtype == torch.bfloat16)
    # torch.empty's memory is 16-byte aligned
    shared = _fwd_shared_bytes(cin, cout, paired, is_bf16, _aligned(x, w9))
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"Cin = {cin} needs {shared} bytes of shared memory in the forward kernel, "
            f"more than the {_MAX_SHARED_BYTES} a block can use"
        )
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    with _on_device(x.device):
        err = _library().conv3x3_fwd(
            x.data_ptr(), w9.data_ptr(), out.data_ptr(), b, h, w, cin, cout, int(paired),
            int(transposed), is_bf16, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_fwd launch failed: CUDA error {err}")
    launch_counts["conv3x3_fwd_paired" if paired else "conv3x3_fwd"] += 1
    return out


def _launch_dx(g: torch.Tensor, w9: torch.Tensor, paired: bool) -> torch.Tensor:
    """The input gradient from ``g`` (B, H, W, Cout) and the convolution's own
    ``w9`` (9, Cin, Cout) → (B, H, W, Cin): a SAME convolution of ``g`` with
    the taps reversed and in/out transposed, by the forward kernel.  The
    wgmma kernel reads ``w9`` that way itself; for the other sets the
    weights are laid out so first (two small PyTorch kernels)."""
    is_bf16 = int(g.dtype == torch.bfloat16)
    if _fwd_kernel_set(w9.shape[2], w9.shape[1], is_bf16, _aligned(g, w9)) == "wgmma":
        return _launch_fwd(g, w9, paired, transposed=True)
    return _launch_fwd(g, w9.flip(0).transpose(1, 2).contiguous(), paired)


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
    n_blocks = _dw_blocks(b, h, w, cin, cout, is_bf16, _aligned(x, g), x.device.index)
    partials = torch.empty((n_blocks, 9, cin, cout), dtype=torch.float32, device=x.device)
    dw = torch.empty((9, cin, cout), dtype=torch.float32, device=x.device)
    with _on_device(x.device):
        err = lib.conv3x3_dw(
            x.data_ptr(), g.data_ptr(), partials.data_ptr(), dw.data_ptr(), b, h, w, cin, cout,
            n_blocks, is_bf16, _stream(x.device),
        )
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
            dx = _launch_dx(g, w9, ctx.paired)
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
