"""Physics sums over halo-padded blocks: the hand-written CUDA kernel and its
plain version.

Counterpart of ``physics_informed_image_segmentation_tpu/ops/pallas_physics.py``
(``padded_physics_sums``).  A space-sharded field reaches this op as one
block per rank whose one-pixel ghost ring the halo exchange has filled
(:func:`..parallel.halo.halo_exchange_pad`); the op returns, per image,
``[Σr², Σphase-field]`` over the block's interior, and its backward
returns the gradient on the whole padded block, ghost ring included, for
the exchange to route back (``csrc/padded_physics.cu`` explains it).

Dispatch is by the device of the tensor, with no fallback:

* CUDA tensors go to the kernel (``PaddedPhysicsSums``), built on first
  use; a kernel that fails to build or launch raises;
* CPU tensors go to :func:`padded_physics_sums_reference`, plain PyTorch
  differentiated by autograd.

``launch_counts`` counts the wrapper's kernel launches (one per forward
call, one per backward call); :func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "PaddedPhysicsSums",
    "padded_physics_sums",
    "padded_physics_sums_reference",
    "launch_counts",
    "reset_launch_counts",
]

launch_counts = {"padded_physics_fwd": 0, "padded_physics_bwd": 0}

# interior pixels a forward block reduces: rows_per_tile = max(1, _TILE_PIXELS // w)
_TILE_PIXELS = 2048
_MAX_GRID_Y = 65535


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("padded_physics")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.padded_physics_fwd.argtypes = [p, p, p, i, i, i, i, d, d, d, i, p]
    lib.padded_physics_fwd.restype = i
    lib.padded_physics_bwd.argtypes = [p, p, p, p, i, i, i, d, d, d, i, p]
    lib.padded_physics_bwd.restype = i
    return lib


def _check_input(p: torch.Tensor) -> None:
    if p.dim() != 3:
        raise ValueError(f"p must be (B, H+2, W+2); got {tuple(p.shape)}")
    if p.shape[1] < 3 or p.shape[2] < 3:
        raise ValueError(f"a padded block needs H+2, W+2 >= 3; got {tuple(p.shape)}")
    if p.dtype != torch.float32:
        raise TypeError(f"p must be float32; got {p.dtype}")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    if p.shape[1] * p.shape[2] >= 2**31:
        raise ValueError(f"a padded block of {p.shape[1]}x{p.shape[2]} exceeds 2^31 pixels")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(p, D, a, eps, use_reaction) -> torch.Tensor:
    b, hp, wp = p.shape
    h, w = hp - 2, wp - 2
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the forward grid's limit of {_MAX_GRID_Y}")
    rows = max(1, _TILE_PIXELS // w)
    n_tiles = -(-h // rows)
    partials = torch.empty((b, n_tiles, 2), dtype=torch.float32, device=p.device)
    sums = torch.empty((b, 2), dtype=torch.float32, device=p.device)
    # the runtime launches on the current device, which must own the stream
    with torch.cuda.device(p.device):
        err = _library().padded_physics_fwd(
            p.data_ptr(), partials.data_ptr(), sums.data_ptr(), b, h, w, rows,
            float(D), float(a), float(eps), int(bool(use_reaction)), _stream(p.device),
        )
    if err != 0:
        raise RuntimeError(f"padded_physics_fwd launch failed: CUDA error {err}")
    launch_counts["padded_physics_fwd"] += 1
    return sums


def _launch_bwd(p, cot, D, a, eps, use_reaction) -> torch.Tensor:
    b, hp, wp = p.shape
    h, w = hp - 2, wp - 2
    scratch = torch.empty((3, b, h, w), dtype=torch.float32, device=p.device)
    dp = torch.empty_like(p)
    with torch.cuda.device(p.device):
        err = _library().padded_physics_bwd(
            p.data_ptr(), cot.data_ptr(), scratch.data_ptr(), dp.data_ptr(), b, h, w,
            float(D), float(a), float(eps), int(bool(use_reaction)), _stream(p.device),
        )
    if err != 0:
        raise RuntimeError(f"padded_physics_bwd launch failed: CUDA error {err}")
    launch_counts["padded_physics_bwd"] += 1
    return dp


class PaddedPhysicsSums(torch.autograd.Function):
    """``(B, 2)`` sums of a padded block on CUDA, forward and backward by kernel."""

    @staticmethod
    def forward(ctx, p, D, a, eps, use_reaction):
        if not p.is_cuda:
            raise ValueError("PaddedPhysicsSums takes CUDA tensors")
        _check_input(p)
        ctx.save_for_backward(p)
        ctx.consts = (D, a, eps, use_reaction)
        return _launch_fwd(p, D, a, eps, use_reaction)

    @staticmethod
    def backward(ctx, cot):
        (p,) = ctx.saved_tensors
        dp = _launch_bwd(p, cot.to(torch.float32).contiguous(), *ctx.consts)
        return dp, None, None, None, None


def padded_physics_sums_reference(p, D, a, eps, use_reaction=True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ``(B, 2)`` sums,
    differentiated by autograd (the gradient reaches the ghost ring)."""
    u = p[:, 1:-1, 1:-1]
    up, down = p[:, :-2, 1:-1], p[:, 2:, 1:-1]
    left, right = p[:, 1:-1, :-2], p[:, 1:-1, 2:]
    r = D * (up + down + left + right - 4.0 * u)
    if use_reaction:
        r = r + u * (1.0 - u) * (u - a)
    gx = 0.5 * (right - left)
    gy = 0.5 * (down - up)
    one_minus = 1.0 - u
    pf = (eps / 2.0) * (gx * gx + gy * gy) + (1.0 / eps) * (u * u) * (one_minus * one_minus)
    return torch.stack([torch.sum(r * r, (1, 2)), torch.sum(pf, (1, 2))], dim=1)


def padded_physics_sums(p, D, a, eps, use_reaction=True) -> torch.Tensor:
    """``[Σr², Σphase-field]`` per image, (B, 2), over the interior of a
    halo-padded (B, H+2, W+2) float32 block whose ghost ring is filled.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if p.is_cuda:
        return PaddedPhysicsSums.apply(p, D, a, eps, use_reaction)
    if p.device.type != "cpu":
        raise ValueError(f"padded_physics_sums takes CUDA or CPU tensors; got {p.device}")
    _check_input(p)
    return padded_physics_sums_reference(p, D, a, eps, use_reaction)
