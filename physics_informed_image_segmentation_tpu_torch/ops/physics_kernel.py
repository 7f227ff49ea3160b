"""Fused physics-loss sums: the hand-written CUDA kernel and its plain version.

Counterpart of ``physics_informed_image_segmentation_tpu/ops/pallas_physics.py``
(``fused_physics_sums`` and ``fused_loss_components``).  One kernel
computes, per image, every reduction the Stage II objective needs —
Dice sums, BCE sum, reaction-diffusion residual energy and phase-field
energy — and a backward kernel applies the adjoints of the
reflect-padded stencils (``csrc/physics_sums.cu`` explains the folds).

Dispatch is by the device of the tensors, with no fallback:

* CUDA tensors go to the kernel (``FusedPhysicsSums``), which is built
  on first use; a kernel that fails to build or launch raises;
* CPU tensors go to :func:`fused_physics_sums_reference`, the plain
  PyTorch version written with :mod:`.pde`'s stencils and autograd.

``launch_counts`` counts the wrapper's kernel launches (one per forward
call, one per backward call), so a run can show that it went through
the kernel; :func:`reset_launch_counts` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import pde
from .losses import bce_elementwise

__all__ = [
    "FusedPhysicsSums",
    "fused_physics_sums",
    "fused_physics_sums_reference",
    "fused_loss_components",
    "launch_counts",
    "reset_launch_counts",
]

launch_counts = {"physics_sums_fwd": 0, "physics_sums_bwd": 0}

# pixels a forward block reduces: rows_per_tile = max(1, _TILE_PIXELS // W)
_TILE_PIXELS = 2048
_MAX_GRID_Y = 65535


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("physics_sums")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.physics_sums_fwd.argtypes = [p, p, p, p, p, i, i, i, i, d, d, d, i, p]
    lib.physics_sums_fwd.restype = i
    lib.physics_sums_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, d, d, d, i, p]
    lib.physics_sums_bwd.restype = i
    return lib


def _check_inputs(u: torch.Tensor, t: torch.Tensor, m: torch.Tensor) -> None:
    if u.dim() != 3 or t.shape != u.shape:
        raise ValueError(f"u and t must both be (B, H, W); got {tuple(u.shape)}, {tuple(t.shape)}")
    b, h, w = u.shape
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H, W >= 2; got {h}x{w}")
    if m.shape != (b, 1):
        raise ValueError(f"m must be (B, 1) = ({b}, 1); got {tuple(m.shape)}")
    for name, x in (("u", u), ("t", t), ("m", m)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(u, t, m, D, a, eps, use_reaction) -> torch.Tensor:
    b, h, w = u.shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the forward grid's limit of {_MAX_GRID_Y}")
    rows = max(1, _TILE_PIXELS // w)
    n_tiles = -(-h // rows)
    partials = torch.empty((b, n_tiles, 6), dtype=torch.float32, device=u.device)
    sums = torch.empty((b, 6), dtype=torch.float32, device=u.device)
    # the runtime launches on the current device, which must own the stream
    with torch.cuda.device(u.device):
        err = _library().physics_sums_fwd(
            u.data_ptr(), t.data_ptr(), m.data_ptr(), partials.data_ptr(), sums.data_ptr(),
            b, h, w, rows, float(D), float(a), float(eps), int(bool(use_reaction)),
            _stream(u.device),
        )
    if err != 0:
        raise RuntimeError(f"physics_sums_fwd launch failed: CUDA error {err}")
    launch_counts["physics_sums_fwd"] += 1
    return sums


def _launch_bwd(u, t, m, cot, D, a, eps, use_reaction, need_dt):
    b, h, w = u.shape
    scratch = torch.empty((3, b, h, w), dtype=torch.float32, device=u.device)
    du = torch.empty_like(u)
    dt = torch.empty_like(t) if need_dt else None
    with torch.cuda.device(u.device):
        err = _library().physics_sums_bwd(
            u.data_ptr(), t.data_ptr(), m.data_ptr(), cot.data_ptr(), scratch.data_ptr(),
            du.data_ptr(), None if dt is None else dt.data_ptr(),
            b, h, w, float(D), float(a), float(eps), int(bool(use_reaction)),
            _stream(u.device),
        )
    if err != 0:
        raise RuntimeError(f"physics_sums_bwd launch failed: CUDA error {err}")
    launch_counts["physics_sums_bwd"] += 1
    return du, dt


class FusedPhysicsSums(torch.autograd.Function):
    """``(B, 6)`` physics sums on CUDA tensors, forward and backward by kernel."""

    @staticmethod
    def forward(ctx, u, t, m, D, a, eps, use_reaction):
        if not u.is_cuda:
            raise ValueError("FusedPhysicsSums takes CUDA tensors")
        _check_inputs(u, t, m)
        ctx.save_for_backward(u, t, m)
        ctx.consts = (D, a, eps, use_reaction)
        return _launch_fwd(u, t, m, D, a, eps, use_reaction)

    @staticmethod
    def backward(ctx, cot):
        u, t, m = ctx.saved_tensors
        cot = cot.to(torch.float32).contiguous()
        du, dt = _launch_bwd(u, t, m, cot, *ctx.consts, need_dt=ctx.needs_input_grad[1])
        return (du if ctx.needs_input_grad[0] else None), dt, None, None, None, None, None


def fused_physics_sums_reference(u, t, m, D, a, eps, use_reaction=True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ``(B, 6)`` sums,
    differentiated by autograd."""
    mm = m.reshape(-1, 1, 1)
    u = u * mm
    t = t * mm
    dims = (1, 2)
    inter = torch.sum(u * t, dims)
    su = torch.sum(u, dims)
    st = torch.sum(t, dims)
    bce = torch.sum(bce_elementwise(u, t), dims)
    r = D * pde.laplacian(u)
    if use_reaction:
        r = r + pde.reaction_term(u, a)
    rd = torch.sum(r * r, dims)
    gx, gy = pde.grad_xy(u)
    one_minus = 1.0 - u
    pf = torch.sum(
        (eps / 2.0) * (gx * gx + gy * gy) + (1.0 / eps) * (u * u) * (one_minus * one_minus),
        dims,
    )
    return torch.stack([inter, su, st, bce, rd, pf], dim=1)


def fused_physics_sums(u, t, m, D, a, eps, use_reaction=True) -> torch.Tensor:
    """Per-image sums ``[Σu·t, Σu, Σt, Σbce, Σr², Σphase-field]``, (B, 6),
    all masked by ``m``.  u, t: (B, H, W) float32; m: (B, 1).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if u.is_cuda:
        return FusedPhysicsSums.apply(u, t, m, D, a, eps, use_reaction)
    if u.device.type != "cpu":
        raise ValueError(f"fused_physics_sums takes CUDA or CPU tensors; got {u.device}")
    _check_inputs(u, t, m)
    return fused_physics_sums_reference(u, t, m, D, a, eps, use_reaction)


def fused_loss_components(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    diffusion_coeff: float = 1.0,
    reaction_threshold: float = 0.5,
    epsilon: float = 0.05,
    use_reaction_term: bool = True,
    smooth: float = 1e-6,
    mask: Optional[torch.Tensor] = None,
    need_pde: bool = True,
    need_phase_field: bool = True,
    reduce=None,
    plain: bool = False,
) -> dict:
    """Loss components from the fused sums; the same contract as the plain
    component computation of :func:`..train.objective.make_loss_and_components`.

    Accepts (B, H, W) or (B, H, W, 1) predictions/targets; ``mask`` is a
    per-sample validity mask broadcastable to the prediction.

    ``reduce``: for a batch sharded over ranks, a differentiable sum over
    the ranks (:func:`..parallel.mesh.all_sum`), applied to the six totals
    and the valid-pixel count before the ratios are formed, so every rank
    gets the loss of the global batch.  ``plain`` takes the plain version
    on any device.
    """
    if pred.dim() == 4:
        pred = pred[..., 0]
        target = target[..., 0]
    b, h, w = pred.shape
    if mask is None:
        m = torch.ones((b, 1), dtype=torch.float32, device=pred.device)
    else:
        m = mask.to(torch.float32).reshape(b, -1)[:, :1].contiguous()

    u, t = pred.to(torch.float32).contiguous(), target.to(torch.float32).contiguous()
    if plain:
        _check_inputs(u, t, m)
        sums = fused_physics_sums_reference(u, t, m, diffusion_coeff, reaction_threshold,
                                            epsilon, use_reaction_term)
    else:
        sums = fused_physics_sums(u, t, m, diffusion_coeff, reaction_threshold, epsilon,
                                  use_reaction_term)
    if reduce is None:
        inter, su, st = torch.sum(sums[:, 0]), torch.sum(sums[:, 1]), torch.sum(sums[:, 2])
        bce, rd, pf = torch.sum(sums[:, 3]), torch.sum(sums[:, 4]), torch.sum(sums[:, 5])
        n_valid = torch.sum(m) * (h * w)
    else:
        totals = reduce(torch.cat([sums.sum(0), (torch.sum(m) * (h * w)).reshape(1)]))
        inter, su, st, bce, rd, pf, n_valid = totals.unbind()
    dice = (2.0 * inter + smooth) / (su + st + smooth)
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    return {
        "dice_loss": 1.0 - dice,
        "bce_loss": bce / n_valid,
        "pde_loss": rd / n_valid if need_pde else zero,
        "phase_field_loss": pf / n_valid if need_phase_field else zero,
    }
