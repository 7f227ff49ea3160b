"""Fused physics-loss sums: the hand-written CUDA kernel and its plain versions.

Counterpart of ``physics_informed_image_segmentation_tpu/ops/pallas_physics.py``
(``fused_physics_sums`` and ``fused_loss_components``).  One kernel
computes, per image, every reduction the Stage II objective needs —
Dice sums, BCE sum, reaction-diffusion residual energy and phase-field
energy — and a backward kernel applies the adjoints of the
reflect-padded stencils (``csrc/physics_sums.cu`` explains the folds).
Each is one launch over tiles of ``tile_h`` x 64 pixels
(:func:`tile_plan`); the forward's last block adds the tiles' partial
sums in a fixed order, the backward computes its fields in shared memory
and needs no scratch.

Dispatch is by the device of the tensors, with no fallback:

* CUDA tensors go to the kernel (``FusedPhysicsSums``), which is built
  on first use; a kernel that fails to build or launch raises;
* CPU tensors go to :func:`fused_physics_sums_reference`, the plain
  PyTorch version written with :mod:`.pde`'s stencils and autograd.

:func:`fused_physics_sums_bwd_tiled` is a second plain version, of the
backward alone: plain PyTorch that follows the kernel tile by tile (the
same tile plan, the same two-pixel mirrored halo, the same fold guards),
so the kernel's index rules can be held against autograd on the CPU.

``launch_counts`` counts the wrapper's kernel launches (one per forward
call, one per backward call), so a run can show that it went through
the kernel; :func:`reset_launch_counts` sets them to 0.

Under ``torch.cuda.graph`` capture, call the forward once on the capture
stream before capturing: the first call on a stream allocates that
stream's workspace.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import pde
from .losses import bce_elementwise, channel_axis

__all__ = [
    "FusedPhysicsSums",
    "TilePlan",
    "dice_bce_sums",
    "fused_physics_sums",
    "fused_physics_sums_reference",
    "fused_physics_sums_bwd_tiled",
    "fused_loss_components",
    "launch_counts",
    "reset_launch_counts",
    "shared_bytes",
    "tile_plan",
    "tiles",
]

launch_counts = {"physics_sums_fwd": 0, "physics_sums_bwd": 0}

# csrc/physics_sums.cu's kTileW and kMaxTileH; _library() checks them
_TILE_W = 64
_MAX_TILE_H = 32
_MAX_BLOCKS = 2**31 - 1
# a tile is as high as it can be while the grid still has this many blocks
# (one for nearly every one of the card's 132 SMs at the training shape)
_TILE_HS = (32, 16, 8)
_MIN_BLOCKS = 128
_LOG_CLAMP = -100.0
_BCE_GRAD_EPS = 1e-12


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class TilePlan(NamedTuple):
    tile_h: int
    tile_w: int
    n_ty: int  # tiles down an image
    n_tx: int  # tiles across it

    @property
    def per_image(self) -> int:
        return self.n_ty * self.n_tx


@functools.lru_cache(maxsize=None)
def tile_plan(b: int, h: int, w: int) -> TilePlan:
    """The kernels' tiles for a (b, h, w) batch: 64 pixels wide, and of the
    largest height of 32, 16, 8 that still gives 128 blocks (8 where none
    does).  Every block is one tile of one image."""
    n_tx = -(-w // _TILE_W)
    for tile_h in _TILE_HS:
        n_ty = -(-h // tile_h)
        if b * n_ty * n_tx >= _MIN_BLOCKS:
            break
    if b * n_ty * n_tx > _MAX_BLOCKS:
        raise ValueError(f"({b}, {h}, {w}) needs {b * n_ty * n_tx} tiles; a grid holds "
                         f"{_MAX_BLOCKS}")
    return TilePlan(tile_h, _TILE_W, n_ty, n_tx)


def tiles(h: int, w: int, tile_h: int, tile_w: int):
    """``(y0, x0, rows, cols)`` of every tile of an h x w image in the
    kernels' order (row-major): its first pixel and its pixels inside the
    image."""
    for y0 in range(0, h, tile_h):
        for x0 in range(0, w, tile_w):
            yield y0, x0, min(tile_h, h - y0), min(tile_w, w - x0)


def shared_bytes(tile_h: int, bwd: bool, tile_w: int = _TILE_W) -> int:
    """Shared memory of one block: u's tile with its halo (one pixel
    forward, two backward) in rows of ``4 + tile_w + 4`` floats, t's tile,
    and backward the three fields on the tile and a one-pixel ring."""
    pitch = 4 + tile_w + 4
    u_rows = tile_h + (4 if bwd else 2)
    fields = 3 * (tile_h + 2) * pitch if bwd else 0
    return 4 * (u_rows * pitch + tile_h * tile_w + fields)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("physics_sums")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.physics_sums_layout.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.physics_sums_layout.restype = None
    lib.physics_sums_shared_bytes.argtypes = [i, i]
    lib.physics_sums_shared_bytes.restype = i
    lib.physics_sums_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, d, d, d, i, p]
    lib.physics_sums_fwd.restype = i
    lib.physics_sums_bwd.argtypes = [p, p, p, p, p, p, i, i, i, i, d, d, d, i, p]
    lib.physics_sums_bwd.restype = i
    tile_w, max_tile_h = i(0), i(0)
    lib.physics_sums_layout(ctypes.byref(tile_w), ctypes.byref(max_tile_h))
    if (tile_w.value, max_tile_h.value) != (_TILE_W, _MAX_TILE_H):
        raise RuntimeError(f"csrc/physics_sums.cu tiles by ({tile_w.value}, {max_tile_h.value}), "
                           f"the wrapper by ({_TILE_W}, {_MAX_TILE_H})")
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


def _on_device(device: torch.device):
    """The runtime launches on the current device, which must own the
    stream: a context that makes ``device`` current unless it is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as the runtime's handle (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without making
    the Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# per (device, stream): the forward's ticket (16 bytes, zero; the kernel
# leaves it zero) followed by room for the tiles' partial sums.  Launches
# on one stream run one after another, so they can share it.
_workspaces: dict = {}
_TICKET_FLOATS = 4


def _workspace(device: torch.device, stream: int, n_partials: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < _TICKET_FLOATS + n_partials:
        ws = torch.zeros(_TICKET_FLOATS + max(n_partials, 6 * 1024), dtype=torch.float32,
                         device=device)
        _workspaces[key] = ws
    return ws


def _launch_fwd(u, t, m, D, a, eps, use_reaction) -> torch.Tensor:
    b, h, w = u.shape
    plan = tile_plan(b, h, w)
    device = u.device
    sums = u.new_empty((b, 6))
    with _on_device(device):
        stream = _stream(device)
        ticket = _workspace(device, stream, b * 6 * plan.per_image).data_ptr()
        err = _library().physics_sums_fwd(
            u.data_ptr(), t.data_ptr(), m.data_ptr(), ticket + 4 * _TICKET_FLOATS, ticket,
            sums.data_ptr(), b, h, w, plan.tile_h, D, a, eps, bool(use_reaction), stream,
        )
    if err != 0:
        raise RuntimeError(f"physics_sums_fwd launch failed: CUDA error {err}")
    launch_counts["physics_sums_fwd"] += 1
    return sums


def _launch_bwd(u, t, m, cot, D, a, eps, use_reaction, need_dt):
    b, h, w = u.shape
    plan = tile_plan(b, h, w)
    device = u.device
    du = torch.empty_like(u)
    dt = torch.empty_like(t) if need_dt else None
    with _on_device(device):
        err = _library().physics_sums_bwd(
            u.data_ptr(), t.data_ptr(), m.data_ptr(), cot.data_ptr(), du.data_ptr(),
            dt.data_ptr() if need_dt else None, b, h, w, plan.tile_h, D, a, eps,
            bool(use_reaction), _stream(device),
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


def dice_bce_sums(u, t, m) -> torch.Tensor:
    """Per-image ``[Σu·t, Σu, Σt, Σbce]`` (B, 4), masked by ``m`` (B, 1): the
    kernel's first four sums in plain PyTorch."""
    mm = m.reshape(-1, 1, 1)
    u = u * mm
    t = t * mm
    dims = (1, 2)
    return torch.stack([torch.sum(u * t, dims), torch.sum(u, dims), torch.sum(t, dims),
                        torch.sum(bce_elementwise(u, t), dims)], dim=1)


def fused_physics_sums_reference(u, t, m, D, a, eps, use_reaction=True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same ``(B, 6)`` sums,
    differentiated by autograd."""
    dice_bce = dice_bce_sums(u, t, m)
    u = u * m.reshape(-1, 1, 1)
    dims = (1, 2)
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
    return torch.cat([dice_bce, torch.stack([rd, pf], dim=1)], dim=1)


def _mirror(i: torch.Tensor, n: int) -> torch.Tensor:
    """One-pixel reflect pad, edge not repeated: -1 -> 1, n -> n - 2."""
    i = i.abs()
    return torch.where(i >= n, 2 * n - 2 - i, i)


def _bwd_tile(ub, tb, mb, cb, y0, x0, rows, cols, tile_h, tile_w, D, a, eps, use_reaction,
              need_dt):
    """du (and dt) on one tile of one image, from nothing but the tile's u
    with its two-pixel mirrored halo, its t, the image's mask value ``mb``
    and cotangents ``cb`` (6,): what one block of the backward kernel does."""
    h, w = ub.shape
    dev = ub.device
    arange = lambda lo, hi: torch.arange(lo, hi + 1, device=dev)  # inclusive
    # the halo tile: one step past the image is a mirrored pixel, further out nothing
    gy, gx = arange(max(-1, y0 - 2), min(h, y0 + tile_h + 1)), arange(max(-1, x0 - 2),
                                                                      min(w, x0 + tile_w + 1))
    ue = ub[_mirror(gy, h)][:, _mirror(gx, w)] * mb

    # r, gx, gy on the tile and a ring of one pixel, where that lies in the image
    fy, fx = arange(max(0, y0 - 1), min(h - 1, y0 + tile_h)), arange(max(0, x0 - 1),
                                                                     min(w - 1, x0 + tile_w))

    def halo(dy, dx):
        return ue[(fy + (dy - int(gy[0])))[:, None], (fx + (dx - int(gx[0])))[None, :]]

    uf = halo(0, 0)
    r = D * (halo(-1, 0) + halo(0, -1) - 4.0 * uf + halo(0, 1) + halo(1, 0))
    if use_reaction:
        r = r + uf * (1.0 - uf) * (uf - a)
    gxf, gyf = 0.5 * (halo(0, 1) - halo(0, -1)), 0.5 * (halo(1, 0) - halo(-1, 0))

    y, x = arange(y0, y0 + rows - 1)[:, None], arange(x0, x0 + cols - 1)[None, :]
    y, x = y.expand(rows, cols), x.expand(rows, cols)
    always = torch.ones((rows, cols), dtype=torch.bool, device=dev)

    def tap(field, dy, dx, guard=always):
        """``field`` at (y + dy, x + dx) where ``guard`` holds, else 0; a
        guarded tap must lie on the ring."""
        iy, ix = y + (dy - int(fy[0])), x + (dx - int(fx[0]))
        inside = (iy >= 0) & (iy < len(fy)) & (ix >= 0) & (ix < len(fx))
        if not bool((inside | ~guard).all()):
            raise AssertionError(f"a tap of tile ({y0}, {x0}) reads outside its ring")
        vals = field[iy.clamp(0, len(fy) - 1), ix.clamp(0, len(fx) - 1)]
        return torch.where(guard, vals, torch.zeros_like(vals))

    # the guards of csrc/physics_sums.cu's lap_adjoint, gx_adjoint, gy_adjoint
    down, fold_top = y + 1 <= h - 1, y == 1
    up, fold_bottom = y >= 1, y == h - 2
    right, fold_left = x + 1 <= w - 1, x == 1
    left, fold_right = x >= 1, x == w - 2
    lap_t = (-4.0 * tap(r, 0, 0)
             + tap(r, 1, 0, down) + tap(r, -1, 0, fold_top)
             + tap(r, -1, 0, up) + tap(r, 1, 0, fold_bottom)
             + tap(r, 0, 1, right) + tap(r, 0, -1, fold_left)
             + tap(r, 0, -1, left) + tap(r, 0, 1, fold_right))
    gx_t = (-0.5 * tap(gxf, 0, 1, right) - 0.5 * tap(gxf, 0, -1, fold_left)
            + 0.5 * tap(gxf, 0, -1, left) + 0.5 * tap(gxf, 0, 1, fold_right))
    gy_t = (-0.5 * tap(gyf, 1, 0, down) - 0.5 * tap(gyf, -1, 0, fold_top)
            + 0.5 * tap(gyf, -1, 0, up) + 0.5 * tap(gyf, 1, 0, fold_bottom))

    uc = tap(uf, 0, 0)
    tc = tb[y0:y0 + rows, x0:x0 + cols] * mb
    c_inter, c_su, c_st, c_bce, c_rd, c_pf = cb.unbind()
    g = c_inter * tc + c_su
    g = g + c_bce * (uc - tc) / torch.clamp_min(uc * (1.0 - uc), _BCE_GRAD_EPS)
    rd = D * lap_t
    if use_reaction:
        rd = rd + (-3.0 * uc * uc + 2.0 * (1.0 + a) * uc - a) * tap(r, 0, 0)
    g = g + c_rd * 2.0 * rd
    pf = eps * (gx_t + gy_t) + (2.0 / eps) * uc * (1.0 - uc) * (1.0 - 2.0 * uc)
    g = g + c_pf * pf
    du = g * mb
    if not need_dt:
        return du, None
    logs = (torch.clamp(torch.log1p(-uc), min=_LOG_CLAMP)
            - torch.clamp(torch.log(uc), min=_LOG_CLAMP))
    return du, (c_inter * uc + c_st + c_bce * logs) * mb


@torch.no_grad()
def fused_physics_sums_bwd_tiled(u, t, m, cot, D, a, eps, use_reaction=True, need_dt=True,
                                 tile_h: Optional[int] = None, tile_w: Optional[int] = None):
    """Plain PyTorch version of the backward kernel, tile by tile.

    ``(du, dt)`` (``dt`` None without ``need_dt``) of
    ``sum(cot * fused_physics_sums(u, t, m, ...))``, computed as the kernel
    computes it: every tile of :func:`tiles` on its own, from the tile's u
    with a two-pixel mirrored halo, through r, gx, gy on the tile and a
    one-pixel ring, with the kernel's fold guards.  A guarded tap that
    falls outside its ring raises.  ``tile_h``/``tile_w`` default to
    :func:`tile_plan`'s.
    """
    _check_inputs(u, t, m)
    b, h, w = u.shape
    plan = tile_plan(b, h, w)
    tile_h, tile_w = tile_h or plan.tile_h, tile_w or plan.tile_w
    cot = cot.to(torch.float32)
    du = torch.empty_like(u)
    dt = torch.empty_like(t) if need_dt else None
    for i in range(b):
        for y0, x0, rows, cols in tiles(h, w, tile_h, tile_w):
            gu, gt = _bwd_tile(u[i], t[i], m[i, 0], cot[i], y0, x0, rows, cols, tile_h, tile_w,
                               D, a, eps, use_reaction, need_dt)
            du[i, y0:y0 + rows, x0:x0 + cols] = gu
            if need_dt:
                dt[i, y0:y0 + rows, x0:x0 + cols] = gt
    return du, dt


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
    physics_sums=None,
) -> dict:
    """Loss components from the fused sums; the same contract as the plain
    component computation of :func:`..train.objective.make_loss_and_components`.

    Accepts (B, H, W), (B, H, W, 1) or (B, 1, H, W) predictions/targets
    (:func:`..ops.losses.channel_axis`); ``mask`` is a per-sample validity
    mask broadcastable to the prediction.

    ``reduce``: for a batch sharded over ranks, a differentiable sum over
    the ranks (:func:`..parallel.mesh.all_sum`), applied to the six totals
    and the valid-pixel count before the ratios are formed, so every rank
    gets the loss of the global batch.  ``plain`` takes the plain version
    on any device.  ``physics_sums(u, m)``: the per-image ``[Σr², Σpf]``
    (B, 2), masked by ``m``, from elsewhere (a band of a space-sharded
    field, whose stencils need the neighbouring bands' rows); the Dice and
    BCE sums are then :func:`dice_bce_sums`.
    """
    axis = channel_axis(pred)
    if axis is not None:
        pred, target = pred.squeeze(axis), target.squeeze(axis)
    b, h, w = pred.shape
    if mask is None:
        m = torch.ones((b, 1), dtype=torch.float32, device=pred.device)
    else:
        m = mask.to(torch.float32).reshape(b, -1)[:, :1].contiguous()

    u, t = pred.to(torch.float32).contiguous(), target.to(torch.float32).contiguous()
    if physics_sums is not None:
        physics = (physics_sums(u, m) if need_pde or need_phase_field
                   else u.new_zeros((b, 2)))
        sums = torch.cat([dice_bce_sums(u, t, m), physics], dim=1)
    elif plain:
        _check_inputs(u, t, m)
        sums = fused_physics_sums_reference(u, t, m, diffusion_coeff, reaction_threshold,
                                            epsilon, use_reaction_term)
    else:
        sums = fused_physics_sums(u, t, m, diffusion_coeff, reaction_threshold, epsilon,
                                  use_reaction_term)
    totals, n_valid = sums.sum(0), torch.sum(m) * (h * w)
    if reduce is not None:
        totals, n_valid = reduce(torch.cat([totals, n_valid.reshape(1)])).split((6, 1))
        n_valid = n_valid.reshape(())
    inter, su, st, bce, rd, pf = totals.unbind()
    dice = (2.0 * inter + smooth) / (su + st + smooth)
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    return {
        "dice_loss": 1.0 - dice,
        "bce_loss": bce / n_valid,
        "pde_loss": rd / n_valid if need_pde else zero,
        "phase_field_loss": pf / n_valid if need_phase_field else zero,
    }
