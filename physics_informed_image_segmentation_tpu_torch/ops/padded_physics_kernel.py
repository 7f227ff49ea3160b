"""Physics sums over halo-padded blocks: the hand-written CUDA kernel and its
plain versions.

Counterpart of ``physics_informed_image_segmentation_tpu/ops/pallas_physics.py``
(``padded_physics_sums``).  A space-sharded field reaches this op as one
block per rank whose one-pixel ghost ring the halo exchange has filled
(:func:`..parallel.halo.halo_exchange_pad`); the op returns, per image,
``[Σr², Σphase-field]`` over the block's interior, and its backward
returns the gradient on the whole padded block, ghost ring included, for
the exchange to route back (``csrc/padded_physics.cu`` explains it).
Each direction is one launch over tiles of the interior, ``tile_h`` x 64
pixels (:func:`tile_plan`, K1's plan): the forward's last block adds the
tiles' partial sums in a fixed order, the backward computes its fields in
shared memory and needs no scratch.

Dispatch is by the device of the tensor, with no fallback:

* CUDA tensors go to the kernel (``PaddedPhysicsSums``), built on first
  use; a kernel that fails to build or launch raises;
* CPU tensors go to :func:`padded_physics_sums_reference`, plain PyTorch
  differentiated by autograd.

:func:`padded_physics_sums_bwd_tiled` is a second plain version, of the
backward alone: plain PyTorch that follows the kernel tile by tile (the
same plan, the same two-pixel halo, fields on a one-pixel ring, the same
guards), so the kernel's index rules can be held against autograd on the
CPU.

``launch_counts`` counts the wrapper's kernel launches (one per forward
call, one per backward call); :func:`reset_launch_counts` sets them to 0.

Under ``torch.cuda.graph`` capture, call the forward once on the capture
stream before capturing: the first call on a stream allocates that
stream's workspace.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

# K3 tiles the interior as K1 tiles an image, and launches as K1 does
from .physics_kernel import (
    _MAX_TILE_H, _TICKET_FLOATS, _TILE_W, _on_device, _stream, _workspace, tile_plan, tiles,
)

__all__ = [
    "PaddedPhysicsSums",
    "copy_bytes",
    "padded_physics_sums",
    "padded_physics_sums_reference",
    "padded_physics_sums_bwd_tiled",
    "launch_counts",
    "reset_launch_counts",
    "ring_positions",
    "shared_bytes",
    "tile_plan",
    "tiles",
]

launch_counts = {"padded_physics_fwd": 0, "padded_physics_bwd": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def shared_bytes(tile_h: int, bwd: bool) -> int:
    """Shared memory of one block: p's tile with its halo, one pixel
    forward in rows of 66 floats, two backward in rows of 70 (the halo
    and the column pairs that 8-byte copies need); backward also r, gx, gy
    on the tile and a one-pixel ring, rows of 66."""
    if not bwd:
        return 4 * (tile_h + 2) * 66
    return 4 * ((tile_h + 4) * 70 + 3 * (tile_h + 2) * 66)


def copy_bytes(p: torch.Tensor) -> int:
    """Bytes each copy of p into shared memory moves: 8 where the padded
    row (w + 2 floats) is even and p is 8-byte aligned, else 4."""
    return 8 if p.shape[-1] % 2 == 0 and p.data_ptr() % 8 == 0 else 4


def ring_positions(h: int, w: int, y0: int, x0: int, rows: int, cols: int) -> list:
    """The ghost-ring positions that the block of the tile ``(y0, x0, rows,
    cols)`` writes besides its tile, in interior coordinates (-1, h and w
    lie on the ring), in the kernel's order: the ring rows above and below
    the tile where it touches the top or the bottom (with the corners where
    it also touches a side), then the ring columns beside its rows."""
    left, right = x0 == 0, x0 + cols == w
    xs = range(-1 if left else x0, (w if right else x0 + cols - 1) + 1)
    out = []
    if y0 == 0:
        out += [(-1, x) for x in xs]
    if y0 + rows == h:
        out += [(h, x) for x in xs]
    if left:
        out += [(y, -1) for y in range(y0, y0 + rows)]
    if right:
        out += [(y, w) for y in range(y0, y0 + rows)]
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("padded_physics")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.padded_physics_layout.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.padded_physics_layout.restype = None
    lib.padded_physics_shared_bytes.argtypes = [i, i]
    lib.padded_physics_shared_bytes.restype = i
    lib.padded_physics_copy_bytes.argtypes = [p, i]
    lib.padded_physics_copy_bytes.restype = i
    lib.padded_physics_fwd.argtypes = [p, p, p, p, i, i, i, i, d, d, d, i, p]
    lib.padded_physics_fwd.restype = i
    lib.padded_physics_bwd.argtypes = [p, p, p, i, i, i, i, d, d, d, i, p]
    lib.padded_physics_bwd.restype = i
    tile_w, max_tile_h = i(0), i(0)
    lib.padded_physics_layout(ctypes.byref(tile_w), ctypes.byref(max_tile_h))
    if (tile_w.value, max_tile_h.value) != (_TILE_W, _MAX_TILE_H):
        raise RuntimeError(f"csrc/padded_physics.cu tiles by ({tile_w.value}, "
                           f"{max_tile_h.value}), the plan by ({_TILE_W}, {_MAX_TILE_H})")
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


def _launch_fwd(p, D, a, eps, use_reaction) -> torch.Tensor:
    b, hp, wp = p.shape
    plan = tile_plan(b, hp - 2, wp - 2)
    device = p.device
    sums = p.new_empty((b, 2))
    with _on_device(device):
        stream = _stream(device)
        # K1's workspace for this stream: launches on one stream run one after
        # another and each leaves the ticket at 0, and it grows to the larger need
        ticket = _workspace(device, stream, b * 2 * plan.per_image).data_ptr()
        err = _library().padded_physics_fwd(
            p.data_ptr(), ticket + 4 * _TICKET_FLOATS, ticket, sums.data_ptr(), b, hp - 2,
            wp - 2, plan.tile_h, D, a, eps, bool(use_reaction), stream,
        )
    if err != 0:
        raise RuntimeError(f"padded_physics_fwd launch failed: CUDA error {err}")
    launch_counts["padded_physics_fwd"] += 1
    return sums


def _launch_bwd(p, cot, D, a, eps, use_reaction) -> torch.Tensor:
    b, hp, wp = p.shape
    plan = tile_plan(b, hp - 2, wp - 2)
    device = p.device
    dp = torch.empty_like(p)
    with _on_device(device):
        err = _library().padded_physics_bwd(
            p.data_ptr(), cot.data_ptr(), dp.data_ptr(), b, hp - 2, wp - 2, plan.tile_h, D, a,
            eps, bool(use_reaction), _stream(device),
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


def _bwd_tile(pb, cb, y0, x0, rows, cols, tile_h, tile_w, D, a, eps, use_reaction):
    """What one block of the backward kernel writes, from nothing but the
    tile's p with a two-pixel halo (clipped to the block) and the image's
    cotangents ``cb`` (2,): dp on the tile's interior pixels (rows, cols)
    and, at :func:`ring_positions`, on the ghost ring it owns."""
    hp, wp = pb.shape
    h, w = hp - 2, wp - 2
    dev = pb.device
    r_lo, c_lo = max(0, y0 - 1), max(0, x0 - 1)  # padded coordinates of the halo tile
    halo = pb[r_lo:y0 + tile_h + 3, c_lo:x0 + tile_w + 3]

    def read(field, ys, xs, iy0, ix0, valid, what):
        """``field`` at rows ``ys - iy0`` and columns ``xs - ix0`` where
        ``valid`` holds, else 0; a read position must lie in ``field``."""
        iy, ix = ys - iy0, xs - ix0
        inside = (iy >= 0) & (iy < field.shape[0]) & (ix >= 0) & (ix < field.shape[1])
        if not bool((inside | ~valid).all()):
            raise AssertionError(f"a tap of tile ({y0}, {x0}) reads outside its {what}")
        vals = field[iy.clamp(0, field.shape[0] - 1), ix.clamp(0, field.shape[1] - 1)]
        return torch.where(valid, vals, torch.zeros_like(vals))

    def interior(ys, xs):
        return (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)

    # r, gx, gy on the tile and a ring of one pixel, 0 outside the interior
    fy = torch.arange(y0 - 1, y0 + tile_h + 1, device=dev)[:, None].expand(-1, tile_w + 2)
    fx = torch.arange(x0 - 1, x0 + tile_w + 1, device=dev)[None, :].expand(tile_h + 2, -1)
    inner = interior(fy, fx)

    def u(dy, dx):  # interior (y, x) is padded (y + 1, x + 1)
        return read(halo, fy + 1 + dy, fx + 1 + dx, r_lo, c_lo, inner, "halo")

    uc = u(0, 0)
    r = D * (u(-1, 0) + u(1, 0) + u(0, -1) + u(0, 1) - 4.0 * uc)
    if use_reaction:
        r = r + uc * (1.0 - uc) * (uc - a)
    r = torch.where(inner, r, torch.zeros_like(r))
    gxf, gyf = 0.5 * (u(0, 1) - u(0, -1)), 0.5 * (u(1, 0) - u(-1, 0))
    c_rd, c_pf = cb.unbind()

    def transposed(ys, xs, guarded):
        """D·2·c_rd·Lapᵀr + eps·c_pf·(Gxᵀgx + Gyᵀgy) at (ys, xs).  Unguarded,
        every tap is read (and must lie on the fields' ring); guarded, only
        the taps that lie in the interior."""
        def tap(field, dy, dx):
            ty, tx = ys + dy, xs + dx
            valid = interior(ty, tx) if guarded else torch.ones_like(ty, dtype=torch.bool)
            return read(field, ty, tx, y0 - 1, x0 - 1, valid, "ring")

        lap_t = -4.0 * tap(r, 0, 0) + tap(r, 1, 0) + tap(r, -1, 0) + tap(r, 0, 1) + tap(r, 0, -1)
        gx_t = 0.5 * tap(gxf, 0, -1) - 0.5 * tap(gxf, 0, 1)
        gy_t = 0.5 * tap(gyf, -1, 0) - 0.5 * tap(gyf, 1, 0)
        return c_rd * 2.0 * D * lap_t + c_pf * eps * (gx_t + gy_t)

    # the tile's interior pixels, unguarded, with the pointwise terms
    ys = torch.arange(y0, y0 + rows, device=dev)[:, None].expand(-1, cols)
    xs = torch.arange(x0, x0 + cols, device=dev)[None, :].expand(rows, -1)
    g = transposed(ys, xs, guarded=False)
    uu = read(halo, ys + 1, xs + 1, r_lo, c_lo, torch.ones_like(ys, dtype=torch.bool), "halo")
    if use_reaction:
        f_prime = -3.0 * uu * uu + 2.0 * (1.0 + a) * uu - a
        g = g + c_rd * 2.0 * f_prime * read(r, ys, xs, y0 - 1, x0 - 1,
                                            torch.ones_like(ys, dtype=torch.bool), "ring")
    g = g + c_pf * (2.0 / eps) * uu * (1.0 - uu) * (1.0 - 2.0 * uu)

    # the ghost ring it owns: no pointwise term, guarded taps
    ring = torch.tensor(ring_positions(h, w, y0, x0, rows, cols), dtype=torch.long,
                        device=dev).reshape(-1, 2)
    return g, ring, transposed(ring[:, 0], ring[:, 1], guarded=True)


@torch.no_grad()
def padded_physics_sums_bwd_tiled(p, cot, D, a, eps, use_reaction=True,
                                  tile_h: Optional[int] = None, tile_w: Optional[int] = None):
    """Plain PyTorch version of the backward kernel, tile by tile.

    ``dp`` (B, H+2, W+2) of ``sum(cot * padded_physics_sums(p, ...))``,
    computed as the kernel computes it: every tile of :func:`tiles` on its
    own, from the tile's p with a two-pixel halo, through r, gx, gy on the
    tile and a one-pixel ring (0 outside the interior); the tile's pixels
    read their taps unguarded, the ghost ring it owns
    (:func:`ring_positions`) behind guards.  A tap that falls outside its
    ring or halo raises, and a position that no tile writes stays NaN.
    ``tile_h``/``tile_w`` default to :func:`tile_plan`'s.
    """
    _check_input(p)
    b, hp, wp = p.shape
    h, w = hp - 2, wp - 2
    plan = tile_plan(b, h, w)
    tile_h, tile_w = tile_h or plan.tile_h, tile_w or plan.tile_w
    cot = cot.to(torch.float32)
    dp = torch.full_like(p, float("nan"))
    for i in range(b):
        for y0, x0, rows, cols in tiles(h, w, tile_h, tile_w):
            g, ring, g_ring = _bwd_tile(p[i], cot[i], y0, x0, rows, cols, tile_h, tile_w, D, a,
                                        eps, use_reaction)
            dp[i, y0 + 1:y0 + 1 + rows, x0 + 1:x0 + 1 + cols] = g
            dp[i, ring[:, 0] + 1, ring[:, 1] + 1] = g_ring
    return dp


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
