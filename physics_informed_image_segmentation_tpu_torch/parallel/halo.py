"""Explicit halo exchange for fields sharded over image height.

Counterpart of ``physics_informed_image_segmentation_tpu/parallel/halo.py``.
The PDE stencils and the U-Net's 3×3 convolutions are 3×3-local, so a
field sharded along H needs one row from each neighbouring band per
stencil.  :func:`halo_exchange_pad` sends this band's first and last rows
to the bands above and below (``batch_isend_irecv`` in the ``space``
group) and fills the ghost rows with what arrives; its backward is the
transpose: a ghost row's gradient goes back to the rank that sent the row
and is added to that rank's edge row.

Edges of the global field:

* ``edge="mirror"`` (the physics): the global top and bottom ghost rows
  mirror rows 1 and H-2, and the columns are mirrored too (W is not
  sharded) — the reflect padding of the unsharded stencils;
* ``edge="zero"`` (the convolutions, and Boundary-F1's metric halo of
  k rows): zero ghost rows at the global edges and no column padding, which
  the conv does itself (``padding=(0, 1)``).

The losses reduce their sums with ``all_reduce`` over the ``space`` group
(and ``data`` with ``batch_axis``) and divide by the global count.
Validated against the JAX package's unsharded ops in
``tests/test_torch_port_halo.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.padded_physics_kernel import padded_physics_sums, padded_physics_sums_reference
from .mesh import SPACE_AXIS, Mesh, all_sum

__all__ = [
    "halo_exchange_pad",
    "halo_physics_sums",
    "halo_residual_loss",
    "halo_phase_field_loss",
    "halo_physics_loss_pallas",
]

_EDGES = ("mirror", "zero")


def _exchange(to_prev: torch.Tensor, to_next: torch.Tensor, mesh: Mesh):
    """Send ``to_prev`` to the band above and ``to_next`` to the band
    below; returns ``(from_prev, from_next)``, None at a global edge."""
    prev, nxt = mesh.space_neighbours()
    to_prev, to_next = to_prev.contiguous(), to_next.contiguous()
    fresh = lambda like: torch.empty_like(like, memory_format=torch.contiguous_format)
    from_prev = fresh(to_next) if prev is not None else None
    from_next = fresh(to_prev) if nxt is not None else None
    ops = []
    if prev is not None:
        ops += [dist.P2POp(dist.isend, to_prev, prev, mesh.space_group),
                dist.P2POp(dist.irecv, from_prev, prev, mesh.space_group)]
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, to_next, nxt, mesh.space_group),
                dist.P2POp(dist.irecv, from_next, nxt, mesh.space_group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _HaloPad(torch.autograd.Function):
    """(..., H, W) band → (..., H+2, W+2) (mirror) or (..., H+2k, W) (zero,
    k rows a side)."""

    @staticmethod
    def forward(ctx, x, mesh, edge, k):
        ctx.mesh, ctx.edge, ctx.k = mesh, edge, k
        from_prev, from_next = _exchange(x[..., :k, :], x[..., -k:, :], mesh)
        if from_prev is None:
            from_prev = x[..., 1:2, :] if edge == "mirror" else torch.zeros_like(x[..., :k, :])
        if from_next is None:
            from_next = x[..., -2:-1, :] if edge == "mirror" else torch.zeros_like(x[..., :k, :])
        p = torch.cat([from_prev, x, from_next], dim=-2)
        if edge == "mirror":
            p = torch.cat([p[..., 1:2], p, p[..., -2:-1]], dim=-1)
        return p

    @staticmethod
    def backward(ctx, g):
        mesh, edge, k = ctx.mesh, ctx.edge, ctx.k
        if edge == "mirror":  # mirror columns add into columns 1 and W-2
            core = g[..., 1:-1].clone()
            core[..., 1] += g[..., 0]
            core[..., -2] += g[..., -1]
            g = core
        g_top, g_bot = g[..., :k, :], g[..., -k:, :]
        dx = g[..., k:-k, :].clone()
        # the top ghosts came from the band above: their gradient goes back
        # there and lands on that band's last rows (and the bottom likewise)
        from_prev, from_next = _exchange(g_top, g_bot, mesh)
        if from_prev is not None:
            dx[..., :k, :] += from_prev
        elif edge == "mirror":
            dx[..., 1, :] += g_top[..., 0, :]
        if from_next is not None:
            dx[..., -k:, :] += from_next
        elif edge == "mirror":
            dx[..., -2, :] += g_bot[..., 0, :]
        return dx, None, None, None


def halo_exchange_pad(u_local: torch.Tensor, mesh: Mesh, edge: str = "mirror",
                      rows: int = 1) -> torch.Tensor:
    """This rank's (..., H_loc, W) band with its ghost rows filled from the
    neighbouring bands; differentiable (see the module docstring).

    ``edge="mirror"`` → (..., H_loc+2, W+2) with mirrored global edges and
    columns; ``edge="zero"`` → (..., H_loc+2·rows, W) with ``rows`` ghost
    rows a side, zero at the global edges (a band must have at least
    ``rows`` rows; the mirror takes one).
    """
    if edge not in _EDGES:
        raise ValueError(f"edge must be one of {_EDGES}; got {edge!r}")
    if u_local.dim() < 2:
        raise ValueError(f"need (..., H, W); got {tuple(u_local.shape)}")
    if edge == "mirror" and rows != 1:
        raise ValueError(f"the mirror edge exchanges one row; got rows={rows}")
    if rows < 1 or u_local.shape[-2] < rows:
        raise ValueError(f"a band of {u_local.shape[-2]} rows cannot give a halo of {rows} "
                         "rows")
    if edge == "mirror" and min(u_local.shape[-2:]) < 2:
        raise ValueError(f"mirror padding needs H_loc, W >= 2; got {tuple(u_local.shape)}")
    return _HaloPad.apply(u_local, mesh, edge, rows)


def halo_physics_sums(u, mesh, D, a, eps, use_reaction, sums_fn, valid=None):
    """Per-image ``[Σr², Σphase-field]`` (B, 2) over this rank's band of the
    global field: the ghost ring filled by the exchange, the block's sums
    by ``sums_fn`` (K3 or its plain version), each image's times its
    ``valid`` (B,) when given.  ``u`` is the (B, H_loc, W) band.

    The sums of a field's bands add up to the field's; dividing them by
    ``Σvalid · H · W`` of the global batch gives the masked means of the
    unsharded objective (padded samples count neither in the sums nor in
    the count).
    """
    p = halo_exchange_pad(u.to(torch.float32).contiguous(), mesh, "mirror")
    sums = sums_fn(p, D, a, eps, use_reaction)
    return sums if valid is None else sums * valid.to(sums.dtype).reshape(-1, 1)


def physics_means(u, mesh, D, a, eps, use_reaction, batch_axis, sums_fn):
    """(mean r², mean phase-field) over the global field of which ``u`` is
    this rank's (B, H_loc, W) band."""
    sums = halo_physics_sums(u, mesh, D, a, eps, use_reaction, sums_fn)
    axes = (SPACE_AXIS,) if batch_axis is None else (batch_axis, SPACE_AXIS)
    count = torch.tensor([float(u.numel())], dtype=torch.float32, device=u.device)
    total = all_sum(torch.cat([sums.sum(0), count]), mesh, axes)
    return total[0] / total[2], total[1] / total[2]


def halo_residual_loss(
    u: torch.Tensor,
    mesh: Mesh,
    diffusion_coeff: float = 1.0,
    reaction_threshold: float = 0.5,
) -> torch.Tensor:
    """``mean(r²)`` of the reaction-diffusion residual on an H-sharded
    (B, H, W) field; ``u`` is this rank's (B, H_loc, W) band.

    Equal to :func:`..ops.pde.pde_residual_loss` on the gathered field;
    communication = one two-way one-row exchange and one scalar all-reduce.
    """
    rd, _ = physics_means(u, mesh, diffusion_coeff, reaction_threshold, 0.05, True, None,
                          padded_physics_sums_reference)
    return rd


def halo_phase_field_loss(u: torch.Tensor, mesh: Mesh, epsilon: float = 0.05) -> torch.Tensor:
    """Phase-field energy on an H-sharded field (see halo_residual_loss)."""
    _, pf = physics_means(u, mesh, 1.0, 0.5, epsilon, True, None, padded_physics_sums_reference)
    return pf


def halo_physics_loss_pallas(
    u: torch.Tensor,
    mesh: Mesh,
    diffusion_coeff: float = 1.0,
    reaction_threshold: float = 0.5,
    epsilon: float = 0.05,
    use_reaction_term: bool = True,
    batch_axis: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both physics losses on an H-sharded field with the fused padded-block
    op doing the local work: the halo exchange fills the ghost ring, the
    CUDA kernel K3 (:mod:`..ops.padded_physics_kernel`; its plain version
    on CPU tensors) computes both energies and their gradient on the
    padded block, and one all-reduce adds the sums.

    ``u`` is this rank's (B, H_loc, W) band.  ``batch_axis``: when the
    batch is sharded too (the data×space train step), name that axis so
    the means are over the global batch.  Returns ``(mean r², mean pf)``.
    """
    return physics_means(u, mesh, diffusion_coeff, reaction_threshold, epsilon,
                         use_reaction_term, batch_axis, padded_physics_sums)
