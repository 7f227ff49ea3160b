"""Differentiable PDE stencil operators (plain PyTorch).

Counterpart of ``physics_informed_image_segmentation_tpu/ops/pde.py``:

* 5-point Laplacian with Neumann (mirror/reflect) boundary conditions,
* central-difference spatial gradients,
* bistable reaction term ``f(u) = u (1 - u) (u - a)``,
* steady-state reaction-diffusion residual ``r = D ∇²u + f(u)``,
* phase-field (Modica-Mortola) interface energy
  ``(eps/2) |∇u|² + (1/eps) u² (1-u)²``.

Every stencil is a sum of shifted slices of the reflect-padded field and
acts on the last two axes, so ``(H, W)``, ``(B, H, W)`` and
``(B, H, W, 1)``-squeezed layouts all work.  Autograd differentiates
these functions; they are also the plain version that the fused CUDA
kernel (:mod:`.physics_kernel`) is checked against.
"""

from __future__ import annotations

import torch

__all__ = [
    "reflect_pad",
    "laplacian",
    "grad_xy",
    "gradient_magnitude_sq",
    "reaction_term",
    "pde_residual",
    "pde_residual_loss",
    "phase_field_loss",
    "validate_pde_params",
]


def validate_pde_params(diffusion_coeff: float, reaction_threshold: float) -> None:
    """Raise on a non-positive D or a threshold outside (0, 1)."""
    if diffusion_coeff <= 0:
        raise ValueError("diffusion_coeff must be positive")
    if not (0 < reaction_threshold < 1):
        raise ValueError("reaction_threshold must be in (0,1)")


def reflect_pad(u: torch.Tensor) -> torch.Tensor:
    """Mirror-pad the last two axes by one pixel (edge not repeated):
    ``[a, b, c] -> [b, a, b, c, b]``, as ``F.pad(mode='reflect')``."""
    u = torch.cat([u[..., 1:2, :], u, u[..., -2:-1, :]], dim=-2)
    return torch.cat([u[..., :, 1:2], u, u[..., :, -2:-1]], dim=-1)


def laplacian(u: torch.Tensor) -> torch.Tensor:
    """``u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1] - 4 u[i,j]``, mirrored."""
    p = reflect_pad(u)
    up = p[..., :-2, 1:-1]
    down = p[..., 2:, 1:-1]
    left = p[..., 1:-1, :-2]
    right = p[..., 1:-1, 2:]
    return up + down + left + right - 4.0 * u


def grad_xy(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences ``gx = (u[i,j+1]-u[i,j-1])/2``,
    ``gy = (u[i+1,j]-u[i-1,j])/2`` with reflect BCs (both exactly zero
    on their boundary rows/columns)."""
    p = reflect_pad(u)
    gx = 0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
    gy = 0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])
    return gx, gy


def gradient_magnitude_sq(u: torch.Tensor) -> torch.Tensor:
    """``|∇u|² = gx² + gy²``."""
    gx, gy = grad_xy(u)
    return gx * gx + gy * gy


def reaction_term(u: torch.Tensor, reaction_threshold: float = 0.5) -> torch.Tensor:
    """Bistable reaction ``f(u) = u (1-u) (u-a)``."""
    return u * (1.0 - u) * (u - reaction_threshold)


def pde_residual(
    u: torch.Tensor, diffusion_coeff: float = 1.0, reaction_threshold: float = 0.5
) -> torch.Tensor:
    """Steady-state RD residual ``r = D ∇²u + f(u)``."""
    return diffusion_coeff * laplacian(u) + reaction_term(u, reaction_threshold)


def pde_residual_loss(
    u: torch.Tensor, diffusion_coeff: float = 1.0, reaction_threshold: float = 0.5
) -> torch.Tensor:
    """L2 residual penalty ``mean(r²)``."""
    r = pde_residual(u, diffusion_coeff, reaction_threshold)
    return torch.mean(r * r)


def phase_field_loss(u: torch.Tensor, epsilon: float = 0.05) -> torch.Tensor:
    """``mean((eps/2) |∇u|² + (1/eps) u² (1-u)²)``."""
    gms = gradient_magnitude_sq(u)
    one_minus = 1.0 - u
    double_well = (1.0 / epsilon) * (u * u) * (one_minus * one_minus)
    return torch.mean((epsilon / 2.0) * gms + double_well)
