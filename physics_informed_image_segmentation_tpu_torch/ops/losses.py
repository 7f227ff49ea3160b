"""Segmentation loss functions (plain PyTorch).

Counterpart of ``physics_informed_image_segmentation_tpu/ops/losses.py``:

* soft Dice over the *whole flattened batch* (not per-sample), smooth=1e-6,
* BCE on probabilities (not logits) with the log clamped at -100 and
  torch's ``(p - t) / clamp_min(p (1 - p), 1e-12)`` backward,
* the combined Dice+BCE and Dice+BCE+λ_RD·PDE+λ_PF·phase-field objectives.

Every loss optionally takes a ``mask`` broadcastable to ``predictions``
with 1.0 marking valid elements; padded samples of a ragged final batch
are masked out and means are taken over the valid elements only.
Inputs are ``(B, H, W)``, ``(B, H, W, 1)`` or the reference's
``(B, 1, H, W)`` (:func:`channel_axis`).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import pde

__all__ = [
    "channel_axis",
    "soft_dice_loss",
    "bce_elementwise",
    "bce_loss",
    "dice_bce_loss",
    "dice_bce_pde_loss",
    "loss_components",
]

_SMOOTH = 1e-6
_LOG_CLAMP = -100.0
# torch's binary_cross_entropy_backward clamps p(1-p) at 1e-12, so
# saturated probabilities (p exactly 0 or 1 in f32) get a large but
# finite gradient where plain autograd through the clamped logs gives
# 0 * inf = NaN.
_BCE_GRAD_EPS = 1e-12


def channel_axis(x: torch.Tensor) -> Optional[int]:
    """The singleton channel axis of a field: 3 for ``(B, H, W, 1)``, 1 for
    the reference's ``(B, 1, H, W)`` (when W is not 1), None for
    ``(B, H, W)``.  Any other 4-D shape raises ``ValueError``: its stencil
    axes cannot be told apart."""
    if x.dim() != 4:
        return None
    if x.shape[-1] == 1:
        return 3
    if x.shape[1] == 1:
        return 1
    raise ValueError(
        f"expected (B, H, W), (B, H, W, 1) or (B, 1, H, W); got shape {tuple(x.shape)}"
    )


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return x if mask is None else x * mask


def _mask_count(predictions: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.tensor(float(predictions.numel()), device=predictions.device)
    return torch.sum(mask) * (predictions.numel() / mask.numel())


def soft_dice_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    smooth: float = _SMOOTH,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``1 - (2 Σp·t + s) / (Σp + Σt + s)`` over the flattened batch."""
    p = _masked(predictions, mask)
    t = _masked(targets, mask)
    intersection = torch.sum(p * t)
    dice = (2.0 * intersection + smooth) / (torch.sum(p) + torch.sum(t) + smooth)
    return 1.0 - dice


def _clamped_logs(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.clamp(torch.log(p), min=_LOG_CLAMP),
        torch.clamp(torch.log1p(-p), min=_LOG_CLAMP),
    )


class _BCE(torch.autograd.Function):
    """Elementwise BCE on probabilities with torch's clamped backward."""

    @staticmethod
    def forward(ctx, p, t):
        ctx.save_for_backward(p, t)
        log_p, log_1p = _clamped_logs(p)
        return -(t * log_p + (1.0 - t) * log_1p)

    @staticmethod
    def backward(ctx, g):
        p, t = ctx.saved_tensors
        dp = dt = None
        if ctx.needs_input_grad[0]:
            dp = g * ((p - t) / torch.clamp_min(p * (1.0 - p), _BCE_GRAD_EPS))
        if ctx.needs_input_grad[1]:
            log_p, log_1p = _clamped_logs(p)
            dt = g * (log_1p - log_p)
        return dp, dt


def bce_elementwise(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``-(t log p + (1-t) log(1-p))`` per element, logs clamped at -100,
    with the backward of ``torch.nn.BCELoss`` (finite on saturated p)."""
    return _BCE.apply(predictions, targets)


def bce_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Binary cross-entropy on probabilities, mean over valid elements."""
    elem = _masked(bce_elementwise(predictions, targets), mask)
    return torch.sum(elem) / _mask_count(predictions, mask)


def dice_bce_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    dice_weight: float = 0.5,
    bce_weight: float = 0.5,
    smooth: float = _SMOOTH,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Combined Dice + BCE."""
    return dice_weight * soft_dice_loss(predictions, targets, smooth, mask) + (
        bce_weight * bce_loss(predictions, targets, mask)
    )


def _physics_terms(
    predictions, mask, *, need_pde, need_phase_field, diffusion_coeff,
    reaction_threshold, epsilon, use_reaction_term,
):
    """(pde_loss, phase_field_loss) over valid elements; a disabled term is 0.

    The stencils act on (H, W): the channel axis of (B, H, W, 1) or
    (B, 1, H, W) is dropped first (the JAX package's plain path does not
    drop it and so differentiates along (W, C) of (B, H, W, 1); its Pallas
    path drops it).
    """
    axis = channel_axis(predictions)
    if axis is not None:
        predictions = predictions.squeeze(axis)
        if mask is not None and mask.dim() == 4:
            mask = mask.squeeze(axis)
    zero = torch.zeros((), dtype=predictions.dtype, device=predictions.device)
    u = _masked(predictions, mask)
    scale = 1.0 if mask is None else predictions.numel() / _mask_count(predictions, mask)
    pde_term = pf_term = zero
    if need_pde:
        if use_reaction_term:
            r = pde.pde_residual(u, diffusion_coeff, reaction_threshold)
        else:
            r = diffusion_coeff * pde.laplacian(u)
        r = _masked(r, mask)
        pde_term = torch.mean(r * r) * scale
    if need_phase_field:
        gms = _masked(pde.gradient_magnitude_sq(u), mask)
        one_minus = 1.0 - predictions
        dw = (u * u) * _masked(one_minus * one_minus, mask)
        pf_term = torch.mean((epsilon / 2.0) * gms + (1.0 / epsilon) * dw) * scale
    return pde_term, pf_term


def dice_bce_pde_loss(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    dice_weight: float = 0.5,
    bce_weight: float = 0.5,
    pde_weight: float = 1e-3,
    phase_field_weight: float = 0.0,
    smooth: float = _SMOOTH,
    diffusion_coeff: float = 1.0,
    reaction_threshold: float = 0.5,
    epsilon: float = 0.05,
    use_reaction_term: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dice + BCE + λ_RD·mean(r²) + λ_PF·phase-field.

    ``use_reaction_term=False`` gives the diffusion-only residual
    ``r = D ∇²u``.  The physics terms see only the prediction; masked
    samples are zeroed before the stencils.
    """
    total = dice_bce_loss(predictions, targets, dice_weight, bce_weight, smooth, mask)
    pde_term, pf_term = _physics_terms(
        predictions, mask,
        need_pde=pde_weight > 0, need_phase_field=phase_field_weight > 0,
        diffusion_coeff=diffusion_coeff, reaction_threshold=reaction_threshold,
        epsilon=epsilon, use_reaction_term=use_reaction_term,
    )
    if pde_weight > 0:
        total = total + pde_weight * pde_term
    if phase_field_weight > 0:
        total = total + phase_field_weight * pf_term
    return total


def loss_components(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    pde_weight: float = 0.0,
    phase_field_weight: float = 0.0,
    smooth: float = _SMOOTH,
    diffusion_coeff: float = 1.0,
    reaction_threshold: float = 0.5,
    epsilon: float = 0.05,
    use_reaction_term: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> dict:
    """Per-term breakdown (dice_loss / bce_loss / pde_loss /
    phase_field_loss); disabled terms are 0.0."""
    pde_term, pf_term = _physics_terms(
        predictions, mask,
        need_pde=pde_weight > 0, need_phase_field=phase_field_weight > 0,
        diffusion_coeff=diffusion_coeff, reaction_threshold=reaction_threshold,
        epsilon=epsilon, use_reaction_term=use_reaction_term,
    )
    return {
        "dice_loss": soft_dice_loss(predictions, targets, smooth, mask),
        "bce_loss": bce_loss(predictions, targets, mask),
        "pde_loss": pde_term,
        "phase_field_loss": pf_term,
    }
